"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import pytest

import mops_jax as mt
from mops_jax.parallel import device_mesh, run_advection_sharded


def _cfg(**kw):
    base = dict(delta_t=600, simulation_duration=600 * 10, record_t=1200,
                depth=200.0, fail_mode=mt.FailMode.ZERO)
    base.update(kw)
    return mt.TrajectorySettings(**base)


def test_eight_virtual_devices_present():
    assert len(jax.devices()) == 8


def test_sharded_matches_single_device(mesh, sol, seeds, cells):
    cfg = _cfg()
    raw_single = mt.run_advection(mesh, sol, seeds, cells, cfg)
    dmesh = device_mesh(8)
    raw_sharded = run_advection_sharded(mesh, sol, seeds, cells, cfg,
                                        dmesh=dmesh)
    np.testing.assert_allclose(np.asarray(raw_sharded.final_position),
                               np.asarray(raw_single.final_position),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(raw_sharded.points),
                               np.asarray(raw_single.points),
                               rtol=0, atol=1e-6)


def test_sharded_pads_odd_particle_counts(mesh, sol, seeds, cells):
    cfg = _cfg(simulation_duration=600 * 4)
    # 12 seeds over 8 devices -> pads to 16, slices back to 12
    dmesh = device_mesh(8)
    raw = run_advection_sharded(mesh, sol, seeds, cells, cfg, dmesh=dmesh)
    assert raw.final_position.shape[0] == len(seeds)


def test_graft_entry_compiles():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert np.isfinite(np.asarray(out)).all()


def test_graft_dryrun_multichip():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_api_devices_option(mesh, raw_fields):
    """MOPSApp.run_streamline(devices=8) routes through the sharded engine
    and matches the single-device result (VERDICT round-2 item 6)."""
    from mops_jax import api
    a = api.MOPSApp()
    a.init("cpu", precision="fp64")
    a.begin()
    a.add_grid(mesh)
    a.add_solution(1, dict(raw_fields), timestamp="t1", timestep=0)
    a.end()
    a.active_attribute(1)
    seeds = a.generate_sample_points(mt.SamplingSettings(
        sample_range=(4, 4), lat_range=(-30, 30), lon_range=(-60, 60),
        depth=100.0))
    cfg = _cfg(simulation_duration=600 * 6)
    lines1 = a.run_streamline(cfg, seeds.copy())
    lines8 = a.run_streamline(cfg, seeds.copy(), devices=8)
    assert len(lines1) == len(lines8)
    for l1, l8 in zip(lines1, lines8):
        np.testing.assert_allclose(l8.points, l1.points, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", [
    "streamline-f32", "pathline-f64", "pathline-f32-attrs", "odd-n",
    "small-n"])
def test_sharded_cases_match_single_device(mesh, sol, sol_back, seeds, cells,
                                           case):
    """The sharded engine against the one-device engine: float32 and
    float64, pathline with attributes, an odd particle count over 8
    devices, and fewer particles than devices (padding)."""
    import jax.numpy as jnp
    dtype = jnp.float32 if "f32" in case else jnp.float64
    back = sol_back if case.startswith("pathline") else None
    front = sol
    if case == "pathline-f64":
        front = mt.preprocess(mesh, {
            k: v for k, v in _raw(mesh).items()
            if k not in ("temperature", "salinity")})
        back = front
    n = {"odd-n": 5, "small-n": 3}.get(case, len(seeds))
    cfg = _cfg(simulation_duration=600 * 4)
    s_in = np.asarray(seeds[:n], dtype=dtype)
    raw_single = mt.run_advection(mesh, front, s_in, cells[:n], cfg,
                                  back=back, dtype=dtype)
    raw_sharded = run_advection_sharded(mesh, front, s_in, cells[:n], cfg,
                                        dmesh=device_mesh(8), back=back,
                                        dtype=dtype)
    assert raw_sharded.final_position.shape == (n, 3)
    np.testing.assert_allclose(np.asarray(raw_sharded.points),
                               np.asarray(raw_single.points),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(raw_sharded.alive),
                                  np.asarray(raw_single.alive))
    if case == "pathline-f32-attrs":
        assert raw_sharded.attrs is not None
        # float32 attributes (values ~30) to a few ulps
        np.testing.assert_allclose(np.asarray(raw_sharded.attrs),
                                   np.asarray(raw_single.attrs),
                                   rtol=1e-5, atol=1e-6)


def _raw(mesh):
    return mt.synth.solid_body_fields(mesh, n_layers=6, w_scale=1e-4)
