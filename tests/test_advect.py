"""Golden tests: JAX advection vs the scalar TBB-semantics oracle, plus
analytic solid-body-rotation truth."""

import numpy as np
import pytest

import mops_jax as mt
from mops_jax.oracle import oracle_pathline, oracle_streamline

TOL = dict(rtol=0, atol=5e-6)   # metres; fp64 summation-order noise only


def _settings(**kw):
    base = dict(delta_t=600, simulation_duration=600 * 24, record_t=1200,
                depth=500.0)
    base.update(kw)
    return mt.TrajectorySettings(**base)


def test_streamline_rk4_matches_oracle(mesh, sol, seeds, cells):
    cfg = _settings()
    raw = mt.run_advection(mesh, sol, seeds, cells, cfg)
    pts_o, vels_o, stable_o, depths_o = oracle_streamline(mesh, sol, seeds, cells, cfg)
    np.testing.assert_allclose(np.asarray(raw.points), pts_o, **TOL)
    np.testing.assert_allclose(np.asarray(raw.velocities), vels_o, atol=1e-10)
    np.testing.assert_allclose(np.asarray(raw.final_position), stable_o, **TOL)
    np.testing.assert_allclose(np.asarray(raw.final_depth), depths_o, atol=1e-4)


def test_streamline_euler_matches_oracle(mesh, sol, seeds, cells):
    cfg = _settings(method=mt.CalcMethod.EULER)
    raw = mt.run_advection(mesh, sol, seeds, cells, cfg)
    pts_o, vels_o, stable_o, _ = oracle_streamline(mesh, sol, seeds, cells, cfg)
    np.testing.assert_allclose(np.asarray(raw.points), pts_o, **TOL)
    np.testing.assert_allclose(np.asarray(raw.final_position), stable_o, **TOL)


def test_streamline_backward_matches_oracle(mesh, sol, seeds, cells):
    cfg = _settings(direction=mt.CalcDirection.BACKWARD,
                    simulation_duration=600 * 14)
    raw = mt.run_advection(mesh, sol, seeds, cells, cfg)
    pts_o, _, stable_o, _ = oracle_streamline(mesh, sol, seeds, cells, cfg)
    np.testing.assert_allclose(np.asarray(raw.points), pts_o, **TOL)
    np.testing.assert_allclose(np.asarray(raw.final_position), stable_o, **TOL)


def test_pathline_rk4_matches_oracle(mesh, sol, sol_back, seeds, cells):
    cfg = _settings(simulation_duration=600 * 14)
    raw = mt.run_advection(mesh, sol, seeds, cells, cfg, back=sol_back)
    pts_o, vels_o, attrs_o, stable_o, _ = oracle_pathline(
        mesh, sol, sol_back, seeds, cells, cfg,
        attrs_f=_stacked(sol), attrs_b=_stacked(sol_back))
    # pathline does 2x the float work per stage (front+back columns); the
    # einsum-vs-scalar-loop summation-order noise compounds to ~1e-3 m over
    # 30 steps (relative ~1e-9 at Earth radius)
    np.testing.assert_allclose(np.asarray(raw.points), pts_o, rtol=0, atol=5e-3)
    np.testing.assert_allclose(np.asarray(raw.final_position), stable_o,
                               rtol=0, atol=5e-3)
    np.testing.assert_allclose(np.asarray(raw.attrs), attrs_o, atol=1e-8)


def _stacked(sol):
    names = sorted(sol.vertex_attrs)
    if not names:
        return None
    return np.stack([np.asarray(sol.vertex_attrs[k]) for k in names], axis=-1)


def test_solid_body_rotation_analytic(mesh, sol):
    """A particle in a solid-body zonal flow stays at its latitude and moves
    east at omega_layer; verify against the closed form within RK4 error."""
    lat0, lon0 = np.deg2rad(20.0), np.deg2rad(40.0)
    seed = np.asarray(mt.geo.latlon_rad_to_xyz(lat0, lon0)).reshape(1, 3)
    cell = mt.CellSearch(mesh).query(seed)
    # depth 100 m -> layer 1 (layers are ~666 m thick); omega_eff = 1e-5 * 0.5
    cfg = mt.TrajectorySettings(delta_t=60, simulation_duration=3600 * 6,
                                record_t=3600, depth=100.0,
                                fail_mode=mt.FailMode.ZERO)
    raw = mt.run_advection(mesh, sol, seed, cell, cfg)
    final = np.asarray(raw.final_position)[0]
    lat1, lon1 = mt.geo.xyz_to_latlon_rad(final)
    # depth 100 m sits inside layer 1 (z0 = 0, z1 = -4000/6); the engine
    # lerps between the layer-0 and layer-1 velocities with
    # t = (z1 - (-depth)) ... => omega_eff = t*omega0 + (1-t)*omega1
    z1 = -4000.0 / 6.0
    t = (-100.0 - z1) / (0.0 - z1)
    omega_eff = 1e-5 * (t * 1.0 + (1.0 - t) * 0.5)
    # interpolation over a coarse 500-cell mesh perturbs the field; allow 5%
    np.testing.assert_allclose(float(lat1), lat0, atol=0.02)
    dlon = (float(lon1) - lon0) % (2 * np.pi)
    np.testing.assert_allclose(dlon, omega_eff * 3600 * 6, rtol=0.05)


def test_freeze_mode_stops_at_stage_exit(mesh, sol, seeds, cells):
    """FREEZE (TBB) particles die when an RK stage leaves the frozen cell;
    ZERO (SYCL) particles keep integrating."""
    cfg = _settings(simulation_duration=600 * 60)
    raw_f = mt.run_advection(mesh, sol, seeds, cells, cfg)
    cfg_z = _settings(simulation_duration=600 * 60,
                      fail_mode=mt.FailMode.ZERO)
    raw_z = mt.run_advection(mesh, sol, seeds, cells, cfg_z)
    alive_f = np.asarray(raw_f.alive).sum()
    final_z = np.asarray(raw_z.final_position)
    # ZERO mode keeps everything finite and moving
    assert np.isfinite(final_z).all()
    moved = np.linalg.norm(final_z - seeds, axis=1)
    assert (moved > 1e3).all()
    assert alive_f <= len(seeds)


def test_dead_particles_record_zeros(mesh, sol):
    """A particle seeded with an invalid start cell freezes immediately and
    its record slots stay zero (TBB zero-initialized buffers)."""
    seed = np.asarray(mt.geo.latlon_rad_to_xyz(0.3, 0.3)).reshape(1, 3)
    cfg = _settings(simulation_duration=600 * 5)
    raw = mt.run_advection(mesh, sol, seed, np.array([-1]), cfg)
    assert not bool(np.asarray(raw.alive)[0])
    np.testing.assert_array_equal(np.asarray(raw.points)[0], 0.0)


def test_per_particle_depths(mesh, sol, seeds, cells):
    depths = np.linspace(100, 3000, len(seeds)).astype(np.float32)
    cfg = _settings(particle_depths=depths, simulation_duration=600 * 10)
    raw = mt.run_advection(mesh, sol, seeds, cells, cfg)
    pts_o, _, _, depths_o = oracle_streamline(mesh, sol, seeds, cells, cfg)
    np.testing.assert_allclose(np.asarray(raw.points), pts_o, **TOL)
    np.testing.assert_allclose(np.asarray(raw.final_depth), depths_o, atol=1e-4)


def test_record_schedule_reference_quirks():
    # dt=120, recordT=60: records EVERY step but buffer has 2x slots;
    # trailing half stays zero (reference run_time % recordT == 0 semantics).
    cfg = mt.TrajectorySettings(delta_t=120, simulation_duration=1200,
                                record_t=60)
    flags, slots = mt.advect.record_schedule(cfg, pathline=False)
    assert flags.all() and cfg.n_records == 20 and len(flags) == 10
    # pathline integer-division interval: recordT//deltaT == 0 -> never record
    flags_p, _ = mt.advect.record_schedule(cfg, pathline=True)
    assert not flags_p.any()


def test_fp32_mode_runs_and_tracks_fp64(mesh, sol, seeds, cells):
    cfg = _settings(simulation_duration=600 * 10, fail_mode=mt.FailMode.ZERO)
    mesh32 = mesh.astype(np.float32)
    import dataclasses
    import jax.numpy as jnp

    def cast(s):
        return dataclasses.replace(
            s,
            cell_ztop=s.cell_ztop.astype(jnp.float32),
            vertex_ztop=s.vertex_ztop.astype(jnp.float32),
            cell_velocity=s.cell_velocity.astype(jnp.float32),
            vertex_velocity=s.vertex_velocity.astype(jnp.float32),
            vertex_vert_velocity=s.vertex_vert_velocity.astype(jnp.float32),
            vertex_attrs={k: v.astype(jnp.float32) for k, v in s.vertex_attrs.items()},
            cell_attrs={k: v.astype(jnp.float32) for k, v in s.cell_attrs.items()},
        )

    raw32 = mt.run_advection(mesh32, cast(sol), seeds.astype(np.float32),
                             cells, cfg, dtype=jnp.float32)
    raw64 = mt.run_advection(mesh, sol, seeds, cells, cfg)
    f32 = np.asarray(raw32.final_position, dtype=np.float64)
    f64 = np.asarray(raw64.final_position)
    # fp32 positions at Earth radius have ~0.5 m ulp; 10 RK4 steps stay within
    # tens of metres of the fp64 path
    assert np.nanmax(np.linalg.norm(f32 - f64, axis=1)) < 200.0


def _f32(mesh, raw_fields, drop_attrs=False, scale=1.0):
    """float32 mesh and preprocessed solution (velocities scaled)."""
    mesh32 = mesh.astype(np.float32)
    raw = {k: np.asarray(v, np.float32)
           * (scale if k.startswith("velocity") else 1.0)
           for k, v in raw_fields.items()
           if not (drop_attrs and k in ("temperature", "salinity"))}
    return mesh32, mt.preprocess(mesh32, raw)


@pytest.mark.parametrize("scenario", [
    "streamline-rk4", "streamline-euler", "pathline-rk4", "pathline-euler",
    "pathline-attrs"])
def test_xla_step_f32_tracks_f64(mesh, raw_fields, seeds, cells, scenario):
    """The float32 XLA step (the GPU's main path) against the float64 step
    on the same lanes: positions within tens of metres after 6 steps,
    identical alive masks, attributes to f32 precision."""
    import jax.numpy as jnp
    kind, variant = scenario.split("-")
    method = mt.CalcMethod.EULER if variant == "euler" else mt.CalcMethod.RK4
    cfg = _settings(simulation_duration=600 * 6, method=method,
                    fail_mode=mt.FailMode.ZERO)
    drop = variant != "attrs"
    mesh32, front32 = _f32(mesh, raw_fields, drop_attrs=drop)
    front64 = mt.preprocess(mesh, {k: v for k, v in raw_fields.items()
                                   if not (drop and k in ("temperature",
                                                          "salinity"))})
    back32 = back64 = None
    if kind == "pathline":
        _, back32 = _f32(mesh, raw_fields, drop_attrs=drop, scale=1.2)
        back64 = mt.preprocess(mesh, {
            k: np.asarray(v) * (1.2 if k.startswith("velocity") else 1.0)
            for k, v in raw_fields.items()
            if not (drop and k in ("temperature", "salinity"))})
    r32 = mt.run_advection(mesh32, front32, seeds.astype(np.float32), cells,
                           cfg, back=back32, dtype=jnp.float32)
    r64 = mt.run_advection(mesh, front64, seeds, cells, cfg, back=back64)
    p32 = np.asarray(r32.points, np.float64)
    p64 = np.asarray(r64.points)
    mask = np.isfinite(p64)
    np.testing.assert_array_equal(np.isfinite(p32), mask)
    np.testing.assert_allclose(p32[mask], p64[mask], rtol=0, atol=50.0)
    np.testing.assert_array_equal(np.asarray(r32.alive), np.asarray(r64.alive))
    if variant == "attrs":
        assert r32.attrs is not None
        np.testing.assert_allclose(np.asarray(r32.attrs, np.float64),
                                   np.asarray(r64.attrs), rtol=1e-4,
                                   atol=1e-3)


def test_crossing_regime_f32_tracks_f64():
    """Layer-crossing regime (strong vertical velocity over O(1)
    bathymetry gradients, depths into the deep column): the float32 step
    still agrees with float64 on the lane gate after 20 steps."""
    import jax.numpy as jnp
    from mops_jax.gate import lane_gate
    L = 12
    mesh = mt.synth.build_voronoi_mesh(600, n_layers=L, jitter=0.05, seed=4)
    raw = mt.synth.solid_body_fields(mesh, n_layers=L, w_scale=1e-3,
                                     omega_decay=1.0, bathymetry_amp=0.5,
                                     shelf_lon=0.3)
    rng = np.random.default_rng(2)
    v = rng.normal(size=(200, 3))
    seeds = v / np.linalg.norm(v, axis=1, keepdims=True) * mt.EARTH_RADIUS
    cells = mt.CellSearch(mesh).query(seeds)
    cfg = mt.TrajectorySettings(
        delta_t=600, simulation_duration=600 * 20, record_t=600 * 20,
        particle_depths=mt.seeding.linear_depth_profile(200, 10, 2500),
        fail_mode=mt.FailMode.ZERO)
    mesh32, sol32 = _f32(mesh, raw)
    r32 = mt.run_advection(mesh32, sol32, seeds.astype(np.float32), cells,
                           cfg, dtype=jnp.float32)
    sol64 = mt.preprocess(mesh, raw)
    r64 = mt.run_advection(mesh, sol64, seeds, cells, cfg)
    # particles end over columns whose depth differs from their start
    # column's by more than one layer's thickness
    bottom = np.asarray(sol64.cell_ztop)[:, -1]
    moved = np.abs(bottom[np.asarray(r64.final_cell)] - bottom[cells])
    assert moved.max() > 4000.0 / L
    gate = lane_gate(np.asarray(r32.final_position),
                     np.asarray(r64.final_position), seeds)
    assert gate["ok"], gate


def test_reference_scale_shapes_L80():
    """Reference vertical extent (80 layers, maxEdges >= 7, a land-masked
    region) at a tiny cell count: the float32 step against float64, and
    float64 against the oracle."""
    import jax.numpy as jnp
    L = 80
    mesh = mt.synth.build_voronoi_mesh(300, n_layers=L, jitter=0.05, seed=3,
                                       land_box=(10.0, 40.0, -60.0, -20.0))
    raw = mt.synth.solid_body_fields(mesh, n_layers=L, w_scale=1e-4)
    assert int(np.asarray(mesh.vertices_on_cell).shape[1]) >= 7
    rng = np.random.default_rng(1)
    v = rng.normal(size=(8, 3))
    seeds = v / np.linalg.norm(v, axis=1, keepdims=True) * mt.EARTH_RADIUS
    cells = mt.CellSearch(mesh).query(seeds)
    cfg = _settings(simulation_duration=600 * 4, depth=300.0)
    sol64 = mt.preprocess(mesh, raw)
    r64 = mt.run_advection(mesh, sol64, seeds, cells, cfg)
    pts_o, _, _, _ = oracle_streamline(mesh, sol64, seeds, cells, cfg)
    np.testing.assert_allclose(np.asarray(r64.points), pts_o, **TOL)
    mesh32, sol32 = _f32(mesh, raw)
    r32 = mt.run_advection(mesh32, sol32, seeds.astype(np.float32), cells,
                           cfg, dtype=jnp.float32)
    np.testing.assert_allclose(np.asarray(r32.points, np.float64),
                               np.asarray(r64.points), rtol=0, atol=50.0)


def test_f32_config1_day_drift_bound(mesh, raw_fields):
    """Quantify the f32 path's drift over the full
    BASELINE config-1 day (720 RK4 steps, dt=120 s) against the fp64 path
    the golden suite validates.  The benched f32 mode ships with this error
    bar (measured on the CPU): median drift ~0.7 m, max ~1.1 m after one
    simulated day of a ~600 km path, with each position's rounding residual
    carried (without it the median was ~12 m).  A discrete-branch flip --
    an f32 rounding difference flipping a layer pick or a cell-edge test --
    would send a particle on a diverging (but individually valid) path, so
    the max keeps a loose bound (< 5 km, 0.8% of path length)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    lat = rng.uniform(-55, 55, 100)
    lon = rng.uniform(-180, 180, 100)
    seeds = np.asarray(mt.geo.latlon_rad_to_xyz(np.deg2rad(lat),
                                                np.deg2rad(lon)))
    cells = mt.CellSearch(mesh).query(seeds)
    cfg = mt.TrajectorySettings(delta_t=120, simulation_duration=86400,
                                record_t=86400, depth=500.0,
                                fail_mode=mt.FailMode.ZERO)
    sol64 = mt.preprocess(mesh, raw_fields)
    raw64 = mt.run_advection(mesh, sol64, seeds, cells, cfg)

    mesh32 = mesh.astype(np.float32)
    sol32 = mt.preprocess(mesh32, {k: np.asarray(v, np.float32)
                                   for k, v in raw_fields.items()})
    raw32 = mt.run_advection(mesh32, sol32, seeds.astype(np.float32),
                             cells, cfg, dtype=jnp.float32)
    f32 = np.asarray(raw32.final_position, dtype=np.float64)
    f64 = np.asarray(raw64.final_position)
    drift = np.linalg.norm(f32 - f64, axis=1)
    print(f"f32 config-1 day drift: max {np.nanmax(drift):.2f} m "
          f"median {np.nanmedian(drift):.2f} m "
          f"p90 {np.nanpercentile(drift, 90):.2f} m")
    assert np.isfinite(drift).all()
    assert np.nanmedian(drift) < 5.0
    assert np.nanmax(drift) < 5000.0


@pytest.mark.parametrize("kind", ["sphere_delta", "rotation_delta"])
def test_small_step_increments_keep_their_digits(kind):
    """A float32 step increment of an Earth-radius position (0.1-100 m) is
    formed to ~1e-4 m, not to the ~0.5 m that pos + disp keeps."""
    import jax.numpy as jnp
    from mops_jax.advect import _sphere_delta
    rng = np.random.default_rng(3)
    v = rng.normal(size=(256, 3))
    pos = (v / np.linalg.norm(v, axis=1, keepdims=True)
           * mt.EARTH_RADIUS).astype(np.float32)
    p64 = pos.astype(np.float64)
    tang = np.cross(p64, rng.normal(size=(256, 3)))
    tang /= np.linalg.norm(tang, axis=1, keepdims=True)
    step = 10.0 ** rng.uniform(-1, 2, size=(256, 1))
    if kind == "sphere_delta":
        disp = (tang * step).astype(np.float32)
        dr = rng.uniform(-1e-3, 1e-3, 256).astype(np.float32)
        got = _sphere_delta(jnp.asarray(pos), jnp.asarray(disp),
                            jnp.asarray(dr))
        x = p64 + disp.astype(np.float64)
        r = np.linalg.norm(p64, axis=1, keepdims=True)
        want = x / np.linalg.norm(x, axis=1, keepdims=True) \
            * (r + dr.astype(np.float64)[:, None]) - p64
    else:
        axis = np.cross(p64, tang).astype(np.float32)
        theta = (step[:, 0] / mt.EARTH_RADIUS).astype(np.float32)
        got = mt.geo.rotation_delta(jnp.asarray(pos), jnp.asarray(axis),
                                    jnp.asarray(theta))
        want = np.asarray(mt.geo.rotate_around_axis(
            p64, axis.astype(np.float64), theta.astype(np.float64))) - p64
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=1e-4)


def test_slow_particles_f32_track_f64(mesh):
    """Particles moving ~1 m per step for a day: the float32 step, which
    carries each position's rounding residual, stays within a few metres of
    float64 (without the residual, float32 loses up to ~0.25 m a step)."""
    import jax.numpy as jnp
    raw = mt.synth.solid_body_fields(mesh, n_layers=6, omega=1.5e-9,
                                     omega_decay=1.0)
    rng = np.random.default_rng(5)
    lat = rng.uniform(-60, 60, 32)
    lon = rng.uniform(-180, 180, 32)
    seeds = np.asarray(mt.geo.latlon_rad_to_xyz(np.deg2rad(lat),
                                                np.deg2rad(lon)))
    cells = mt.CellSearch(mesh).query(seeds)
    cfg = mt.TrajectorySettings(delta_t=120, simulation_duration=86400,
                                record_t=86400, depth=100.0,
                                fail_mode=mt.FailMode.ZERO)
    r64 = mt.run_advection(mesh, mt.preprocess(mesh, raw), seeds, cells, cfg)
    mesh32, sol32 = _f32(mesh, raw)
    r32 = mt.run_advection(mesh32, sol32, seeds.astype(np.float32), cells,
                           cfg, dtype=jnp.float32)
    moved = np.linalg.norm(np.asarray(r64.final_position) - seeds, axis=1)
    assert np.median(moved) > 300.0
    err = np.linalg.norm(np.asarray(r32.final_position, np.float64)
                         - np.asarray(r64.final_position), axis=1)
    assert err.max() < 5.0, err.max()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_in_mesh_near_edges(mesh, dtype):
    """Points 1 m inside each edge of every cell test inside in float32 as
    in float64: the containment test must not misplace an edge by the
    rounding of Earth-radius coordinates.  The slack for a particle's own
    position (~3 m in either precision) takes in points 1 m outside, and
    never 30 m."""
    import jax.numpy as jnp
    from mops_jax.advect import _gather_cell_vertices, _in_mesh
    m = mesh.astype(dtype)
    cell = jnp.arange(m.n_cells, dtype=jnp.int32)
    _, nv, lane_valid, _, vpos = _gather_cell_vertices(m, cell)
    v = np.asarray(vpos, np.float64)
    nv_np = np.asarray(nv)
    k = np.arange(v.shape[1])
    nxt = np.where(k[None, :] == nv_np[:, None] - 1, 0,
                   np.minimum(k[None, :] + 1, len(k) - 1))
    b = np.take_along_axis(v, nxt[..., None], axis=1)
    mid = v + b
    mid *= mt.EARTH_RADIUS / np.linalg.norm(mid, axis=-1, keepdims=True)
    centre = np.asarray(m.cell_xyz, np.float64)[:, None, :]
    inward = centre - mid
    inward /= np.linalg.norm(inward, axis=-1, keepdims=True)
    valid = np.asarray(lane_valid)
    for shift, slack, expect in ((1.0, False, True), (-1.0, True, True),
                                 (-1.0, False, False), (-30.0, True, False)):
        pts = mid + shift * inward
        pts *= mt.EARTH_RADIUS / np.linalg.norm(pts, axis=-1, keepdims=True)
        for lane in range(v.shape[1]):
            rows = np.nonzero(valid[:, lane])[0]
            got = np.asarray(_in_mesh(jnp.asarray(pts[rows, lane], dtype),
                                      vpos[rows], nv[rows], lane_valid[rows],
                                      slack=slack))
            assert (got == expect).all(), (shift, slack, lane, np.mean(got))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_chunked_run_matches_unchunked(mesh, sol, seeds, cells, dtype):
    """Particle-axis chunking (chunk=N slices reusing one executable) must
    reproduce the unchunked run exactly, including per-particle depths and
    the padded tail slice."""
    depths = np.linspace(50, 900, len(seeds))
    cfg = mt.TrajectorySettings(delta_t=600, simulation_duration=600 * 6,
                                record_t=1200,
                                particle_depths=depths.astype(np.float32))
    a = mt.run_advection(mesh, sol, seeds, cells, cfg, dtype=dtype)
    b = mt.run_advection(mesh, sol, seeds, cells, cfg, chunk=3, dtype=dtype)
    np.testing.assert_allclose(np.asarray(b.points),
                               np.asarray(a.points), rtol=0, atol=0)
    np.testing.assert_allclose(np.asarray(b.final_position),
                               np.asarray(a.final_position), rtol=0, atol=0)
