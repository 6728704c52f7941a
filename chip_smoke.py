#!/usr/bin/env python
"""Smoke test of the main path on the GPU, at a size users run.

    python chip_smoke.py           phases a-d on one card
    python chip_smoke.py --four    phase f alone: the sharded and migrating
                                   engines on four cards

Phases (each prints one line of what it found):

  a. device: a GPU is required; prints the card's name and power limit,
     the JAX version and the compile-cache directory.
  b. streamline through the MOPS_* API on a synthetic mesh at the size of
     EC30to60E2r2 (236,853 cells, 60 layers), 400x400 global seeds at
     10-500 m, RK4, dt = 120 s, one day, a record every 6 min, float32.
     Gated against the float64 XLA step on every lane (mops_jax.gate), and
     the float64 run against the NumPy oracle on 64 lanes.
  c. pathline on two snapshots with both named attributes, dt = 600 s, a
     record every 6 h, one day; the same two checks.
  d. remap at 3601x1801, fixed depth 20 m: float32 against float64.
  f. (--four) run_advection_sharded with 1,000,000 particles and
     run_advection_migrating with the phase-b seeds on four cards, six hours
     at dt = 120 s, each against the one-card run_advection on the same
     lanes.

A failing phase raises, so the script exits non-zero and prints no result.
The last line is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

N_CELLS = 236_853        # EC30to60E2r2
N_LAYERS = 60
SEED_SIDE = 400          # 400 x 400 global seeds (tutorial/pathLine.cpp)
ORACLE_LANES = 64
REMAP_SIZE = (3601, 1801)
FOUR_PARTICLES = 1_000_000


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def result_line(devices) -> str:
    """The script's last line: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}})


def phase_device(count: int = 1):
    """a. The GPU, its name and power limit, JAX and the compile cache."""
    import jax
    from mops_jax.config import use_compile_cache
    cache = use_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform is "
                         f"{devs[0].platform!r})")
    if len(devs) < count:
        raise SystemExit(f"chip_smoke: {count} GPUs needed, "
                         f"{len(devs)} found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    log("a", platform=devs[0].platform, kind=repr(devs[0].device_kind),
        count=len(devs), jax=jax.__version__, cache=cache)
    return devs[:count]


def build_case(n_cells: int, n_layers: int, side: int, seed: int = 0):
    """Mesh, two raw snapshots (with temperature and salinity), seeds on a
    side x side global lat-lon grid and their depths (10-500 m)."""
    import mops_jax as mt
    mesh = mt.synth.build_voronoi_mesh(n_cells, n_layers=n_layers,
                                       jitter=0.05, seed=seed)
    # a surface current of about 1 m/s (omega * Earth radius) that decays by
    # 0.9 per layer, an e-folding depth of about 600 m at 60 layers over
    # 4 km: the order of strong wind-driven currents
    raw1 = mt.synth.solid_body_fields(mesh, n_layers=n_layers, omega=1.5e-7,
                                      omega_decay=0.9, w_scale=1e-5)
    raw2 = mt.synth.solid_body_fields(mesh, n_layers=n_layers, omega=1.8e-7,
                                      omega_decay=0.9, w_scale=1e-5)
    # the sampler excludes the range's end point: side + 1 gives side per axis
    seeds = mt.seeding.generate_sample_points(mt.SamplingSettings(
        sample_range=(side + 1, side + 1), lat_range=(-80.0, 80.0),
        lon_range=(-180.0, 180.0)))
    depths = mt.seeding.linear_depth_profile(len(seeds), 10.0, 500.0)
    return mesh, raw1, raw2, seeds, depths


def _app(mesh, raws, precision: str):
    from mops_jax import api
    import jax
    app = api.MOPSApp()
    app.init(device=jax.devices()[0].platform, precision=precision)
    app.begin()
    app.add_grid(mesh)
    for i, raw in enumerate(raws, start=1):
        app.add_solution(i, dict(raw), timestamp=f"t{i}", timestep=0)
    app.end()
    return app


def _oracle_check(oracle_pts, pts64, atol: float) -> float:
    """Largest |oracle - f64| over the checked lanes' records; raises past
    atol."""
    err = float(np.max(np.abs(np.asarray(oracle_pts) - np.asarray(pts64))))
    if not err <= atol:
        raise AssertionError(f"f64 vs oracle: max error {err:.3e} m > "
                             f"{atol:g} m")
    return err


def _gate_or_raise(phase: str, name: str, res: dict) -> None:
    if not res["ok"]:
        raise AssertionError(f"{phase}: {name} gate failed: {res}")


def phase_streamline(mesh, raw, seeds, depths, duration: int = 86400,
                     dt: int = 120, record: int = 360,
                     oracle_lanes: int = ORACLE_LANES) -> dict:
    """b. Streamline through the MOPS_* API in float32, against float64."""
    import jax.numpy as jnp
    import mops_jax as mt
    from mops_jax.gate import lane_gate
    from mops_jax.oracle import oracle_streamline
    cfg = mt.TrajectorySettings(delta_t=dt, simulation_duration=duration,
                                record_t=record, particle_depths=depths,
                                fail_mode=mt.FailMode.ZERO)
    app = _app(mesh, [raw], "fp32")
    app.active_attribute(1)
    t0 = time.perf_counter()
    lines = app.run_streamline(cfg, seeds.copy())
    t_api = time.perf_counter() - t0
    final32 = np.stack([ln.last_point for ln in lines])

    sol64 = app.solutions[1]
    cells = app.field.calc_in_which_cells(seeds)
    t0 = time.perf_counter()
    raw64 = mt.run_advection(mesh, sol64, seeds, cells, cfg,
                             dtype=jnp.float64)
    pts64 = np.asarray(raw64.points)
    t_64 = time.perf_counter() - t0
    res = lane_gate(final32, pts64[:, -1], seeds)
    _gate_or_raise("b", "f32 vs f64", res)
    # the float32 step alone, warm: the device part of the API call
    mesh32, sol32 = mesh.astype(jnp.float32), sol64.astype(jnp.float32)
    seeds32 = np.asarray(seeds, np.float32)
    t_step = _timed(lambda: mt.run_advection(
        mesh32, sol32, seeds32, cells, cfg, dtype=jnp.float32).final_position)

    # the oracle follows the reference's TBB semantics (FailMode.FREEZE)
    lanes = np.linspace(0, len(seeds) - 1, oracle_lanes).astype(int)
    cfg_o = dataclasses.replace(cfg, particle_depths=depths[lanes],
                                fail_mode=mt.FailMode.FREEZE)
    pts_x = np.asarray(mt.run_advection(
        mesh, sol64, seeds[lanes], cells[lanes], cfg_o,
        dtype=jnp.float64).points)
    pts_o, _, _, _ = oracle_streamline(mesh, sol64, seeds[lanes],
                                       cells[lanes], cfg_o)
    err_o = _oracle_check(pts_o, pts_x, atol=5e-6)
    log("b", particles=len(seeds), steps=cfg.n_steps,
        share_off=res["share_off"], tol_m=res["tol_m"],
        median_disp_m=res["median_disp_m"], api_f32_s=t_api,
        step_f32_warm_s=t_step,
        f32_steps_per_s=len(seeds) * cfg.n_steps / t_step, xla_f64_s=t_64,
        oracle_lanes=oracle_lanes, oracle_max_err_m=err_o)
    return {"gate": res, "oracle_err": err_o, "step_s": t_step}


def phase_pathline(mesh, raw1, raw2, seeds, depths, duration: int = 86400,
                   dt: int = 600, record: int = 21600,
                   oracle_lanes: int = ORACLE_LANES) -> dict:
    """c. Pathline with both named attributes, float32 against float64."""
    import jax.numpy as jnp
    import mops_jax as mt
    from mops_jax.advect import stacked_vertex_attrs
    from mops_jax.gate import lane_gate
    from mops_jax.oracle import oracle_pathline
    cfg = mt.TrajectorySettings(delta_t=dt, simulation_duration=duration,
                                record_t=record, particle_depths=depths,
                                fail_mode=mt.FailMode.ZERO)
    app = _app(mesh, [raw1, raw2], "fp32")
    app.active_attribute(1, 2)
    t0 = time.perf_counter()
    lines = app.run_pathline(cfg, seeds.copy())
    t_api = time.perf_counter() - t0
    final32 = np.stack([ln.last_point for ln in lines])

    front, back = app.solutions[1], app.solutions[2]
    n_attrs = len(front.vertex_attrs)
    if n_attrs < 2 or lines[0].attrs is None:
        raise AssertionError(f"c: pathline carried {n_attrs} attributes, "
                             "2 expected")
    cells = app.field.calc_in_which_cells(seeds)
    t0 = time.perf_counter()
    raw64 = mt.run_advection(mesh, front, seeds, cells, cfg, back=back,
                             dtype=jnp.float64)
    pts64 = np.asarray(raw64.points)
    t_64 = time.perf_counter() - t0
    res = lane_gate(final32, pts64[:, -1], seeds)
    _gate_or_raise("c", "f32 vs f64", res)

    lanes = np.linspace(0, len(seeds) - 1, oracle_lanes).astype(int)
    cfg_o = dataclasses.replace(cfg, particle_depths=depths[lanes],
                                fail_mode=mt.FailMode.FREEZE)
    raw_x = mt.run_advection(mesh, front, seeds[lanes], cells[lanes], cfg_o,
                             back=back, dtype=jnp.float64)
    af = stacked_vertex_attrs(front)
    ab = stacked_vertex_attrs(back)
    pts_o, _, attrs_o, _, _ = oracle_pathline(
        mesh, front, back, seeds[lanes], cells[lanes], cfg_o,
        attrs_f=np.asarray(af), attrs_b=np.asarray(ab))
    err_o = _oracle_check(pts_o, np.asarray(raw_x.points), atol=5e-3)
    _oracle_check(attrs_o, np.asarray(raw_x.attrs), atol=1e-8)
    log("c", particles=len(seeds), steps=cfg.n_steps, attrs=n_attrs,
        share_off=res["share_off"], tol_m=res["tol_m"],
        median_disp_m=res["median_disp_m"], api_f32_s=t_api,
        xla_f64_s=t_64, oracle_lanes=oracle_lanes, oracle_max_err_m=err_o)
    return {"gate": res, "oracle_err": err_o, "attrs": n_attrs}


def phase_remap(mesh, raw, size=REMAP_SIZE, depth: float = 20.0) -> dict:
    """d. Fixed-depth remap, float32 against float64 on the card."""
    import jax.numpy as jnp
    import mops_jax as mt
    from mops_jax import remap
    app = _app(mesh, [raw], "fp64")
    app.active_attribute(1)
    cfg = mt.VisualizationSettings(image_width=size[0], image_height=size[1],
                                   fixed_depth=depth)
    field64 = app.field
    field32 = mt.Field(mesh.astype(jnp.float32),
                       field64.front.astype(jnp.float32),
                       _search=field64.search)
    t0 = time.perf_counter()
    img64 = remap.run_remapping(field64, cfg)[0]
    t_64 = time.perf_counter() - t0
    t0 = time.perf_counter()
    img32 = remap.run_remapping(field32, cfg)[0].astype(np.float64)
    t_32 = time.perf_counter() - t0
    s64, s32 = img64[..., 2], img32[..., 2]
    nan64, nan32 = ~np.isfinite(s64), ~np.isfinite(s32)
    mask_diff = float(np.mean(nan64 != nan32))
    both = ~nan64 & ~nan32
    # speeds below a thousandth of the peak are compared absolutely
    floor = 1e-3 * float(np.max(np.abs(s64[both])))
    rel = float(np.max(np.abs(s32[both] - s64[both])
                       / np.maximum(np.abs(s64[both]), floor)))
    if not (mask_diff <= 1e-3 and rel <= 1e-4):
        raise AssertionError(f"d: remap f32 vs f64: NaN-mask difference "
                             f"{mask_diff:.2e}, relative speed error "
                             f"{rel:.2e}")
    log("d", pixels=s64.size, nan_share=float(np.mean(nan64)),
        nan_mask_diff=mask_diff, rel_speed_err=rel, f64_s=t_64, f32_s=t_32)
    return {"mask_diff": mask_diff, "rel": rel}


def _timed(fn, repeats: int = 2) -> float:
    """Seconds of the fastest warm call of fn (compiled already)."""
    import jax
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def phase_four(mesh, raw, seeds, devices, n_sharded: int,
               duration: int = 21600, dt: int = 120) -> dict:
    """f. Sharded and migrating engines over ``devices``, each against the
    one-card run_advection on the same lanes."""
    import jax
    import jax.numpy as jnp
    import mops_jax as mt
    from mops_jax.gate import lane_gate
    from mops_jax.parallel import device_mesh, run_advection_sharded
    from mops_jax.parallel.migrate import (SHARD_AXIS, reassemble,
                                           run_advection_migrating)
    n_dev = len(devices)
    mesh32 = mesh.astype(jnp.float32)
    sol32 = mt.preprocess(mesh32, {k: np.asarray(v, np.float32)
                                   for k, v in raw.items()})
    search = mt.CellSearch(mesh)

    # sharded: n_sharded particles, the phase-b seeds cycled with new depths
    reps = -(-n_sharded // len(seeds))
    seeds_s = np.tile(seeds, (reps, 1))[:n_sharded].astype(np.float32)
    depths_s = mt.seeding.linear_depth_profile(n_sharded, 10.0, 500.0)
    cells_s = np.tile(search.query(seeds), reps)[:n_sharded]
    cfg_s = mt.TrajectorySettings(delta_t=dt, simulation_duration=duration,
                                  record_t=duration, particle_depths=depths_s,
                                  fail_mode=mt.FailMode.ZERO)
    dmesh = device_mesh(n_dev)
    if dmesh.devices.size != n_dev or len(set(
            d.id for d in dmesh.devices.flat)) != n_dev:
        raise AssertionError(f"f: device mesh spans {dmesh.devices.size} "
                             f"devices, {n_dev} wanted")
    t0 = time.perf_counter()
    sh = run_advection_sharded(mesh32, sol32, seeds_s, cells_s, cfg_s,
                               dmesh=dmesh, dtype=jnp.float32)
    fin_sh = np.asarray(sh.final_position)
    t_sh = time.perf_counter() - t0
    # the one-card reference in slices of one card's share of the particles
    t0 = time.perf_counter()
    single = mt.run_advection(mesh32, sol32, seeds_s, cells_s, cfg_s,
                              dtype=jnp.float32, chunk=n_sharded // n_dev)
    fin_1 = np.asarray(single.final_position)
    t_1 = time.perf_counter() - t0
    diff = float(np.max(np.abs(fin_sh.astype(np.float64) - fin_1)))
    bit_equal = bool(np.array_equal(fin_sh, fin_1))
    if not diff <= 1e-6 and not lane_gate(fin_sh, fin_1, seeds_s)["ok"]:
        raise AssertionError(f"f: sharded vs one card: max diff {diff} m")
    log("f", engine="sharded", particles=n_sharded, devices=n_dev,
        mesh_devices=dmesh.devices.size, max_diff_m=diff,
        bit_equal=bit_equal, sharded_s=t_sh, one_card_s=t_1)

    # migrating: the phase-b seeds (the first lanes of the sharded set) over
    # a decomposed mesh, against the same lanes of the one-card run
    n = len(seeds)
    cfg_m = dataclasses.replace(cfg_s, particle_depths=depths_s[:n])
    mmesh = jax.make_mesh((n_dev,), (SHARD_AXIS,), devices=devices)
    t0 = time.perf_counter()
    res_m = run_advection_migrating(mesh32, sol32, seeds_s[:n], cells_s[:n],
                                    cfg_m, dmesh=mmesh)
    _, _, _, fin_m, _ = reassemble(res_m, n, seeds_s[:n])
    t_m = time.perf_counter() - t0
    gate = lane_gate(fin_m, fin_1[:n], seeds_s[:n])
    occ = (np.asarray(res_m.final_ids) >= 0).sum(axis=1)
    migrated = int(np.asarray(res_m.migrated).sum())
    dropped = int(np.asarray(res_m.dropped).sum())
    log("f", engine="migrating", particles=n, devices=n_dev,
        occupancy=occ.tolist(), migrated=migrated, dropped=dropped,
        share_off=gate["share_off"], migrating_s=t_m)
    _gate_or_raise("f", "migrating vs one card", gate)
    return {"sharded_diff": diff, "bit_equal": bit_equal, "gate": gate,
            "occupancy": occ, "migrated": migrated, "dropped": dropped}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase f")
    args = ap.parse_args(argv)

    devices = phase_device(4 if args.four else 1)
    import jax
    jax.config.update("jax_enable_x64", True)
    import mops_jax as mt  # noqa: F401  (after the device check)

    t0 = time.perf_counter()
    mesh, raw1, raw2, seeds, depths = build_case(N_CELLS, N_LAYERS, SEED_SIDE)
    log("case", cells=N_CELLS, layers=N_LAYERS, particles=len(seeds),
        build_s=time.perf_counter() - t0)
    if args.four:
        phase_four(mesh, raw1, seeds, devices, FOUR_PARTICLES)
    else:
        phase_streamline(mesh, raw1, seeds, depths)
        phase_pathline(mesh, raw1, raw2, seeds, depths)
        phase_remap(mesh, raw1)
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
