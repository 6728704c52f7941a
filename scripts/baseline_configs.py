#!/usr/bin/env python
"""Run the five BASELINE.json measurement configs end to end.

The reference publishes no numbers (BASELINE.md); these are the driver's
canonical workloads, realized on synthetic MPAS-like meshes (no network access
for real E3SM data; swap --yaml for a real dataset when available):

  1. Streamline, 100 uniform seeds, single layer, coarse mesh, 1 day, dt=120 s
  2. Pathline, time-varying, 1k Gaussian seeds, Gulf of Mexico, 7 days
  3. Remap 1201x601 at fixed 20 m depth, full globe
  4. 1M-particle global pathline, multi-layer, 30 days (gather stress)
  5. Domain-decomposed migration run across N shards (config 5's single-host
     stand-in; multi-host needs jax.distributed on a real pod slice)

Usage: python scripts/baseline_configs.py [1 2 3 4 5] [--small]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import mops_jax as mt
from mops_jax.config import use_compile_cache
from mops_jax.settings import FailMode


def make_case(n_cells, n_layers, seed=0):
    mesh = mt.synth.build_voronoi_mesh(n_cells, jitter=0.05, seed=seed,
                                       n_layers=n_layers)
    raw = mt.synth.solid_body_fields(mesh, n_layers=n_layers, w_scale=1e-5)
    mesh32 = mesh.astype(np.float32)
    sol = mt.preprocess(mesh32, {k: np.asarray(v, np.float32)
                                 for k, v in raw.items()})
    return mesh32, sol


def timed(fn):
    out = fn()                      # compile + run
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def report(name, n_particles, n_steps, elapsed, extra=""):
    rate = n_particles * n_steps / elapsed
    print(json.dumps({"config": name, "particles": n_particles,
                      "steps": n_steps, "elapsed_s": round(elapsed, 3),
                      "steps_per_s": round(rate, 1), "extra": extra}))


def config1(small):
    """Streamline, 100 uniform seeds, 1 day, dt=120 s."""
    mesh, sol = make_case(2000 if small else 20000, 10)
    seeds = mt.seeding.generate_sample_points(mt.SamplingSettings(
        sample_range=(11, 11), lat_range=(20, 50), lon_range=(-80, -50),
        depth=10.0))
    cells = mt.CellSearch(mesh).query(seeds)
    cfg = mt.TrajectorySettings(delta_t=120, simulation_duration=mt.ONE_DAY,
                                record_t=120, depth=10.0,
                                fail_mode=FailMode.ZERO)
    seeds32 = seeds.astype(np.float32)

    def run():
        return mt.run_advection(mesh, sol, seeds32, cells, cfg,
                                exact_clamp=False,
                                dtype=jnp.float32).final_position
    _, dt = timed(run)
    report("1-streamline-100", len(seeds), cfg.n_steps, dt)


def config2(small):
    """Pathline, 1k Gaussian seeds, Gulf of Mexico, 7 days."""
    mesh, sol = make_case(2000 if small else 20000, 20)
    raw2 = mt.synth.solid_body_fields(mesh, n_layers=20, omega=1.2e-5,
                                      w_scale=1e-5)
    sol2 = mt.preprocess(mesh, {k: np.asarray(v, np.float32)
                                for k, v in raw2.items()})
    seeds = mt.seeding.generate_gaussian_points(
        mt.SamplingSettings(lat_range=(18.0, 31.0), lon_range=(-98.0, -80.0)),
        1000, mean_lat=25.0, mean_lon=-90.0, std_dev=3.0, seed=7)
    cells = mt.CellSearch(mesh).query(seeds)
    cfg = mt.TrajectorySettings(delta_t=600,
                                simulation_duration=7 * mt.ONE_DAY,
                                record_t=6 * mt.ONE_HOUR, depth=50.0,
                                fail_mode=FailMode.ZERO)
    seeds32 = seeds.astype(np.float32)

    def run():
        return mt.run_advection(mesh, sol, seeds32, cells, cfg, back=sol2,
                                exact_clamp=False,
                                dtype=jnp.float32).final_position
    _, dt = timed(run)
    report("2-pathline-gaussian-1k", len(seeds), cfg.n_steps, dt)


def config3(small):
    """Remap 1201x601 at fixed 20 m depth, full globe."""
    mesh, sol = make_case(2000 if small else 20000, 20)
    field = mt.Field(mesh, sol)
    w, h = (301, 151) if small else (1201, 601)
    cfg = mt.VisualizationSettings(image_width=w, image_height=h,
                                   fixed_depth=20.0)
    mt.remap.run_remapping(field, cfg)      # compile + warm
    t0 = time.perf_counter()
    imgs = mt.remap.run_remapping(field, cfg)
    elapsed = time.perf_counter() - t0
    finite = float(np.isfinite(imgs[0][..., 2]).mean())
    print(json.dumps({"config": "3-remap", "pixels": w * h,
                      "elapsed_s": round(elapsed, 3),
                      "pixels_per_s": round(w * h / elapsed, 1),
                      "finite_frac": round(finite, 4)}))


def config4(small):
    """1M-particle global pathline, multi-layer, 30 days."""
    n_part = 100_000 if small else 1_000_000
    n_steps_cap = 200 if small else 720     # 30 days at 1 h steps
    mesh, sol = make_case(5000 if small else 20000, 40)
    raw2 = mt.synth.solid_body_fields(mesh, n_layers=40, omega=1.2e-5,
                                      w_scale=1e-5)
    sol2 = mt.preprocess(mesh, {k: np.asarray(v, np.float32)
                                for k, v in raw2.items()})
    rng = np.random.default_rng(0)
    v = rng.normal(size=(n_part, 3))
    seeds = (v / np.linalg.norm(v, axis=1, keepdims=True)
             * mt.EARTH_RADIUS).astype(np.float32)
    cells = mt.CellSearch(mesh).query(seeds)
    cfg = mt.TrajectorySettings(
        delta_t=3600, simulation_duration=3600 * n_steps_cap,
        record_t=3600 * n_steps_cap,
        particle_depths=mt.seeding.linear_depth_profile(n_part, 10, 500),
        fail_mode=FailMode.ZERO)

    # chunk bounds the device memory of the gathered vertex columns (about
    # 13 KB per particle at L=40 with two snapshots); each chunk reuses one
    # compiled executable.  Whether chunking still pays on the GPU is not
    # measured yet.
    def run():
        return mt.run_advection(mesh, sol, seeds, cells, cfg, back=sol2,
                                exact_clamp=False, chunk=131072,
                                dtype=jnp.float32).final_position
    _, dt = timed(run)
    report("4-pathline-1M", n_part, cfg.n_steps, dt)


def config5(small):
    """Domain-decomposed migration run (config 5 single-host stand-in)."""
    from mops_jax.parallel.migrate import run_advection_migrating, reassemble
    n_part = 20_000 if small else 200_000
    mesh64 = mt.synth.build_voronoi_mesh(2000 if small else 20000,
                                         jitter=0.05, n_layers=20)
    raw = mt.synth.solid_body_fields(mesh64, n_layers=20, w_scale=1e-5)
    mesh = mesh64.astype(np.float32)
    sol = mt.preprocess(mesh, {k: np.asarray(v, np.float32)
                               for k, v in raw.items()})
    rng = np.random.default_rng(0)
    v = rng.normal(size=(n_part, 3))
    seeds = (v / np.linalg.norm(v, axis=1, keepdims=True)
             * mt.EARTH_RADIUS).astype(np.float32)
    cells = mt.CellSearch(mesh).query(seeds)
    cfg = mt.TrajectorySettings(delta_t=3600, simulation_duration=3600 * 100,
                                record_t=3600 * 25, depth=50.0,
                                fail_mode=FailMode.ZERO)

    # migrate_every=8 amortizes the exchange over an inner lax.scan of 8
    # advance steps (the old Python-unrolled k-body was slower than k=1;
    # round 5 replaced it -- see parallel/migrate.py)
    def run():
        return run_advection_migrating(mesh, sol, seeds, cells, cfg,
                                       migrate_every=8)
    result, dt = timed(run)
    dropped = int(np.asarray(result.dropped).sum())
    report("5-migration", n_part, cfg.n_steps, dt,
           extra=f"shards={result.final_ids.shape[0]} dropped={dropped}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("configs", nargs="*", type=int, default=[1, 2, 3, 4, 5])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    use_compile_cache()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)
    print(f"# device={jax.devices()[0].platform} x{len(jax.devices())}",
          file=sys.stderr)
    for c in (args.configs or [1, 2, 3, 4, 5]):
        {1: config1, 2: config2, 3: config3, 4: config4, 5: config5}[c](args.small)


if __name__ == "__main__":
    main()
