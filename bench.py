#!/usr/bin/env python
"""mops_jax headline benchmark: particle-RK4-steps/s on one GPU.

Runs the full streamline RK4 advection loop (relocation + Wachspress
interpolation + vertical layer search + RK4 sphere update, i.e. the reference
StreamLine kernel pipeline) on a synthetic MPAS-like mesh in float32 and
reports ONE JSON line:

    {"metric": "particle_rk4_steps_per_s", "value": N, "unit": "steps/s",
     "verified": bool, "device": {...}}

Before timing, 20 steps of the timed program are gated (mops_jax.gate)
against the float64 step on the same lanes.  A run without a GPU fails.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

import mops_jax as mt
from mops_jax.config import use_compile_cache
from mops_jax.gate import lane_gate
from mops_jax.settings import FailMode


def build_case(n_cells, n_layers, n_particles, seed=0,
               w_scale=1e-5, bathymetry_amp=0.0, shelf_lon=None,
               omega_decay=0.5):
    mesh = mt.synth.build_voronoi_mesh(n_cells, jitter=0.05, seed=seed,
                                       n_layers=n_layers)
    raw = mt.synth.solid_body_fields(mesh, n_layers=n_layers,
                                     w_scale=w_scale,
                                     omega_decay=omega_decay,
                                     bathymetry_amp=bathymetry_amp,
                                     shelf_lon=shelf_lon)
    mesh32 = mesh.astype(np.float32)
    sol = mt.preprocess(mesh32, {k: np.asarray(v, dtype=np.float32)
                                 for k, v in raw.items()})

    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n_particles, 3))
    seeds = (v / np.linalg.norm(v, axis=1, keepdims=True)
             * mt.EARTH_RADIUS).astype(np.float32)
    cells = mt.CellSearch(mesh).query(seeds)
    return mesh32, sol, seeds, cells


def main():
    use_compile_cache()
    jax.config.update("jax_enable_x64", True)   # for the float64 gate only
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py: no GPU (JAX platform is {dev.platform!r})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    n_cells = int(os.environ.get("BENCH_CELLS", 20000))
    n_layers = int(os.environ.get("BENCH_LAYERS", 60))
    n_particles = int(os.environ.get("BENCH_PARTICLES", 65536))
    n_steps = int(os.environ.get("BENCH_STEPS", 200))
    # BENCH_REGIME=crossing: realistic vertVelocityTop magnitude (1e-3 m/s,
    # sign varying over the sphere) + O(1) bathymetry gradients, so particles
    # cross layers often; the default solid-body regime keeps its layers.
    crossing = os.environ.get("BENCH_REGIME") == "crossing"

    mesh, sol, seeds, cells = build_case(
        n_cells, n_layers, n_particles,
        w_scale=1e-3 if crossing else 1e-5,
        bathymetry_amp=0.5 if crossing else 0.0,
        shelf_lon=0.3 if crossing else None,
        # no with-depth velocity decay in the crossing regime: deep
        # particles must actually sweep across the shelf edges
        omega_decay=1.0 if crossing else 0.5)
    # crossing regime: particle depths spread into the deep column so shelf
    # crossings actually put particles below the local bottom
    depth_kw = dict(particle_depths=mt.seeding.linear_depth_profile(
        n_particles, 10, 2500)) if crossing else dict(depth=100.0)
    delta_t = int(os.environ.get("BENCH_DT", 120))
    cfg = mt.TrajectorySettings(
        delta_t=delta_t, simulation_duration=delta_t * n_steps,
        record_t=delta_t * n_steps, fail_mode=FailMode.ZERO, **depth_kw)

    # correctness gate before timing: the timed program against the float64
    # step on the same lanes (an independent reference on this device)
    vg_cfg = mt.TrajectorySettings(
        delta_t=delta_t, simulation_duration=delta_t * 20,
        record_t=delta_t * 20, fail_mode=FailMode.ZERO, **depth_kw)
    fast = mt.run_advection(mesh, sol, seeds, cells, vg_cfg,
                            exact_clamp=False, dtype=jnp.float32)
    exact = mt.run_advection(mesh, sol, seeds, cells, vg_cfg,
                             dtype=jnp.float64)
    gate = lane_gate(np.asarray(fast.final_position),
                     np.asarray(exact.final_position), seeds)
    if not gate["ok"]:
        print(f"# CORRECTNESS GATE FAILED: {gate}", file=sys.stderr)

    def run():
        raw = mt.run_advection(mesh, sol, seeds, cells, cfg,
                               exact_clamp=False, dtype=jnp.float32)
        raw.final_position.block_until_ready()
        return raw

    run()                       # compile + warm
    t0 = time.perf_counter()
    run()
    elapsed = time.perf_counter() - t0
    steps_per_s = n_particles * n_steps / elapsed

    print(f"# device={dev.platform} kind={dev.device_kind!r} card={card!r} "
          f"cells={n_cells} layers={n_layers} particles={n_particles} "
          f"steps={n_steps} elapsed={elapsed:.6f}s "
          f"regime={'crossing' if crossing else 'solid-body'} "
          f"gate_share_off={gate['share_off']}", file=sys.stderr)
    print(json.dumps({
        "metric": "particle_rk4_steps_per_s",
        "value": steps_per_s,
        "unit": "steps/s",
        "verified": gate["ok"],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices()), "card": card},
    }))


if __name__ == "__main__":
    main()
