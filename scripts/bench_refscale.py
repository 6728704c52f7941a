#!/usr/bin/env python
"""Reference-scale benchmark cases, one JSON line each.

Every engine case is gated (mops_jax.gate) against the float64 XLA step on
a particle subset before it is timed:

  A. 500k cells x L=80 streamline (eddy-resolving scale)
  B. 2M cells x L=40 streamline (oRRS18to6-class cell count)
  D. config-4 spec: 1M cells, 10M particles via chunk, pathline
  E. config-5 spec: 1M cells, 10M particles on the decomposed (migrating)
     engine over the visible devices

Usage: python scripts/bench_refscale.py [A B D E] [--out FILE]
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
from mops_jax.gate import lane_gate
from mops_jax.settings import FailMode

RESULTS = []


def log(rec):
    rec = dict(rec)
    RESULTS.append(rec)
    print(json.dumps(rec), flush=True)


def build(n_cells, n_layers, n_particles, seed=0, with_attrs=False):
    t0 = time.perf_counter()
    mesh64 = mt.synth.build_voronoi_mesh(n_cells, jitter=0.05, seed=seed,
                                         n_layers=n_layers)
    t1 = time.perf_counter()
    raw = mt.synth.solid_body_fields(mesh64, n_layers=n_layers, w_scale=1e-5)
    if not with_attrs:
        # temperature/salinity double the per-vertex memory and the
        # streamline cases never read them
        raw = {k: v for k, v in raw.items()
               if k not in ("temperature", "salinity")}
    mesh = mesh64.astype(np.float32)
    sol = mt.preprocess(mesh, {k: np.asarray(v, np.float32)
                               for k, v in raw.items()})
    if not with_attrs:
        sol = sol.slim()     # advection-only: drop cell-sited tables
    jax.block_until_ready(sol.vertex_ztop)
    t2 = time.perf_counter()
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n_particles, 3))
    seeds = (v / np.linalg.norm(v, axis=1, keepdims=True)
             * mt.EARTH_RADIUS).astype(np.float32)
    cells = mt.CellSearch(mesh).query(seeds)
    t3 = time.perf_counter()
    print(f"# built cells={n_cells} L={n_layers} N={n_particles}: "
          f"mesh {t1-t0:.1f}s preprocess {t2-t1:.1f}s seed-query {t3-t2:.1f}s",
          file=sys.stderr, flush=True)
    return mesh, sol, seeds, cells


def gate(mesh, sol, seeds, cells, cfg, n_gate=8192, **kw):
    """The timed path against the float64 XLA step on a particle subset,
    20 steps."""
    import dataclasses as dc
    sub = slice(0, min(n_gate, len(seeds)))
    depths = np.asarray(cfg.effective_depths(len(seeds)))[sub]
    gcfg = dc.replace(cfg, simulation_duration=cfg.delta_t * 20,
                      record_t=cfg.delta_t * 20,
                      particle_depths=depths.astype(np.float32))
    fast = mt.run_advection(mesh, sol, seeds[sub], cells[sub], gcfg,
                            exact_clamp=False, dtype=jnp.float32, **kw)
    exact = mt.run_advection(mesh, sol, seeds[sub], cells[sub], gcfg,
                             dtype=jnp.float64, **kw)
    res = lane_gate(np.asarray(fast.final_position),
                    np.asarray(exact.final_position), seeds[sub])
    print(f"# gate: {res}", file=sys.stderr, flush=True)
    return res["ok"]


def timed_run(fn):
    out = fn()
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = fn()
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def streamline_case(name, n_cells, n_layers, n_particles, n_steps=100):
    mesh, sol, seeds, cells = build(n_cells, n_layers, n_particles)
    cfg = mt.TrajectorySettings(delta_t=120,
                                simulation_duration=120 * n_steps,
                                record_t=120 * n_steps, depth=100.0,
                                fail_mode=FailMode.ZERO)
    ok = gate(mesh, sol, seeds, cells, cfg)

    def run():
        return mt.run_advection(mesh, sol, seeds, cells, cfg,
                                exact_clamp=False,
                                dtype=jnp.float32)
    raw, dt = timed_run(lambda: run().final_position)
    log({"case": name, "cells": n_cells, "layers": n_layers,
         "particles": n_particles, "steps": n_steps,
         "steps_per_s": n_particles * n_steps / dt,
         "elapsed_s": dt, "verified": ok})
    return mesh, sol, seeds, cells, cfg


def case_A_B(which):
    if "A" in which:
        streamline_case("refscale-500k", 500_000, 80, 65_536)
    if "B" in which:
        streamline_case("refscale-2M", 2_000_000, 40, 65_536)


def case_D():
    """Config-4 spec scale: 1M cells, 10M particles, pathline, chunked."""
    n_cells, n_layers, n_part, n_steps = 1_000_000, 40, 10_000_000, 100
    mesh, sol, seeds, cells = build(n_cells, n_layers, n_part)
    raw2 = mt.synth.solid_body_fields(
        jax.tree.map(np.asarray, mesh), n_layers=n_layers, omega=1.2e-5,
        w_scale=1e-5)
    sol2 = mt.preprocess(mesh, {k: np.asarray(v, np.float32)
                                for k, v in raw2.items()
                                if k not in ("temperature",
                                             "salinity")}).slim()
    cfg = mt.TrajectorySettings(
        delta_t=3600, simulation_duration=3600 * n_steps,
        record_t=3600 * n_steps,
        particle_depths=mt.seeding.linear_depth_profile(n_part, 10, 500),
        fail_mode=FailMode.ZERO)
    ok = gate(mesh, sol, seeds, cells, cfg, back=sol2)

    def run():
        return mt.run_advection(mesh, sol, seeds, cells, cfg, back=sol2,
                                exact_clamp=False, chunk=131072,
                                dtype=jnp.float32).final_position
    _, dt = timed_run(run)
    log({"case": "config4-spec", "cells": n_cells, "layers": n_layers,
         "particles": n_part, "steps": n_steps,
         "steps_per_s": n_part * n_steps / dt,
         "elapsed_s": dt, "verified": ok})


def case_E():
    """Config-5 spec scale: 1M cells, 10M particles, migrating engine."""
    from mops_jax.parallel.migrate import run_advection_migrating
    n_cells, n_layers, n_part, n_steps = 1_000_000, 60, 10_000_000, 100
    mesh, sol, seeds, cells = build(n_cells, n_layers, n_part)
    cfg = mt.TrajectorySettings(delta_t=3600,
                                simulation_duration=3600 * n_steps,
                                record_t=3600 * 25, depth=50.0,
                                fail_mode=FailMode.ZERO)

    def run():
        return run_advection_migrating(mesh, sol, seeds, cells, cfg,
                                       capacity_factor=1.25, migrate_every=8)
    out, dt = timed_run(run)
    log({"case": "config5-spec", "cells": n_cells, "layers": n_layers,
         "particles": n_part, "steps": n_steps,
         "steps_per_s": n_part * n_steps / dt,
         "elapsed_s": dt,
         "dropped": int(np.asarray(out.dropped).sum()),
         "shards": int(out.final_ids.shape[0])})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("cases", nargs="*", default=["A", "B", "D", "E"])
    ap.add_argument("--out", help="also write the results to this JSON file")
    args = ap.parse_args()
    use_compile_cache()
    jax.config.update("jax_enable_x64", True)    # for the float64 gate only
    which = set(args.cases)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_refscale.py: no GPU (JAX platform is "
                 f"{dev.platform!r})")
    print(f"# device={dev.platform} kind={dev.device_kind!r} "
          f"count={len(jax.devices())}", file=sys.stderr, flush=True)
    if which & {"A", "B"}:
        case_A_B(which)
    if "D" in which:
        case_D()
    if "E" in which:
        case_E()
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": {"platform": dev.platform,
                                  "kind": dev.device_kind,
                                  "count": len(jax.devices())},
                       "results": RESULTS}, f, indent=1)


if __name__ == "__main__":
    main()
