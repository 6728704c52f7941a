"""Pathline tutorial: month-pair chaining with per-particle depths.

Mirrors reference tutorial/pathLine.cpp: RK4 dt = 10 min, record = 6 h,
global seed grid with depths spread linearly 10..500 m, lastPoint/lastDepth
carried over between consecutive snapshot pairs.
"""

import argparse

import numpy as np

import mops_jax as mt
from mops_jax import api, seeding
from mops_jax.io import image as imgio


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--synthetic", type=int, default=5000)
    ap.add_argument("--grid", type=int, default=20, help="seeds per axis")
    ap.add_argument("--pairs", type=int, default=3, help="snapshot pairs")
    ap.add_argument("--hours", type=int, default=24, help="sim hours per pair")
    ap.add_argument("--out", default="pathline.vtp")
    args = ap.parse_args()

    mesh = mt.synth.build_voronoi_mesh(args.synthetic, jitter=0.05)
    app = api.MOPSApp()
    app.init(precision="fp64")
    app.begin()
    app.add_grid(mesh)
    # a sequence of snapshots with slowly-evolving velocity
    raw0 = mt.synth.solid_body_fields(mesh, n_layers=20)
    for t in range(args.pairs + 1):
        raw_t = {k: (np.asarray(v) * (1.0 + 0.05 * t)
                     if k.startswith("velocity") else np.asarray(v))
                 for k, v in raw0.items()}
        app.add_solution(t, raw_t, timestamp=f"month{t}", timestep=t)
    app.end()

    seeds = app.generate_sample_points(mt.SamplingSettings(
        sample_range=(args.grid, args.grid), lat_range=(-60, 60),
        lon_range=(-180, 180), depth=10.0))
    depths = seeding.linear_depth_profile(len(seeds), 10.0, 500.0)

    all_lines = None
    for t in range(args.pairs):
        app.active_attribute(t, t + 1)
        cfg = mt.TrajectorySettings(
            delta_t=10 * mt.ONE_MINUTE, record_t=6 * mt.ONE_HOUR,
            simulation_duration=args.hours * mt.ONE_HOUR,
            particle_depths=depths, fail_mode=mt.FailMode.ZERO)
        lines = app.run_pathline(cfg, seeds)   # advances seeds in place
        if all_lines is None:
            all_lines = lines
        else:
            for full, seg in zip(all_lines, lines):
                full.points = np.concatenate([full.points, seg.points[1:]])
                full.velocity = np.concatenate([full.velocity, seg.velocity[1:]])
                full.temperature = np.concatenate([full.temperature,
                                                   seg.temperature[1:]])
                full.salinity = np.concatenate([full.salinity, seg.salinity[1:]])
                full.last_point = seg.last_point
        print(f"pair {t}->{t + 1} done")

    imgio.save_trajectories_vtp(args.out, all_lines)
    imgio.export_pathline_binary(args.out.replace(".vtp", ".bin"), all_lines)
    print(f"wrote {len(all_lines)} pathlines to {args.out}")


if __name__ == "__main__":
    main()
