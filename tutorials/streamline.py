"""Streamline tutorial: long steady-field integration.

Mirrors reference tutorial/streamLine.cpp (dt = 1 min, record = 6 min,
multi-day forward RK4 from a lat-lon seed box), runnable on either a YAML
dataset or the synthetic mesh.
"""

import argparse

import numpy as np

import mops_jax as mt
from mops_jax import api
from mops_jax.io import image as imgio


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--yaml")
    ap.add_argument("--synthetic", type=int, default=5000)
    ap.add_argument("--days", type=int, default=5)
    ap.add_argument("--out", default="streamline.vtp")
    args = ap.parse_args()

    app = api.MOPSApp()
    app.init(precision="fp64")
    app.begin()
    if args.yaml:
        from mops_jax.io import MPASOReader, StreamConfig
        reader = MPASOReader(StreamConfig.parse(args.yaml))
        mesh = reader.read_mesh()
        raw = reader.read_solution(0)
        raw.pop("_timestamp", None)
    else:
        mesh = mt.synth.build_voronoi_mesh(args.synthetic, jitter=0.05)
        raw = mt.synth.solid_body_fields(mesh, n_layers=20)
    app.add_grid(mesh)
    app.add_solution(1, raw)
    app.end()
    app.active_attribute(1)

    seeds = app.generate_sample_points(mt.SamplingSettings(
        sample_range=(8, 8), lat_range=(20, 50), lon_range=(-80, -50),
        depth=10.0))
    cfg = mt.TrajectorySettings(
        delta_t=mt.ONE_MINUTE, record_t=6 * mt.ONE_MINUTE,
        simulation_duration=args.days * mt.ONE_DAY, depth=10.0,
        fail_mode=mt.FailMode.ZERO)
    lines = app.run_streamline(cfg, seeds)
    imgio.save_trajectories_vtp(args.out, lines)
    print(f"wrote {len(lines)} lines x {lines[0].points.shape[0]} points "
          f"to {args.out}")


if __name__ == "__main__":
    main()
