"""Remapping tutorial: global fixed-depth velocity/attribute rasterization.

Mirrors reference tutorial/reMapping.cpp (global lon/lat image at a fixed
depth, saved as PNG + VTI).
"""

import argparse

import mops_jax as mt
from mops_jax import api
from mops_jax.io import image as imgio


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--synthetic", type=int, default=5000)
    ap.add_argument("--size", default="1201x601")
    ap.add_argument("--depth", type=float, default=20.0)
    ap.add_argument("--out", default="remap")
    args = ap.parse_args()

    w, h = (int(v) for v in args.size.split("x"))
    mesh = mt.synth.build_voronoi_mesh(args.synthetic, jitter=0.05)
    raw = mt.synth.solid_body_fields(mesh, n_layers=20)

    app = api.MOPSApp()
    app.init(precision="fp64")
    app.begin()
    app.add_grid(mesh)
    app.add_solution(1, raw)
    app.end()
    app.active_attribute(1)

    cfg = mt.VisualizationSettings(image_width=w, image_height=h,
                                   fixed_depth=args.depth)
    imgs = app.run_remapping(cfg)
    imgio.save_image_channels_png(args.out, imgs[0], ("east", "north", "speed"))
    imgio.save_vti(args.out + ".vti", imgs, ["velocity", "attrs"][:len(imgs)])
    print(f"wrote {w}x{h} remap to {args.out}_*.png / {args.out}.vti")


if __name__ == "__main__":
    main()
