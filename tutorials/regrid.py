"""ReGrid tutorial: fixed-latitude depth/longitude cross-section.

Mirrors reference tutorial/reGrid.cpp (latitude 45 degrees, 720 x nVertLevels
section image).
"""

import argparse

import mops_jax as mt
from mops_jax import api
from mops_jax.io import image as imgio


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--synthetic", type=int, default=5000)
    ap.add_argument("--lat", type=float, default=45.0)
    ap.add_argument("--width", type=int, default=720)
    ap.add_argument("--out", default="regrid")
    args = ap.parse_args()

    mesh = mt.synth.build_voronoi_mesh(args.synthetic, jitter=0.05)
    raw = mt.synth.solid_body_fields(mesh, n_layers=20)

    app = api.MOPSApp()
    app.init(precision="fp64")
    app.begin()
    app.add_grid(mesh)
    app.add_solution(1, raw)
    app.end()
    app.active_attribute(1)

    cfg = mt.VisualizationSettings(image_width=args.width,
                                   image_height=raw["layerThickness"].shape[1],
                                   fixed_latitude=args.lat)
    img = app.run_regrid(cfg)
    imgio.save_image_channels_png(args.out, img, ("east", "north"))
    print(f"wrote fixed-latitude section to {args.out}_*.png")


if __name__ == "__main__":
    main()
