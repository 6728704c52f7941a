"""Image + VTK-style output writers.

Mirrors the reference outputs: PNG via min-max normalize -> Viridis with
NaN -> transparent (reference src/Common/ImageBuffer.hpp:10-137 SaveToPNG),
VTI ImageData XML (reference src/IO/VTKFileManager.hpp SaveVTI), and VTP
PolyData trajectory polylines with velocity/temperature/salinity point data
(SaveTrajectoryLinesAsVTP, VTKFileManager.hpp:25-416).  Writers emit plain
ASCII VTK XML readable by ParaView without a VTK dependency.
"""

from __future__ import annotations

import base64
import struct
from typing import List, Sequence

import numpy as np

from ..settings import TrajectoryLine


def save_png(path: str, channel: np.ndarray) -> None:
    """Save one scalar channel as a viridis PNG; NaN pixels transparent.

    Matches ImageBuffer::SaveToPNG's min-max normalization
    (reference src/Common/ImageBuffer.hpp:70-137).  Needs matplotlib and
    Pillow; VTI output needs neither."""
    try:
        from matplotlib import cm
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("PNG output needs matplotlib and Pillow "
                           f"({e}); write VTI instead") from e

    data = np.asarray(channel, dtype=np.float64)
    mask = np.isfinite(data)
    lo = np.nanmin(data) if mask.any() else 0.0
    hi = np.nanmax(data) if mask.any() else 1.0
    norm = (data - lo) / (hi - lo) if hi > lo else np.zeros_like(data)
    rgba = cm.viridis(np.where(mask, norm, 0.0))
    rgba[..., 3] = np.where(mask, 1.0, 0.0)
    img = Image.fromarray((rgba * 255).astype(np.uint8), mode="RGBA")
    img.save(path)


def save_image_channels_png(prefix: str, image: np.ndarray,
                            names: Sequence[str] = ("c0", "c1", "c2")) -> List[str]:
    """Save each channel of an (h, w, 3) image as <prefix>_<name>.png."""
    paths = []
    for k, name in enumerate(names[:image.shape[-1]]):
        p = f"{prefix}_{name}.png"
        save_png(p, image[..., k])
        paths.append(p)
    return paths


def _ascii(arr: np.ndarray) -> str:
    return " ".join(f"{v:.9g}" for v in np.asarray(arr, dtype=np.float64).ravel())


def save_vti(path: str, images: Sequence[np.ndarray],
             names: Sequence[str] = None) -> None:
    """Write (h, w, C) images as a VTK ImageData (.vti) XML file.

    Mirrors VTKFileManager::SaveVTI's channel grouping
    (reference src/IO/VTKFileManager.hpp:25-200): each image becomes one
    3-component point-data array."""
    h, w = images[0].shape[:2]
    names = names or [f"img{i}" for i in range(len(images))]
    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="ImageData" version="1.0" '
                'byte_order="LittleEndian">\n')
        f.write(f'  <ImageData WholeExtent="0 {w - 1} 0 {h - 1} 0 0" '
                'Origin="0 0 0" Spacing="1 1 1">\n')
        f.write(f'    <Piece Extent="0 {w - 1} 0 {h - 1} 0 0">\n')
        f.write('      <PointData>\n')
        for img, name in zip(images, names):
            ncomp = img.shape[-1] if img.ndim == 3 else 1
            f.write(f'        <DataArray type="Float64" Name="{name}" '
                    f'NumberOfComponents="{ncomp}" format="ascii">\n')
            f.write("          " + _ascii(img) + "\n")
            f.write('        </DataArray>\n')
        f.write('      </PointData>\n')
        f.write('    </Piece>\n  </ImageData>\n</VTKFile>\n')


def save_trajectories_vtp(path: str, lines: List[TrajectoryLine]) -> None:
    """Write trajectory polylines as VTK PolyData (.vtp) with velocity,
    temperature and salinity point data (reference
    VTKFileManager::SaveTrajectoryLinesAsVTP, src/IO/VTKFileManager.hpp)."""
    points = np.concatenate([l.points for l in lines], axis=0)
    vel = np.concatenate([l.velocity for l in lines], axis=0)
    temp = np.concatenate([l.temperature for l in lines], axis=0)
    sal = np.concatenate([l.salinity for l in lines], axis=0)
    n_pts = points.shape[0]

    connectivity = np.arange(n_pts, dtype=np.int64)
    offsets = np.cumsum([len(l.points) for l in lines]).astype(np.int64)

    with open(path, "w") as f:
        f.write('<?xml version="1.0"?>\n')
        f.write('<VTKFile type="PolyData" version="1.0" '
                'byte_order="LittleEndian">\n  <PolyData>\n')
        f.write(f'    <Piece NumberOfPoints="{n_pts}" NumberOfLines="{len(lines)}">\n')
        f.write('      <Points>\n        <DataArray type="Float64" '
                'NumberOfComponents="3" format="ascii">\n')
        f.write("          " + _ascii(points) + "\n")
        f.write('        </DataArray>\n      </Points>\n')
        f.write('      <PointData>\n')
        for name, arr, ncomp in (("velocity", vel, 3),
                                 ("temperature", temp, 1),
                                 ("salinity", sal, 1)):
            f.write(f'        <DataArray type="Float64" Name="{name}" '
                    f'NumberOfComponents="{ncomp}" format="ascii">\n')
            f.write("          " + _ascii(arr) + "\n")
            f.write('        </DataArray>\n')
        f.write('      </PointData>\n')
        f.write('      <Lines>\n')
        f.write('        <DataArray type="Int64" Name="connectivity" '
                'format="ascii">\n          '
                + " ".join(str(v) for v in connectivity) + "\n")
        f.write('        </DataArray>\n')
        f.write('        <DataArray type="Int64" Name="offsets" '
                'format="ascii">\n          '
                + " ".join(str(v) for v in offsets) + "\n")
        f.write('        </DataArray>\n      </Lines>\n')
        f.write('    </Piece>\n  </PolyData>\n</VTKFile>\n')


def save_trajectories_text(path: str, lines: List[TrajectoryLine]) -> None:
    """Plain-text trajectory dump (one line per point: id x y z)."""
    with open(path, "w") as f:
        for line in lines:
            for p in line.points:
                f.write(f"{line.line_id} {p[0]:.9f} {p[1]:.9f} {p[2]:.9f}\n")


def export_pathline_binary(path: str, lines: List[TrajectoryLine]) -> None:
    """Binary pathline export for the deck.gl frontend viewer (reference
    tutorial/export_pathline_binary.py:26-108): int32 count, per-line int32
    npoints, float64 lat/lon pairs, float64 (u, v, speed) triples."""
    from .. import geo
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(lines)))
        for line in lines:
            f.write(struct.pack("<i", len(line.points)))
        for line in lines:
            lat, lon = geo.xyz_to_latlon_rad(np.asarray(line.points))
            ll = np.stack([np.rad2deg(np.asarray(lat)),
                           np.rad2deg(np.asarray(lon))], axis=-1)
            f.write(np.ascontiguousarray(ll, dtype="<f8").tobytes())
        for line in lines:
            v = np.asarray(line.velocity)
            spd = np.linalg.norm(v, axis=-1, keepdims=True)
            f.write(np.ascontiguousarray(
                np.concatenate([v[:, :2], spd], axis=1), dtype="<f8").tobytes())
