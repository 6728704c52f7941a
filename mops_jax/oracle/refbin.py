"""Golden-trajectory harness around the *actual* reference TBB backend.

Builds ``golden/driver.cpp`` together with the unmodified reference sources
(/root/reference/src/CPU/TBB/*, src/Core/MPASOField.cpp) into a standalone
binary, feeds it mesh + raw solution arrays through a tagged binary file, and
returns the trajectories the reference's own compiled C++ produces.

This replaces the "builder-transcribed oracle" trust chain: tests comparing
mops_jax against :func:`run_reference` are comparing against reference code
compiled from /root/reference, not a re-reading of it.

The reference tree or a C++ toolchain may be absent (e.g. on a user install);
``available()`` gates the opt-in tests.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import struct
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

REPO_ROOT = Path(__file__).resolve().parents[2]
GOLDEN_DIR = REPO_ROOT / "golden"
BUILD_DIR = GOLDEN_DIR / "build"
REF_ROOT = Path(os.environ.get("MOPS_REFERENCE", "/root/reference"))

_REF_SOURCES = [
    "src/Core/MPASOField.cpp",
    "src/CPU/TBB/Kernel/MPASOVisualizerKernels.cpp",
    "src/CPU/TBB/Kernel/TBBKernel.cpp",
    "src/CPU/TBB/MPASOSolutionTBB.cpp",
]

_DEFINES = [
    "-DMOPS_USE_CPU=1", "-DMOPS_USE_TBB=1", "-DMOPS_USE_GPU=0",
    "-DMOPS_USE_SYCL=0", "-DMOPS_USE_CUDA=0", "-DMOPS_USE_HIP=0",
    "-D_DEBUG=0", "-DMOPS_VTK=0",
]

MAGIC = b"MOPSGLD1"
_F64, _I64 = 0, 1


def available() -> bool:
    return (REF_ROOT / _REF_SOURCES[1]).exists() and shutil.which("g++") is not None


def _source_digest() -> str:
    h = hashlib.sha256()
    shims = sorted((GOLDEN_DIR / "shim").rglob("*.h*"))
    for p in [GOLDEN_DIR / "driver.cpp"] + shims + [REF_ROOT / s for s in _REF_SOURCES]:
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_driver(force: bool = False) -> Path:
    """Compile (or reuse) the golden driver; returns the binary path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    binary = BUILD_DIR / "golden_driver"
    stamp = BUILD_DIR / "golden_driver.stamp"
    digest = _source_digest()
    if not force and binary.exists() and stamp.exists() and stamp.read_text() == digest:
        return binary
    cmd = (
        ["g++", "-O2", "-std=c++17",
         "-I", str(GOLDEN_DIR / "shim"),
         "-I", str(REF_ROOT / "src"),
         "-I", str(REF_ROOT / "include")]
        + _DEFINES
        + [str(GOLDEN_DIR / "driver.cpp")]
        + [str(REF_ROOT / s) for s in _REF_SOURCES]
        + ["-ltbb", "-o", str(binary)]
    )
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    stamp.write_text(digest)
    return binary


def write_tagged(path, entries: Dict[str, np.ndarray]) -> None:
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<q", len(entries)))
        for name, arr in entries.items():
            arr = np.asarray(arr)
            if arr.dtype.kind in "iub":
                arr = arr.astype(np.int64)
                dtype = _I64
            else:
                arr = arr.astype(np.float64)
                dtype = _F64
            raw = np.ascontiguousarray(arr).tobytes()
            nb = name.encode()
            f.write(struct.pack("<i", len(nb)))
            f.write(nb)
            f.write(struct.pack("<iq", dtype, arr.size))
            f.write(raw)


def read_tagged(path) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        assert f.read(8) == MAGIC, "bad magic"
        (n,) = struct.unpack("<q", f.read(8))
        for _ in range(n):
            (name_len,) = struct.unpack("<i", f.read(4))
            name = f.read(name_len).decode()
            dtype, count = struct.unpack("<iq", f.read(12))
            raw = f.read(count * 8)
            out[name] = np.frombuffer(
                raw, dtype=np.int64 if dtype == _I64 else np.float64).copy()
    return out


def _unnormalize(conn) -> np.ndarray:
    """0-based/-1-padded connectivity -> raw 1-based with 0 pad (the inverse
    of mesh._normalize_connectivity for in-range meshes)."""
    arr = np.asarray(conn, dtype=np.int64)
    return np.where(arr >= 0, arr + 1, 0)


def _mesh_tags(mesh) -> Dict[str, np.ndarray]:
    return {
        "nCells": np.array([mesh.n_cells]),
        "nEdges": np.array([mesh.n_edges]),
        "maxEdges": np.array([mesh.max_edges]),
        "nVertices": np.array([mesh.n_vertices]),
        "cellCoord": np.asarray(mesh.cell_xyz, dtype=np.float64).ravel(),
        "vertexCoord": np.asarray(mesh.vertex_xyz, dtype=np.float64).ravel(),
        "edgeCoord": np.asarray(mesh.edge_xyz, dtype=np.float64).ravel(),
        "verticesOnCell": _unnormalize(mesh.vertices_on_cell).ravel(),
        "cellsOnCell": _unnormalize(mesh.cells_on_cell).ravel(),
        "cellsOnVertex": _unnormalize(mesh.cells_on_vertex).ravel(),
        "edgesOnCell": _unnormalize(mesh.edges_on_cell).ravel(),
        "cellsOnEdge": _unnormalize(mesh.cells_on_edge).ravel(),
        "verticesOnEdge": _unnormalize(mesh.vertices_on_edge).ravel(),
        "numberVertexOnCell": np.asarray(mesh.n_edges_on_cell, dtype=np.int64),
        **({"cellRefBottomDepth": np.asarray(mesh.ref_bottom_depth, dtype=np.float64)}
           if mesh.ref_bottom_depth is not None else {}),
    }


def _solution_tags(prefix: str, raw: Dict[str, np.ndarray],
                   cell_ztop: np.ndarray,
                   velocity_scheme: int) -> Dict[str, np.ndarray]:
    n_cells, n_layers = np.asarray(cell_ztop).shape
    tags = {
        prefix + "cellZTop": np.asarray(cell_ztop, dtype=np.float64).ravel(),
    }
    w = raw.get("vertVelocityTop")
    if w is None:
        w = np.zeros((n_cells, n_layers + 1))
    tags[prefix + "cellVertVelocity"] = np.asarray(w, dtype=np.float64).ravel()
    if velocity_scheme == 1:
        tags[prefix + "cellNormalVelocity"] = \
            np.asarray(raw["normalVelocity"], dtype=np.float64).ravel()
    else:
        tags[prefix + "cellZonalVelocity"] = \
            np.asarray(raw["velocityZonal"], dtype=np.float64).ravel()
        tags[prefix + "cellMeridionalVelocity"] = \
            np.asarray(raw["velocityMeridional"], dtype=np.float64).ravel()
    reserved = {"layerThickness", "bottomDepth", "seaSurfaceHeight", "zTop",
                "velocityZonal", "velocityMeridional", "normalVelocity",
                "vertVelocityTop", "xtime", "zMid"}
    for k, v in raw.items():
        v = np.asarray(v)
        if k in reserved or v.ndim != 2 or v.shape != (n_cells, n_layers):
            continue
        tags[prefix + "attr:" + k] = v.astype(np.float64).ravel()
    return tags


def run_reference(mesh,
                  raw_front: Dict[str, np.ndarray],
                  cell_ztop_front: np.ndarray,
                  seeds: np.ndarray,
                  cells: np.ndarray,
                  settings,
                  raw_back: Optional[Dict[str, np.ndarray]] = None,
                  cell_ztop_back: Optional[np.ndarray] = None,
                  velocity_scheme: int = 0,
                  nan_cleanup: bool = False,
                  workdir: Optional[Path] = None) -> Dict[str, np.ndarray]:
    """Run the reference TBB StreamLine/PathLine on the given arrays.

    Returns dict with points (N, R, 3), velocities (N, R, 3), temperature,
    salinity (N, R), lastPoint (N, 3), depth (N,), lineIDs (N,) where R
    includes the seed point (reference TrajectoryLine layout).
    """
    from ..settings import CalcDirection, CalcMethod

    binary = build_driver()
    import tempfile
    ctx = tempfile.TemporaryDirectory() if workdir is None else None
    wd = Path(ctx.name) if ctx else Path(workdir)
    try:
        tags = _mesh_tags(mesh)
        tags["nVertLevels"] = np.array([np.asarray(cell_ztop_front).shape[1]])
        tags.update(_solution_tags("", raw_front, cell_ztop_front, velocity_scheme))
        mode = 0
        if raw_back is not None:
            mode = 1
            tags.update(_solution_tags(
                "back_", raw_back,
                cell_ztop_back if cell_ztop_back is not None else cell_ztop_front,
                velocity_scheme))
        tags["mode"] = np.array([mode])
        tags["velocity_scheme"] = np.array([velocity_scheme])
        tags["nan_cleanup"] = np.array([1 if nan_cleanup else 0])
        tags["deltaT"] = np.array([float(settings.delta_t)])
        tags["duration"] = np.array([float(settings.simulation_duration)])
        tags["recordT"] = np.array([float(settings.record_t)])
        tags["depth"] = np.array([float(settings.depth)])
        tags["direction"] = np.array(
            [0 if settings.direction == CalcDirection.FORWARD else 1])
        tags["method"] = np.array(
            [0 if settings.method == CalcMethod.RK4 else 1])
        if settings.particle_depths is not None:
            tags["particleDepths"] = np.asarray(
                settings.particle_depths, dtype=np.float64)
        tags["seeds"] = np.asarray(seeds, dtype=np.float64).ravel()
        tags["seedCells"] = np.asarray(cells, dtype=np.int64)

        in_path = wd / "in.bin"
        out_path = wd / "out.bin"
        write_tagged(in_path, tags)
        subprocess.run([str(binary), str(in_path), str(out_path)],
                       check=True, capture_output=True, text=True, timeout=600)
        out = read_tagged(out_path)
    finally:
        if ctx:
            ctx.cleanup()

    n_lines = int(out["nLines"][0])
    n_rec = int(out["nRecords"][0])
    return {
        "points": out["points"].reshape(n_lines, n_rec, 3),
        "velocities": out["velocities"].reshape(n_lines, n_rec, 3),
        "temperature": out["temperature"].reshape(n_lines, n_rec),
        "salinity": out["salinity"].reshape(n_lines, n_rec),
        "lastPoint": out["lastPoint"].reshape(n_lines, 3),
        "depth": out["depth"],
        "lineIDs": out["lineIDs"],
    }


VIZ_FIXED_LAYER, VIZ_FIXED_DEPTH, VIZ_FIXED_LATITUDE = 2, 3, 4
MODE_DUMP_PREPROCESS = 5


def run_reference_preprocess(mesh,
                             raw_front: Dict[str, np.ndarray],
                             cell_ztop_front: np.ndarray,
                             velocity_scheme: int = 0,
                             workdir: Optional[Path] = None) -> Dict[str, np.ndarray]:
    """Run ONLY the reference TBB preprocessing chain
    (/root/reference/src/CPU/TBB/MPASOSolutionTBB.cpp: CalcCellVertexZtop,
    CalcCellCenterVelocity[ByZM], CalcCellVertexVelocity,
    CalcCellVertexVertVelocity, CalcCellCenterToVertex) and return the
    derived fields: cellVertexZTop (nV, L), cellCenterVelocity (nC, L, 3),
    cellVertexVelocity (nV, L, 3), cellVertexVertVelocity (nV, L+1),
    ctov:<name> (nV, L)."""
    binary = build_driver()
    import tempfile
    ctx = tempfile.TemporaryDirectory() if workdir is None else None
    wd = Path(ctx.name) if ctx else Path(workdir)
    try:
        tags = _mesh_tags(mesh)
        L = np.asarray(cell_ztop_front).shape[1]
        tags["nVertLevels"] = np.array([L])
        tags.update(_solution_tags("", raw_front, cell_ztop_front, velocity_scheme))
        tags["mode"] = np.array([MODE_DUMP_PREPROCESS])
        tags["velocity_scheme"] = np.array([velocity_scheme])
        in_path = wd / "in.bin"
        out_path = wd / "out.bin"
        write_tagged(in_path, tags)
        subprocess.run([str(binary), str(in_path), str(out_path)],
                       check=True, capture_output=True, text=True, timeout=600)
        out = read_tagged(out_path)
    finally:
        if ctx:
            ctx.cleanup()
    nv = mesh.n_vertices
    nc = mesh.n_cells
    res = {
        "cellVertexZTop": out["cellVertexZTop"].reshape(nv, L),
        "cellCenterVelocity": out["cellCenterVelocity"].reshape(nc, L, 3),
        "cellVertexVelocity": out["cellVertexVelocity"].reshape(nv, L, 3),
        "cellVertexVertVelocity": out["cellVertexVertVelocity"].reshape(nv, L + 1),
    }
    for k, v in out.items():
        if k.startswith("ctov:"):
            res[k] = v.reshape(nv, L)
    return res


def run_reference_viz(mesh,
                      raw_front: Dict[str, np.ndarray],
                      cell_ztop_front: np.ndarray,
                      viz_mode: int,
                      cfg,
                      n_images: int = 1,
                      velocity_scheme: int = 0,
                      workdir: Optional[Path] = None) -> list:
    """Run a reference TBB visualizer kernel (VisualizeFixedLayer /
    VisualizeFixedDepth / VisualizeFixedLatitude,
    /root/reference/src/CPU/TBB/Kernel/MPASOVisualizerKernels.cpp:141-651)
    on the given arrays.

    ``cfg`` is a mops_jax VisualizationSettings.  Returns a list of
    (h, w, 4) RGBA-double images in the reference ImageBuffer layout
    (row i = height index, alpha untouched where the kernel early-returned).
    """
    binary = build_driver()
    import tempfile
    ctx = tempfile.TemporaryDirectory() if workdir is None else None
    wd = Path(ctx.name) if ctx else Path(workdir)
    try:
        tags = _mesh_tags(mesh)
        tags["nVertLevels"] = np.array([np.asarray(cell_ztop_front).shape[1]])
        tags.update(_solution_tags("", raw_front, cell_ztop_front, velocity_scheme))
        tags["mode"] = np.array([int(viz_mode)])
        tags["velocity_scheme"] = np.array([velocity_scheme])
        tags["imageWidth"] = np.array([cfg.image_width])
        tags["imageHeight"] = np.array([cfg.image_height])
        tags["latRange"] = np.asarray(cfg.lat_range, dtype=np.float64)
        tags["lonRange"] = np.asarray(cfg.lon_range, dtype=np.float64)
        if viz_mode == VIZ_FIXED_LAYER:
            tags["fixedLayer"] = np.array([float(cfg.fixed_layer)])
        elif viz_mode == VIZ_FIXED_DEPTH:
            # positive-down, negated by the kernel (fixed_depth = -FixedDepth,
            # reference MPASOVisualizerKernels.cpp:252)
            tags["fixedDepth"] = np.array([abs(float(cfg.fixed_depth))])
            tags["nImages"] = np.array([int(n_images)])
        else:
            tags["fixedLatitude"] = np.array([float(cfg.fixed_latitude)])

        in_path = wd / "in.bin"
        out_path = wd / "out.bin"
        write_tagged(in_path, tags)
        subprocess.run([str(binary), str(in_path), str(out_path)],
                       check=True, capture_output=True, text=True, timeout=600)
        out = read_tagged(out_path)
    finally:
        if ctx:
            ctx.cleanup()

    w = int(out["imageWidth"][0])
    h = int(out["imageHeight"][0])
    n = int(out["nImages"][0])
    return [out[f"image{k}"].reshape(h, w, 4) for k in range(n)]
