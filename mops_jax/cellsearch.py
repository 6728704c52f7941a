"""Initial particle -> cell assignment.

The reference builds a nanoflann KD-tree over cell centers and queries it
serially on the host at seed time and per remap pixel (reference
src/Core/MPASOGrid.cpp:247-313, src/GPU/SYCL/Kernel/SYCLKernel.cpp:5-22).
Here the host path uses scipy's cKDTree (same exact-L2 1-NN answers), and a
device-friendly coarse lat-lon bucket grid provides an in-jit search for
pipelines that must stay on-device (e.g. reseeding inside a scan).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from scipy.spatial import cKDTree

from .mesh import MPASMesh


class CellSearch:
    """Exact 1-NN cell lookup over cell centers (host path).

    Prefers the native C++ bucket grid (mops_jax.native, ~2x faster than
    cKDTree and parallel), falling back to scipy's cKDTree -- both give the
    exact nearest neighbor, matching nanoflann's answers
    (reference src/Core/MPASOGrid.cpp:247-313)."""

    def __init__(self, mesh: MPASMesh, prefer_native: bool = True,
                 cache_dir: str = None):
        xyz = np.asarray(mesh.cell_xyz, dtype=np.float64)
        self._native = None
        self._tree = None
        if prefer_native:
            try:
                from .native import NativeCellSearch
                self._native = NativeCellSearch(xyz)
            except Exception:
                self._native = None
        if self._native is None:
            # cKDTree fallback: persist the built tree like the reference's
            # KDTree.bin (src/Core/MPASOGrid.cpp:247-285) -- the build is the
            # slow part at multi-million-cell meshes
            self._tree = self._load_or_build_tree(xyz, cache_dir)

    @staticmethod
    def _load_or_build_tree(xyz: np.ndarray, cache_dir):
        import hashlib
        import pickle
        path = None
        if cache_dir:
            import os
            key = hashlib.sha1(
                np.ascontiguousarray(xyz[:: max(1, len(xyz) // 64)])
                .tobytes() + str(xyz.shape).encode()).hexdigest()[:16]
            path = os.path.join(cache_dir, f"kdtree_{key}.pkl")
            if os.path.exists(path):
                try:
                    with open(path, "rb") as f:
                        return pickle.load(f)
                except Exception:
                    pass
        tree = cKDTree(xyz)
        if path:
            try:
                import os
                os.makedirs(cache_dir, exist_ok=True)
                with open(path, "wb") as f:
                    pickle.dump(tree, f)
            except Exception:
                pass
        return tree

    def query(self, points: np.ndarray) -> np.ndarray:
        """(N, 3) XYZ -> (N,) nearest cell ids (int32).

        Equivalent to MPASOGrid::searchKDT + MPASOField::calcInWhichCells
        (reference src/Core/MPASOField.cpp:23-34)."""
        pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
        if self._native is not None:
            return self._native.query(pts)
        _, idx = self._tree.query(pts, k=1)
        return idx.astype(np.int32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BucketGrid:
    """Coarse lat-lon bucket grid for on-device approximate-to-exact search.

    Build once on host: every bucket stores up to ``depth`` candidate cells
    covering it (cells whose center falls in the bucket or its 8 neighbors).
    Query: bucket lookup -> argmin distance over candidates -> one
    neighbor-walk refinement pass.  For any point whose true nearest cell
    center lies within the bucket neighborhood this is exact; the walk fixes
    stragglers near bucket borders.
    """

    table: jax.Array      # (n_lat * n_lon, depth) int32 candidate cells, -1 pad
    n_lat: int = dataclasses.field(metadata=dict(static=True))
    n_lon: int = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def build(mesh: MPASMesh, n_lat: int = 0, n_lon: int = 0,
              depth: int = 24) -> "BucketGrid":
        cx = np.asarray(mesh.cell_xyz, dtype=np.float64)
        if n_lat <= 0:
            # ~20 cells per bucket so no 3x3 neighborhood is ever empty
            n_lat = max(4, int(np.sqrt(cx.shape[0] / 20)))
            n_lon = 2 * n_lat
        r = np.linalg.norm(cx, axis=1)
        lat = np.arcsin(np.clip(cx[:, 2] / r, -1, 1))
        lon = np.arctan2(cx[:, 1], cx[:, 0])
        li = np.clip(((lat + np.pi / 2) / np.pi * n_lat).astype(int), 0, n_lat - 1)
        lj = np.clip(((lon + np.pi) / (2 * np.pi) * n_lon).astype(int), 0, n_lon - 1)

        buckets: list[list[int]] = [[] for _ in range(n_lat * n_lon)]
        for cid in range(cx.shape[0]):
            for di in (-1, 0, 1):
                bi = li[cid] + di
                if bi < 0 or bi >= n_lat:
                    continue
                for dj in (-1, 0, 1):
                    bj = (lj[cid] + dj) % n_lon
                    buckets[bi * n_lon + bj].append(cid)

        max_fill = max(len(b) for b in buckets)
        depth = max(depth, max_fill)
        table = np.full((n_lat * n_lon, depth), -1, dtype=np.int32)
        for b, cells in enumerate(buckets):
            table[b, :len(cells)] = cells[:depth]
        return BucketGrid(table=jnp.asarray(table), n_lat=n_lat, n_lon=n_lon)

    def query(self, mesh: MPASMesh, points: jax.Array,
              refine_steps: int = 2) -> jax.Array:
        """(N, 3) -> (N,) cell ids; jit-compatible."""
        p = points
        r = jnp.linalg.norm(p, axis=-1)
        lat = jnp.arcsin(jnp.clip(p[:, 2] / r, -1, 1))
        lon = jnp.arctan2(p[:, 1], p[:, 0])
        li = jnp.clip(((lat + jnp.pi / 2) / jnp.pi * self.n_lat).astype(jnp.int32),
                      0, self.n_lat - 1)
        lj = jnp.clip(((lon + jnp.pi) / (2 * jnp.pi) * self.n_lon).astype(jnp.int32),
                      0, self.n_lon - 1)
        cand = self.table[li * self.n_lon + lj]            # (N, depth)
        valid = cand >= 0
        d2 = jnp.sum((mesh.cell_xyz[jnp.clip(cand, 0)] - p[:, None, :]) ** 2,
                     axis=-1)
        d2 = jnp.where(valid, d2, jnp.inf)
        cell = jnp.take_along_axis(cand, jnp.argmin(d2, axis=1)[:, None],
                                   axis=1)[:, 0]
        # neighbor-walk refinement (same move as the advection relocation)
        from .advect import _relocate
        for _ in range(refine_steps):
            cell = _relocate(mesh, p, cell)
        return cell
