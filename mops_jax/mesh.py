"""MPAS-Ocean mesh container: struct-of-arrays, 0-based, rectangular-padded.

Re-design of the reference MPASOGrid (reference
src/Core/MPASOGrid.h:48-116): instead of 1-based flat ``std::vector<size_t>``
connectivity with "subtract 1 at gather time", all index arrays are normalized
once at ingest to 0-based int32 with -1 marking missing entries.  All arrays
are rectangular so every downstream op is a plain gather.

Sentinel convention: any raw MPAS id outside [1, n] (0 = missing, or the
n+1 "land" sentinel some meshes use) becomes -1.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import numpy as np


def _normalize_connectivity(raw: np.ndarray, n_valid_targets: int) -> np.ndarray:
    """1-based raw MPAS connectivity -> 0-based int64->int32 with -1 sentinel."""
    arr = np.asarray(raw, dtype=np.int64)
    out = arr - 1
    out[(arr < 1) | (arr > n_valid_targets)] = -1
    return out.astype(np.int32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MPASMesh:
    """Static horizontal mesh. All jnp/np arrays; sizes derived from shapes.

    Shapes:
      cell_xyz:          (nCells, 3)   float
      vertex_xyz:        (nVertices, 3)
      edge_xyz:          (nEdges, 3)
      n_edges_on_cell:   (nCells,)     int32
      vertices_on_cell:  (nCells, maxEdges) int32, -1 padded
      cells_on_cell:     (nCells, maxEdges) int32, -1 padded/missing
      cells_on_vertex:   (nVertices, 3)     int32, -1 missing
      edges_on_cell:     (nCells, maxEdges) int32, -1 padded
      cells_on_edge:     (nEdges, 2)        int32, -1 missing
      vertices_on_edge:  (nEdges, 2)        int32, -1 missing
      ref_bottom_depth:  (nVertLevels,) or None
    """

    cell_xyz: jax.Array
    vertex_xyz: jax.Array
    edge_xyz: jax.Array
    n_edges_on_cell: jax.Array
    vertices_on_cell: jax.Array
    cells_on_cell: jax.Array
    cells_on_vertex: jax.Array
    edges_on_cell: jax.Array
    cells_on_edge: jax.Array
    vertices_on_edge: jax.Array
    ref_bottom_depth: Optional[jax.Array] = None
    name: str = dataclasses.field(default="mesh", metadata=dict(static=True))

    @property
    def n_cells(self) -> int:
        return self.cell_xyz.shape[0]

    @property
    def n_vertices(self) -> int:
        return self.vertex_xyz.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edge_xyz.shape[0]

    @property
    def max_edges(self) -> int:
        return self.vertices_on_cell.shape[1]

    def validate(self) -> None:
        """Structural invariants (mirrors MPASOGrid::checkAttribute,
        reference src/Core/MPASOGrid.cpp:516-599)."""
        nc, nv, ne, me = self.n_cells, self.n_vertices, self.n_edges, self.max_edges
        assert self.n_edges_on_cell.shape == (nc,)
        assert self.vertices_on_cell.shape == (nc, me)
        assert self.cells_on_cell.shape == (nc, me)
        assert self.cells_on_vertex.shape == (nv, 3)
        voc = np.asarray(self.vertices_on_cell)
        assert voc.max() < nv and voc.min() >= -1
        cov = np.asarray(self.cells_on_vertex)
        assert cov.max() < nc and cov.min() >= -1
        neoc = np.asarray(self.n_edges_on_cell)
        assert (neoc >= 1).all() and (neoc <= me).all()

    @classmethod
    def from_raw(cls,
                 cell_xyz: np.ndarray,
                 vertex_xyz: np.ndarray,
                 edge_xyz: np.ndarray,
                 n_edges_on_cell: np.ndarray,
                 vertices_on_cell_1based: np.ndarray,
                 cells_on_cell_1based: np.ndarray,
                 cells_on_vertex_1based: np.ndarray,
                 edges_on_cell_1based: np.ndarray,
                 cells_on_edge_1based: np.ndarray,
                 vertices_on_edge_1based: np.ndarray,
                 ref_bottom_depth: Optional[np.ndarray] = None,
                 name: str = "mesh",
                 dtype=np.float64) -> "MPASMesh":
        """Build from raw (1-based, as stored in MPAS NetCDF) arrays."""
        n_cells = int(np.asarray(cell_xyz).shape[0])
        n_vertices = int(np.asarray(vertex_xyz).shape[0])
        n_edges = int(np.asarray(edge_xyz).shape[0])
        me = int(np.asarray(vertices_on_cell_1based).reshape(n_cells, -1).shape[1])
        return cls(
            cell_xyz=np.asarray(cell_xyz, dtype=dtype).reshape(n_cells, 3),
            vertex_xyz=np.asarray(vertex_xyz, dtype=dtype).reshape(n_vertices, 3),
            edge_xyz=np.asarray(edge_xyz, dtype=dtype).reshape(n_edges, 3),
            n_edges_on_cell=np.asarray(n_edges_on_cell, dtype=np.int32).reshape(n_cells),
            vertices_on_cell=_normalize_connectivity(
                np.asarray(vertices_on_cell_1based).reshape(n_cells, me), n_vertices),
            cells_on_cell=_normalize_connectivity(
                np.asarray(cells_on_cell_1based).reshape(n_cells, me), n_cells),
            cells_on_vertex=_normalize_connectivity(
                np.asarray(cells_on_vertex_1based).reshape(n_vertices, 3), n_cells),
            edges_on_cell=_normalize_connectivity(
                np.asarray(edges_on_cell_1based).reshape(n_cells, me), n_edges),
            cells_on_edge=_normalize_connectivity(
                np.asarray(cells_on_edge_1based).reshape(n_edges, 2), n_cells),
            vertices_on_edge=_normalize_connectivity(
                np.asarray(vertices_on_edge_1based).reshape(n_edges, 2), n_vertices),
            ref_bottom_depth=(None if ref_bottom_depth is None
                              else np.asarray(ref_bottom_depth, dtype=dtype)),
            name=name,
        )

    def astype(self, dtype) -> "MPASMesh":
        """Cast float arrays (for fp32 fast mode); index arrays unchanged."""
        return dataclasses.replace(
            self,
            cell_xyz=self.cell_xyz.astype(dtype),
            vertex_xyz=self.vertex_xyz.astype(dtype),
            edge_xyz=self.edge_xyz.astype(dtype),
            ref_bottom_depth=(None if self.ref_bottom_depth is None
                              else self.ref_bottom_depth.astype(dtype)),
        )
