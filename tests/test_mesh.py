"""Synthetic mesh structure + connectivity normalization tests."""

import numpy as np

import mops_jax as mt


def test_mesh_structure(mesh):
    mesh.validate()
    # Euler characteristic of a spherical Voronoi tessellation (dual of a
    # triangulation): V - E + F = 2 with each vertex touching 3 cells.
    assert mesh.n_vertices - mesh.n_edges + mesh.n_cells == 2
    assert (np.asarray(mesh.cells_on_vertex) >= 0).all()


def test_vertices_ccw_orientation(mesh):
    """Every cell polygon must satisfy cross(A,B).center >= 0 for the
    reference containment test to accept the cell's own center."""
    voc = np.asarray(mesh.vertices_on_cell)
    nv = np.asarray(mesh.n_edges_on_cell)
    vx = np.asarray(mesh.vertex_xyz)
    cx = np.asarray(mesh.cell_xyz)
    for c in range(mesh.n_cells):
        n = nv[c]
        ids = voc[c, :n]
        a = vx[ids]
        b = vx[np.roll(ids, -1)]
        d = np.einsum("kd,d->k", np.cross(a, b), cx[c])
        assert (d > 0).all(), f"cell {c} not CCW"


def test_cells_on_cell_symmetry(mesh):
    coc = np.asarray(mesh.cells_on_cell)
    nv = np.asarray(mesh.n_edges_on_cell)
    for c in range(0, mesh.n_cells, 17):
        for k in range(nv[c]):
            nb = coc[c, k]
            if nb < 0:
                continue
            assert c in coc[nb, :nv[nb]], f"asymmetric adjacency {c}<->{nb}"


def test_connectivity_normalization_sentinels():
    raw = np.array([[1, 2, 0], [3, 99, 2]])   # 0 = missing, 99 out of range
    out = mt.mesh._normalize_connectivity(raw, 3)
    np.testing.assert_array_equal(out, [[0, 1, -1], [2, -1, 1]])


def test_land_mask_creates_boundary():
    m = mt.synth.build_voronoi_mesh(300, land_box=(-15, 15, -30, 30))
    assert m.n_cells < 300
    cov = np.asarray(m.cells_on_vertex)
    assert (cov < 0).any(), "land carving should leave boundary vertices"
    m.validate()


def test_cell_search_exact(mesh):
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(200, 3))
    pts = pts / np.linalg.norm(pts, axis=1, keepdims=True) * mt.EARTH_RADIUS
    search = mt.CellSearch(mesh)
    got = search.query(pts)
    cx = np.asarray(mesh.cell_xyz)
    expected = np.argmin(
        ((pts[:, None, :] - cx[None, :, :]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(got, expected)


def test_native_search_exact_including_poles(mesh):
    from mops_jax.native import NativeCellSearch
    xyz = np.asarray(mesh.cell_xyz)
    ns = NativeCellSearch(xyz)
    rng = np.random.default_rng(9)
    q = rng.normal(size=(5000, 3))
    q = q / np.linalg.norm(q, axis=1, keepdims=True) * mt.EARTH_RADIUS
    poles = np.array([[0.0, 0.0, mt.EARTH_RADIUS], [0.0, 0.0, -mt.EARTH_RADIUS]])
    q = np.concatenate([q, poles])
    got = ns.query(q)
    expected = np.argmin(((q[:, None] - xyz[None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(got, expected)


def test_bucket_grid_matches_kdtree(mesh):
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    pts = rng.normal(size=(500, 3))
    pts = pts / np.linalg.norm(pts, axis=1, keepdims=True) * mt.EARTH_RADIUS
    grid = mt.BucketGrid.build(mesh)
    got = np.asarray(grid.query(mesh, jnp.asarray(pts)))
    expected = mt.CellSearch(mesh).query(pts)
    assert (got == expected).mean() > 0.99
