"""Interpolation kernel tests vs scalar oracle implementations."""

import numpy as np
import jax.numpy as jnp

from mops_jax import interp
from mops_jax.oracle.oracle import _wachspress, _barycentric


def _regular_polygon(n, radius=1.0):
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([radius * np.cos(ang), radius * np.sin(ang),
                     np.ones(n)], axis=-1)


def test_wachspress_matches_oracle_and_partition_of_unity():
    rng = np.random.default_rng(1)
    for n in (5, 6, 7):
        poly = _regular_polygon(n) + rng.normal(scale=0.05, size=(n, 3))
        p = poly.mean(axis=0) + rng.normal(scale=0.05, size=3)
        w_oracle = _wachspress(p, poly)
        K = 8
        poly_pad = np.zeros((K, 3))
        poly_pad[:n] = poly
        w_jax = np.asarray(interp.wachspress_weights(
            jnp.asarray(p), jnp.asarray(poly_pad), jnp.asarray(n)))
        np.testing.assert_allclose(w_jax[:n], w_oracle, rtol=1e-12)
        assert (w_jax[n:] == 0).all()
        np.testing.assert_allclose(w_jax.sum(), 1.0, rtol=1e-12)


def test_wachspress_vertex_interpolates_linear_function():
    # Wachspress coordinates reproduce linear functions on convex polygons.
    poly = _regular_polygon(6)
    p = np.array([0.2, 0.1, 1.0])
    w = _wachspress(p, poly)
    f = poly @ np.array([1.0, 2.0, 3.0])
    np.testing.assert_allclose(w @ f, p @ np.array([1.0, 2.0, 3.0]), rtol=1e-10)


def test_barycentric_matches_oracle():
    a, b, c = np.array([0.0, 0, 0]), np.array([1.0, 0, 0]), np.array([0.0, 1, 0])
    p = np.array([0.25, 0.5, 0.0])
    u, v, w = interp.triangle_barycentric(jnp.asarray(p), jnp.asarray(a),
                                          jnp.asarray(b), jnp.asarray(c))
    uo, vo, wo = _barycentric(p, a, b, c)
    np.testing.assert_allclose([float(u), float(v), float(w)], [uo, vo, wo],
                               atol=1e-14)
    np.testing.assert_allclose(float(u) * a + float(v) * b + float(w) * c, p,
                               atol=1e-14)


def test_rbf_reconstructs_constant_tangent_field():
    """An RBF reconstruction from edge normals of a constant velocity field
    returns that velocity SCALED BY 1/sqrt(2): the reference rhs uses
    evaluate_rbf(1.0) instead of the destination distance
    (Interpolation.hpp:300), a quirk preserved for parity."""
    n = 6
    center = np.array([0.0, 0.0, 1.0])
    east = np.array([1.0, 0.0, 0.0])
    north = np.array([0.0, 1.0, 0.0])
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False) + 0.3
    edge_pts = center[None, :] + 0.01 * (np.cos(ang)[:, None] * east
                                         + np.sin(ang)[:, None] * north)
    normals = (np.cos(ang)[:, None] * east + np.sin(ang)[:, None] * north)
    v_true = 0.3 * east - 0.2 * north
    normal_vel = normals @ v_true

    K = 8
    sp = np.zeros((K, 3)); sp[:n] = edge_pts
    uv = np.zeros((K, 3)); uv[:n] = normals
    valid = np.zeros(K, dtype=bool); valid[:n] = True
    basis = np.stack([east, north])
    coeffs = np.asarray(interp.rbf_plane_coefficients(
        jnp.asarray(sp), jnp.asarray(uv), jnp.asarray(center), 1.0,
        jnp.asarray(basis), jnp.asarray(valid)))
    v_rec = (coeffs[:n] * normal_vel[:, None]).sum(axis=0)
    # rtol ~ phi(r_dest^2) deviation from 1 at the 0.01 source spacing
    np.testing.assert_allclose(v_rec, v_true / np.sqrt(2.0),
                               rtol=1e-3, atol=1e-12)
