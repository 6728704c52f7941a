"""Interpolation kernels: Wachspress, triangle barycentric, MPAS RBF.

Re-derivations of the reference math (reference src/Utils/Interpolation.hpp) as
vectorized, mask-aware JAX functions.  Scalar VLA loops become padded-lane
arithmetic; per-(cell,layer) Gauss elimination becomes a batched linear solve.
"""

from __future__ import annotations

import jax.numpy as jnp

from .config import HIGHEST


def triangle_area(a, b, c):
    """0.5 * |cross(b-a, c-a)| (reference Interpolation.hpp:95-110)."""
    return 0.5 * jnp.linalg.norm(jnp.cross(b - a, c - a), axis=-1)


def wachspress_weights(p, poly, n_valid):
    """Generalized barycentric (Wachspress) weights on a spherical polygon.

    Mirrors Interpolator::CalcPolygonWachspress (reference
    src/Utils/Interpolation.hpp:137-165): w_i = B_i / (A_i * A_{i+1}) over
    triangle areas, then normalized.

    Args:
      p: (..., 3) evaluation point.
      poly: (..., K, 3) padded polygon vertices (lanes >= n_valid are ignored).
      n_valid: (...,) int, number of real vertices N.

    Returns:
      (..., K) weights; padded lanes are exactly zero.
    """
    K = poly.shape[-2]
    lane = jnp.arange(K)
    n = n_valid[..., None]
    valid = lane < n
    # circular prev/next among the first N lanes: static rolls + one-lane
    # fixups instead of per-lane dynamic gathers.
    v_i = poly
    rolled_next = jnp.roll(poly, -1, axis=-2)        # lane i -> poly[i+1 mod K]
    v_next = jnp.where((lane == n - 1)[..., None], poly[..., :1, :], rolled_next)
    rolled_prev = jnp.roll(poly, 1, axis=-2)         # lane i -> poly[i-1 mod K]
    v_last = jnp.sum(jnp.where((lane == n - 1)[..., None], poly, 0.0),
                     axis=-2, keepdims=True)         # one-hot select, no gather
    v_prev = jnp.where((lane == 0)[..., None], v_last, rolled_prev)

    p_b = p[..., None, :]
    # A_i  = area(poly[i-1], poly[i], p);  A_{i+1} = area(poly[i], poly[i+1], p)
    area_next = triangle_area(v_i, v_next, p_b)          # A_{i+1} for lane i
    area_prev = triangle_area(v_prev, v_i, p_b)          # A_i for lane i
    b = triangle_area(v_prev, v_i, v_next)

    w = b / (area_prev * area_next)
    w = jnp.where(valid, w, 0.0)
    s = jnp.sum(w, axis=-1, keepdims=True)
    return w * (1.0 / s)


def triangle_barycentric(p, a, b, c):
    """(u, v, w) via the dot-product Cramer solve (reference Interpolation.hpp:79-93)."""
    v0 = b - a
    v1 = c - a
    v2 = p - a
    d00 = jnp.sum(v0 * v0, axis=-1)
    d01 = jnp.sum(v0 * v1, axis=-1)
    d11 = jnp.sum(v1 * v1, axis=-1)
    d20 = jnp.sum(v2 * v0, axis=-1)
    d21 = jnp.sum(v2 * v1, axis=-1)
    denom = d00 * d11 - d01 * d01
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    u = 1.0 - v - w
    return u, v, w


def evaluate_rbf(r_squared):
    """Inverse multiquadric phi(r^2) = 1/sqrt(1+r^2) (reference Interpolation.hpp:169-172)."""
    return 1.0 / jnp.sqrt(1.0 + r_squared)


def rbf_plane_coefficients(source_points, unit_vectors, destination_point,
                           alpha, plane_basis, valid):
    """RBF reconstruction coefficients for constant-directional plane interpolation.

    Batched re-derivation of
    Interpolator::mpas_rbf_interp_func_3D_plane_vec_const_dir_comp_coeffs
    (reference src/Utils/Interpolation.hpp:234-340).  The per-cell double Gauss
    elimination becomes one batched ``jnp.linalg.solve`` with a 2-column RHS.

    Reference quirk preserved: the RHS uses ``evaluate_rbf(1.0)`` -- a constant
    1/sqrt(2) -- instead of the destination distance (Interpolation.hpp:300).

    Args:
      source_points: (..., K, 3) edge midpoints (padded).
      unit_vectors:  (..., K, 3) edge normals (padded).
      destination_point: (..., 3) cell center.
      alpha: scalar RBF length scale (the reference hard-codes 1.0).
      plane_basis: (..., 2, 3) local tangent-plane basis (east, north).
      valid: (..., K) bool mask of real edges.

    Returns:
      (..., K, 3) coefficients; invalid lanes are zero.
    """
    # Project onto the tangent plane.
    ps = jnp.einsum("...kd,...bd->...kb", source_points, plane_basis,
                    precision=HIGHEST)                       # (...,K,2)
    pu = jnp.einsum("...kd,...bd->...kb", unit_vectors, plane_basis,
                    precision=HIGHEST)                       # (...,K,2)

    diff = ps[..., :, None, :] - ps[..., None, :, :]
    r2 = jnp.sum(diff * diff, axis=-1) / (alpha * alpha)
    phi = evaluate_rbf(r2)
    dots = jnp.einsum("...ib,...jb->...ij", pu, pu, precision=HIGHEST)
    a_mat = phi * dots

    # Mask out padded lanes: identity rows/cols with zero RHS keep the solve
    # well-posed and produce zero coefficients for missing edges.
    vmask = valid[..., :, None] & valid[..., None, :]
    K = a_mat.shape[-1]
    eye = jnp.eye(K, dtype=a_mat.dtype)
    a_mat = jnp.where(vmask, a_mat, eye)

    rbf_dest = evaluate_rbf(jnp.asarray(1.0, a_mat.dtype))
    rhs = rbf_dest * pu                                  # (..., K, 2)
    rhs = jnp.where(valid[..., None], rhs, 0.0)

    x = jnp.linalg.solve(a_mat, rhs)                     # (..., K, 2)
    coeffs = jnp.einsum("...kb,...bd->...kd", x, plane_basis,
                        precision=HIGHEST)
    return jnp.where(valid[..., None], coeffs, 0.0)
