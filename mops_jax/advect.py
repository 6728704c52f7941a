"""Streamline / pathline advection: vmapped particles, lax.scan over steps.

Re-design of the reference trajectory kernels as batched JAX
(reference src/GPU/SYCL/MPASOVisualizerSYCL.cpp:669-1194 StreamLine,
:1221-1917 PathLine; scalar semantics per the CPU backend
src/CPU/TBB/Kernel/MPASOVisualizerKernels.cpp:668-1496, which is the golden
baseline).  Every per-particle branch (containment test, layer search, zero
-velocity early exits, neighbor-walk cell relocation) becomes masked/select
arithmetic so one XLA program advances the whole particle batch per step.

Step pipeline (one lax.scan iteration):
  relocate -> gather cell vertex data once (shared by all RK stages)
  -> per-stage: Wachspress weights, ztop profile + monotonic clamp,
     layer search, vertical lerp of velocity / vertical-velocity / attrs
  -> RK4 or Euler position update on the sphere -> depth/radius update
  -> strided record into the (N, R, 3) output buffers.

Exact-parity quirks preserved (see SURVEY.md section 7.0): cell relocation once
per outer step with the cell id frozen across RK stages; ztop monotonic clamp
z[k] -> z[k-1] - 1e-9; streamline binary layer search vs pathline linear scan;
zero-velocity guards at 1e-12; RK4 endpoint renormalized to the pre-step
radius; depth (positive down) decremented while radius is incremented by w*dt;
particle depth carried as float32 like the reference's effective_depths.
Unlike the reference, a position is carried with a rounding residual
(_compensated_add), so float32 steps of a few metres are not lost to the
~0.5 m spacing of float32 at Earth radius.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from . import geo
from .config import EPS_LAYER, EPS_ZERO, HIGHEST, ZTOP_CLAMP
from .interp import wachspress_weights
from .mesh import MPASMesh
from .settings import CalcDirection, CalcMethod, FailMode, TrajectorySettings
from .solution import SolutionFields


# ---------------------------------------------------------------------------
# geometry helpers (full-batch)
# ---------------------------------------------------------------------------

def _gather_cell_vertices(mesh: MPASMesh, cell: jax.Array):
    """vids, nv, lane_valid, vids_ok, vpos for each particle's current cell."""
    vids_raw = mesh.vertices_on_cell[cell]               # (N, K)
    nv = mesh.n_edges_on_cell[cell]                      # (N,)
    K = vids_raw.shape[1]
    lane = jnp.arange(K)[None, :]
    lane_valid = lane < nv[:, None]
    vids_ok = jnp.all(jnp.where(lane_valid, vids_raw >= 0, True), axis=1)
    vids = jnp.clip(vids_raw, 0)
    vpos = mesh.vertex_xyz[vids]                         # (N, K, 3)
    return vids, nv, lane_valid, vids_ok, vpos


def _in_mesh(pos: jax.Array, vpos: jax.Array, nv: jax.Array,
             lane_valid: jax.Array, slack: bool = False) -> jax.Array:
    """Spherical point-in-polygon (reference SYCLKernel::IsInMesh,
    src/GPU/SYCL/Kernel/SYCLKernel.cpp:41-76): inside iff
    cross(A_k, B_k) . p >= 0 for every edge; non-finite p -> outside.
    Edge partner B via a static roll + one-lane fixup (gather-free).

    The triple product is evaluated as cross(A - p, B - p) . p, which is
    the same number: A x B of two nearly parallel Earth-radius vectors
    cancels, and in float32 its rounding misplaces the edge by ~100 m.

    ``slack`` also counts a point within 4 float32 eps |p| (~3 m) of an
    edge as inside.  It is for a particle's own position, which the
    nearest-centre relocation has put in this cell: rounding a mesh to
    float32 moves its polygons' edges off the bisectors between cell
    centres by up to ~0.4 m, and a particle in that gap would fail every
    later step, stalled, whatever precision the step runs in.  RK stage
    points keep the exact test, as the reference does."""
    K = vpos.shape[1]
    lane = jnp.arange(K)[None, :]
    rolled = jnp.roll(vpos, -1, axis=1)
    b = jnp.where((lane == nv[:, None] - 1)[..., None], vpos[:, :1, :], rolled)
    p = pos[:, None, :]
    direction = jnp.sum(jnp.cross(vpos - p, b - p) * p, axis=-1)
    # direction ~ (signed distance of p from the edge's plane) * |B-A| * |p|
    bound = 0.0
    if slack:
        r2 = jnp.sum(pos * pos, axis=-1)[:, None]
        bound = -4.0 * float(jnp.finfo(jnp.float32).eps) * r2 \
            * jnp.linalg.norm(b - vpos, axis=-1)
    inside = jnp.all(jnp.where(lane_valid, direction >= bound, True), axis=1)
    finite = jnp.all(jnp.isfinite(pos), axis=-1)
    return finite & inside


def build_reloc_xyz(mesh: MPASMesh) -> jax.Array:
    """(nC, K+1, 3) candidate positions for the relocation argmin: lanes
    0..K-1 = cellsOnCell neighbor centers (+inf where the neighbor is absent
    or out of range, so its distance is +inf), lane K = the cell's own
    center.  Precomputing the neighbor coordinates turns the per-step
    two-level gather cell_xyz[cells_on_cell[cell]] into ONE row gather."""
    coc = mesh.cells_on_cell
    cx = mesh.cell_xyz
    valid = (coc >= 0) & (coc < mesh.n_cells)
    nb = jnp.where(valid[..., None], cx[jnp.clip(coc, 0, mesh.n_cells - 1)],
                   jnp.inf)
    return jnp.concatenate([nb, cx[:, None, :]], axis=1)


def _relocate_packed(mesh: MPASMesh, reloc_xyz: jax.Array,
                     pos: jax.Array, cell: jax.Array) -> jax.Array:
    """Argmin-over-{neighbors, self} from the precomputed candidate rows
    (build_reloc_xyz).  The candidate order (neighbors at lanes < nv, self
    at lane nv, rest invalid) and therefore the first-minimum tie-breaking
    is identical to GetCellNeighborsIdx (reference SYCLKernel.cpp:79-98)."""
    row = reloc_xyz[cell]                                # (N, K+1, 3)
    coc = mesh.cells_on_cell[cell]                       # (N, K)
    nv = mesh.n_edges_on_cell[cell]                      # (N,)
    K = row.shape[1] - 1
    lane = jnp.arange(K + 1)[None, :]
    d2 = jnp.sum((row - pos[:, None, :]) ** 2, axis=-1)  # (N, K+1)
    d2 = jnp.where(lane == nv[:, None], d2[:, K:],
                   jnp.where(lane >= nv[:, None], jnp.inf, d2))
    best = jnp.argmin(d2, axis=1)
    pick = jnp.sum(jnp.where(lane[:, :K] == best[:, None], coc, 0), axis=1,
                   dtype=coc.dtype)
    return jnp.where(best == nv, cell, pick)


def _relocate(mesh: MPASMesh, pos: jax.Array, cell: jax.Array) -> jax.Array:
    """Argmin-distance over {cellsOnCell(cell), cell} -- the reference's
    neighbor-walk relocation (TBB kernel :902-921), with self appended at lane
    nv exactly like GetCellNeighborsIdx (SYCLKernel.cpp:79-98) so first-minimum
    tie-breaking matches."""
    nv = mesh.n_edges_on_cell[cell]                      # (N,)
    coc = mesh.cells_on_cell[cell]                       # (N, K)
    lane = jnp.arange(coc.shape[1] + 1)[None, :]
    coc_ext = jnp.concatenate(
        [coc, jnp.full((coc.shape[0], 1), -1, dtype=coc.dtype)], axis=1)
    cand = jnp.where(lane == nv[:, None], cell[:, None], coc_ext)
    valid = (cand >= 0) & (cand < mesh.n_cells) & (lane <= nv[:, None])
    d2 = jnp.sum((mesh.cell_xyz[jnp.clip(cand, 0)] - pos[:, None, :]) ** 2,
                 axis=-1)
    d2 = jnp.where(valid, d2, jnp.inf)
    best = jnp.argmin(d2, axis=1)
    return jnp.sum(jnp.where(lane == best[:, None], cand, 0), axis=1,
                   dtype=cand.dtype)


def _advect_delta(pos: jax.Array, vel: jax.Array, dt):
    """Displacement of the RK mid-stage move (TBB advect_on_sphere, kernel
    :729-738): Rodrigues rotation by theta = |v| dt / |p|, none if |p| or
    |v| < 1e-12."""
    rr = jnp.linalg.norm(pos, axis=-1)
    speed = jnp.linalg.norm(vel, axis=-1)
    degenerate = (rr < EPS_ZERO) | (speed < EPS_ZERO)
    axis = jnp.cross(pos, vel)
    theta = speed * dt / jnp.where(rr == 0.0, 1.0, rr)
    safe_axis = jnp.where(degenerate[..., None],
                          jnp.array([1.0, 0.0, 0.0], dtype=pos.dtype), axis)
    delta = geo.rotation_delta(pos, safe_axis, theta)
    return jnp.where(degenerate[..., None], 0.0, delta)


def _advect_on_sphere(pos: jax.Array, vel: jax.Array, dt):
    """The RK mid-stage position (see _advect_delta)."""
    return pos + _advect_delta(pos, vel, dt)


def _sphere_delta(pos: jax.Array, disp: jax.Array, dr: jax.Array):
    """(pos + disp) scaled to radius |pos| + dr (at least 1 m), minus pos,
    formed without rounding pos + disp: at Earth radius a float32 position
    holds ~0.5 m, which a slow particle's 10-100 m step would otherwise
    lose in part on every step.  A degenerate |pos + disp| keeps the
    direction of pos."""
    r2 = jnp.sum(pos * pos, axis=-1)
    r = jnp.sqrt(r2)
    dr = jnp.maximum(1.0 - r, dr)
    r_new = r + dr
    pd = jnp.sum(pos * disp, axis=-1)
    dd = jnp.sum(disp * disp, axis=-1)
    x = jnp.sqrt(r2 + 2.0 * pd + dd)                     # |pos + disp|
    ok = x > EPS_ZERO
    x = jnp.where(ok, x, 1.0)
    # s - 1 for the scale s = r_new / x, from r_new^2 - x^2 without cancelling
    sm1 = (dr * (r_new + r) - 2.0 * pd - dd) / (x * (r_new + x))
    delta = disp + sm1[:, None] * (disp + pos)
    radial = pos * (dr / jnp.where(r == 0.0, 1.0, r))[:, None]
    return jnp.where(ok[:, None], delta, radial)


def _compensated_add(pos: jax.Array, lo: jax.Array, delta: jax.Array):
    """pos + lo + delta as a rounded position and its residual (Fast2Sum):
    the position a particle carries is pos + lo, so step increments far
    below pos's rounding still add up."""
    y = delta + lo
    t = pos + y
    return t, y - (t - pos)


# ---------------------------------------------------------------------------
# vertical column machinery
# ---------------------------------------------------------------------------

def _clamp_profile(z: jax.Array, exact: bool) -> jax.Array:
    """Monotonic ztop clamp z[k] = (z[k] > z'[k-1]) ? z'[k-1]-1e-9 : z[k]
    (reference kernel :861-867).  ``exact=False`` uses a parallel cummin form
    that differs from the sequential recurrence only by < 1e-9 m."""
    if exact:
        def f(prev, zk):
            out = jnp.where(zk > prev, prev - ZTOP_CLAMP, zk)
            return out, out
        z0 = z[:, 0]
        _, rest = jax.lax.scan(f, z0, jnp.moveaxis(z[:, 1:], 1, 0))
        return jnp.concatenate([z0[:, None], jnp.moveaxis(rest, 0, 1)], axis=1)
    idx = jnp.arange(z.shape[1], dtype=z.dtype) * ZTOP_CLAMP
    return jax.lax.cummin(z + idx[None, :], axis=1) - idx[None, :]


def _layer_search_binary(z: jax.Array, depth: jax.Array) -> jax.Array:
    """Streamline layer resolution (reference kernel :903-944): above surface
    -> 1, below bottom -> L-1, else the exact binary search (emulated with a
    fixed unrolled trip count and masks)."""
    L = z.shape[1]
    lane = jnp.arange(L)
    above = depth > z[:, 0] + EPS_LAYER
    below = depth < z[:, -1] - EPS_LAYER
    lo = jnp.ones(depth.shape, dtype=jnp.int32)
    hi = jnp.full_like(lo, L - 1)
    ans = jnp.ones_like(lo)
    found = jnp.zeros(depth.shape, dtype=bool)

    def pick(idx):
        # one-hot row select from the (N, L) profile
        return jnp.sum(jnp.where(lane[None, :] == idx[:, None], z, 0.0), axis=1)

    for _ in range(int(np.ceil(np.log2(max(2, L)))) + 2):
        active = (~found) & (lo <= hi)
        mid = (lo + hi) >> 1
        top_i = pick(mid - 1)
        bot_i = pick(mid)
        hit = (depth <= top_i + EPS_LAYER) & (depth >= bot_i - EPS_LAYER)
        ans = jnp.where(active & hit, mid, ans)
        found = found | (active & hit)
        go_up = depth > top_i + EPS_LAYER
        hi = jnp.where(active & ~hit & go_up, mid - 1, hi)
        lo = jnp.where(active & ~hit & ~go_up, mid + 1, lo)
    ans = jnp.clip(ans, 1, L - 1)
    return jnp.where(above, 1, jnp.where(below, L - 1, ans))


def _layer_search_linear(z: jax.Array, depth: jax.Array):
    """Pathline layer resolution (reference TBB kernel :1182-1222): above
    surface -> 0, below bottom -> L-1, else first k in [1, L-1] whose interval
    contains depth; none -> fail.

    Divergence from the reference (documented): layer 0 makes the reference
    read ztop[-1] (out of bounds, UB); here it is clamped to layer 1."""
    above = depth > z[:, 0] + EPS_LAYER
    below = depth < z[:, -1] - EPS_LAYER
    cond = (depth[:, None] <= z[:, :-1] + EPS_LAYER) & \
           (depth[:, None] >= z[:, 1:] - EPS_LAYER)          # k = 1..L-1
    found = jnp.any(cond, axis=1)
    first = jnp.argmax(cond, axis=1).astype(jnp.int32) + 1
    L = z.shape[1]
    layer = jnp.where(above, 1, jnp.where(below, L - 1, first))
    ok = above | below | found
    return layer, ok


def _vertical_lerp_t(z: jax.Array, layer: jax.Array, depth: jax.Array):
    """t = (clamp(depth) - z_dn) / (z_up - z_dn); fail if |denom| < 1e-12
    (reference kernel :958-985), with one-hot row selects."""
    lane = jnp.arange(z.shape[1])
    z_dn = jnp.sum(jnp.where(lane[None, :] == layer[:, None], z, 0.0), axis=1)
    z_up = jnp.sum(jnp.where(lane[None, :] == (layer - 1)[:, None], z, 0.0),
                   axis=1)
    x = jnp.clip(depth, z_dn, z_up)
    denom = z_up - z_dn
    ok = jnp.abs(denom) >= EPS_ZERO
    t = (x - z_dn) / jnp.where(ok, denom, 1.0)
    return t, ok


def _weighted_vertex_value(table: jax.Array, vids: jax.Array,
                           layer: jax.Array, weights: jax.Array) -> jax.Array:
    """sum_k w_k * table[vid_k, layer] for (nV, L[,3]) tables
    (reference SYCLKernel::CalcVelocity / CalcAttribute)."""
    gathered = table[vids, layer[:, None]]               # (N, K[,3])
    if gathered.ndim == 3:
        return jnp.einsum("nk,nkd->nd", weights, gathered, precision=HIGHEST)
    return jnp.einsum("nk,nk->n", weights, gathered, precision=HIGHEST)


def _pick_two_layers(cols: jax.Array, w: jax.Array,
                     layer_up: jax.Array, layer_dn: jax.Array):
    """(up, dn) with up = sum_k w_k * cols[n, k, layer_up[n]] (same math as
    _weighted_vertex_value) on already-gathered (N, K, L[,3]) columns.

    The layer pick is a masked select + reduction over L, which XLA fuses so
    ``cols`` is read once per pick with no large temporaries.  The mask has
    a single nonzero, so the result is the exact selected value
    (0 * finite == 0)."""
    L = cols.shape[2]
    lane = jnp.arange(L)
    m_up = lane[None, :] == layer_up[:, None]      # (N, L) bool
    m_dn = lane[None, :] == layer_dn[:, None]
    if cols.ndim == 4:
        v_up = jnp.sum(jnp.where(m_up[:, None, :, None], cols, 0.0), axis=2)
        v_dn = jnp.sum(jnp.where(m_dn[:, None, :, None], cols, 0.0), axis=2)
        return (jnp.einsum("nk,nkd->nd", w, v_up, precision=HIGHEST),
                jnp.einsum("nk,nkd->nd", w, v_dn, precision=HIGHEST))
    v_up = jnp.sum(jnp.where(m_up[:, None, :], cols, 0.0), axis=2)
    v_dn = jnp.sum(jnp.where(m_dn[:, None, :], cols, 0.0), axis=2)
    return (jnp.einsum("nk,nk->n", w, v_up, precision=HIGHEST),
            jnp.einsum("nk,nk->n", w, v_dn, precision=HIGHEST))


def weighted_profile(w: jax.Array, ztop_cols: jax.Array) -> jax.Array:
    """(N, L) ztop profile sum_k w_k * ztop_cols[n, k, :]."""
    return jnp.einsum("nk,nkl->nl", w, ztop_cols, precision=HIGHEST)


# ---------------------------------------------------------------------------
# stage evaluation
# ---------------------------------------------------------------------------

def _eval_stage_streamline(ztop_cols, vel_cols, wvel_cols,
                           pos, depth_neg, nv, lane_valid, vids_ok,
                           vpos, exact_clamp: bool, start: bool = False):
    """One CalcVelocityAt evaluation (streamline).  Returns (hvel, wvel, ok);
    failed lanes carry zeros, mirroring the reference RET0.

    The ``*_cols`` args are the per-cell vertex-column gathers
    ((N,K,L) ztop, (N,K,L,3) velocity, (N,K,L+1) vertical velocity), hoisted
    out of the RK stages: all four stages share the particle's (frozen) cell,
    so the reference's per-stage reloads collapse to one gather per step.
    ``start`` marks the evaluation at the particle's own position (the
    containment slack of _in_mesh)."""
    in_mesh = _in_mesh(pos, vpos, nv, lane_valid, slack=start)
    w = wachspress_weights(pos, vpos, nv)

    z = _clamp_profile(weighted_profile(w, ztop_cols), exact_clamp)
    layer = _layer_search_binary(z, depth_neg)
    t, ok_denom = _vertical_lerp_t(z, layer, depth_neg)

    v_up, v_dn = _pick_two_layers(vel_cols, w, layer - 1, layer)
    ok_mag = (jnp.linalg.norm(v_dn, axis=-1) >= EPS_ZERO) & \
             (jnp.linalg.norm(v_up, axis=-1) >= EPS_ZERO)
    hvel = t[:, None] * v_up + (1.0 - t[:, None]) * v_dn
    ok_final = jnp.linalg.norm(hvel, axis=-1) >= EPS_ZERO

    lp1 = wvel_cols.shape[2]
    dn_if = jnp.minimum(layer, lp1 - 1)
    up_if = jnp.minimum(jnp.maximum(layer - 1, 0), lp1 - 1)
    w_up, w_dn = _pick_two_layers(wvel_cols, w, up_if, dn_if)
    wvel = t * w_up + (1.0 - t) * w_dn

    ok = in_mesh & vids_ok & ok_denom & ok_mag & ok_final
    return (jnp.where(ok[:, None], hvel, 0.0),
            jnp.where(ok, wvel, 0.0), ok)


def _eval_stage_pathline(cols_f, cols_b,
                         pos, depth_neg, alpha, nv, lane_valid, vids_ok,
                         vpos, exact_clamp: bool, start: bool = False):
    """One CalcVelocityAt(pos, cell, alpha) evaluation (pathline): independent
    layer search + vertical lerp in both snapshots, blended by alpha
    (reference TBB kernel :1124-1327).  Returns (hvel, wvel, attr, ok).

    ``cols_f``/``cols_b`` are per-solution dicts of hoisted per-cell column
    gathers {ztop (N,K,L), vel (N,K,L,3), wvel (N,K,L+1), attrs (N,K,L,A)?}
    shared by all RK stages; ``start`` as in _eval_stage_streamline."""
    in_mesh = _in_mesh(pos, vpos, nv, lane_valid, slack=start)
    w = wachspress_weights(pos, vpos, nv)

    def column(cols):
        z = _clamp_profile(weighted_profile(w, cols["ztop"]), exact_clamp)
        layer, ok_layer = _layer_search_linear(z, depth_neg)
        t, ok_denom = _vertical_lerp_t(z, layer, depth_neg)
        return layer, t, ok_layer & ok_denom

    layer_f, t_f, ok_f = column(cols_f)
    layer_b, t_b, ok_b = column(cols_b)

    def hvel_of(cols, layer, t):
        v_up, v_dn = _pick_two_layers(cols["vel"], w, layer - 1, layer)
        return t[:, None] * v_up + (1.0 - t[:, None]) * v_dn

    def wvel_of(cols, layer, t):
        lp1 = cols["wvel"].shape[2]
        dn_if = jnp.minimum(layer, lp1 - 1)
        up_if = jnp.minimum(jnp.maximum(layer - 1, 0), lp1 - 1)
        w_up, w_dn = _pick_two_layers(cols["wvel"], w, up_if, dn_if)
        return t * w_up + (1.0 - t) * w_dn

    a = alpha
    hvel = a[:, None] * hvel_of(cols_b, layer_b, t_b) \
        + (1.0 - a[:, None]) * hvel_of(cols_f, layer_f, t_f)
    wvel = a * wvel_of(cols_b, layer_b, t_b) \
        + (1.0 - a) * wvel_of(cols_f, layer_f, t_f)

    attr = jnp.zeros((pos.shape[0], 3), dtype=pos.dtype)
    if cols_f.get("attrs") is not None:
        n_attr = min(cols_f["attrs"].shape[-1], cols_b["attrs"].shape[-1], 2)
        for ai in range(n_attr):
            def attr_of(cols, layer, t):
                a_up, a_dn = _pick_two_layers(cols["attrs"][..., ai], w,
                                              layer - 1, layer)
                return t * a_up + (1.0 - t) * a_dn
            val = a * attr_of(cols_b, layer_b, t_b) \
                + (1.0 - a) * attr_of(cols_f, layer_f, t_f)
            attr = attr.at[:, ai].set(val)

    ok = in_mesh & vids_ok & ok_f & ok_b
    return (jnp.where(ok[:, None], hvel, 0.0),
            jnp.where(ok, wvel, 0.0),
            jnp.where(ok[:, None], attr, 0.0), ok)


# ---------------------------------------------------------------------------
# integration driver
# ---------------------------------------------------------------------------

@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RawTrajectories:
    """Device-side advection output, pre-finalization.

    points/velocities/attrs are the reference's flat record buffers reshaped to
    (N, R, 3) (slot 0 pre-seeded with the start position, see
    src/Common/TrajectoryCommon.h:15-27 + TBB kernel :901).
    """

    points: jax.Array              # (N, R, 3)
    velocities: jax.Array          # (N, R, 3)
    attrs: Optional[jax.Array]     # (N, R, 3) or None
    final_position: jax.Array      # (N, 3)  reference stable_points after run
    final_depth: jax.Array         # (N,)
    final_cell: jax.Array          # (N,)
    alive: jax.Array               # (N,)


def rows_t(tab: jax.Array, idx: jax.Array) -> jax.Array:
    """Row gather with the batch dim last: tab (M, S) at idx (N,) -> (S, N),
    the same contiguous row reads as ``tab[idx]``."""
    S = tab.shape[1]
    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(0,), collapsed_slice_dims=(0,), start_index_map=(0,))
    return jax.lax.gather(tab, idx.astype(jnp.int32)[:, None], dn, (1, S),
                          mode=jax.lax.GatherScatterMode.CLIP)


def gather_cols(sol: SolutionFields, attrs: Optional[jax.Array],
                vids: jax.Array) -> dict:
    """Per-cell vertex columns of every field at vids (N, K): ztop (N,K,L),
    vel (N,K,L,3), wvel (N,K,L+1) and attrs (N,K,L,A) when given.  Each table
    is read as K row gathers on its 2-D (nV, S) view, so only the gathered
    (K, S, N) rows are transposed, never the table."""
    def g2(tab):
        flat = tab.reshape(tab.shape[0], -1)                  # (nV, S)
        k_rows = jnp.stack([rows_t(flat, vids[:, k])
                            for k in range(vids.shape[1])])   # (K, S, N)
        return jnp.transpose(k_rows, (2, 0, 1)).reshape(
            vids.shape + tab.shape[1:])

    cols = {"ztop": g2(sol.vertex_ztop),
            "vel": g2(sol.vertex_velocity),
            "wvel": g2(sol.vertex_vert_velocity)}
    if attrs is not None:
        cols["attrs"] = g2(attrs)
    return cols


def stacked_vertex_attrs(sol: SolutionFields) -> Optional[jax.Array]:
    """Vertex attributes stacked (nV, L, A) in lexicographic name order,
    mirroring the reference's std::map iteration order
    (src/GPU/SYCL/MPASOVisualizerSYCL.cpp:231-235)."""
    if len(sol.vertex_attrs) == 0:
        return None
    names = sorted(sol.vertex_attrs)
    return jnp.stack([sol.vertex_attrs[k] for k in names], axis=-1)


def record_schedule(settings: TrajectorySettings, pathline: bool):
    """Per-step (record_flag, record_slot) numpy arrays.

    Streamline records when run_time %% recordT == 0 with run_time = (i+1)*|dt|
    (reference TBB kernel :994); pathline when (i+1) %% (recordT/deltaT) == 0
    (TBB kernel :1470-1471).  Slots beyond R are dropped like the reference's
    bound check."""
    n_steps = settings.n_steps
    n_rec = settings.n_records
    i = np.arange(n_steps)
    if pathline:
        interval = int(settings.record_t) // int(settings.delta_t)
        flags = np.zeros(n_steps, dtype=bool) if interval <= 0 \
            else ((i + 1) % interval == 0)
    else:
        run_time = (i + 1) * abs(int(settings.delta_t))
        flags = (run_time % int(settings.record_t)) == 0
    slots = np.where(flags, np.cumsum(flags) - 1, 0).astype(np.int32)
    flags = flags & (slots < n_rec)
    return flags, slots


def _scan_core(mesh: MPASMesh, front: SolutionFields,
               back: Optional[SolutionFields],
               attr_front, attr_back,
               seeds, depths, cells,
               is_first_xs, flags_xs, slots_xs, alphas_xs, signed_dt,
               *, method: CalcMethod, fail_mode: FailMode, pathline: bool,
               duration: int, n_records: int, exact_clamp: bool):
    """Traceable advection core: builds the record buffers locally and runs
    the step scan.  Used directly under jit (single device) and inside
    shard_map (particle axis sharded; everything here is then shard-local, so
    the in-scan scatters need no cross-device resolution)."""
    real = seeds.dtype
    n = seeds.shape[0]
    dt = signed_dt.astype(real)
    freeze = fail_mode == FailMode.FREEZE
    euler = method == CalcMethod.EULER

    alive0 = (cells >= 0) & (cells < mesh.n_cells)
    # relocation candidates, built once per run inside jit
    reloc_xyz = build_reloc_xyz(mesh)

    # Buffers derive from the (possibly shard_map-varying) particle inputs so
    # their vma type matches the scan updates; the select folds to zeros.
    zeros_varying = jnp.where(
        jnp.zeros((n, n_records, 3), dtype=bool), seeds[:, None, :],
        jnp.zeros((), dtype=real))
    # first_loop pre-seeds slot 0 with the start position (TBB kernel :901)
    pts = zeros_varying.at[:, 0].set(jnp.where(alive0[:, None], seeds, 0.0))
    vels = zeros_varying
    attrs_buf = zeros_varying if pathline else None

    def xla_step(pos, depth_neg, a1, cell):
        """The reference-exact step (Euler or RK4) through the XLA stage
        functions, with the cell frozen across stages."""
        vids, nv, lane_valid, vids_ok, vpos = _gather_cell_vertices(
            mesh, cell)
        cols_f = gather_cols(front, attr_front, vids)
        cols_b = gather_cols(back, attr_back, vids) if pathline else None
        r = jnp.linalg.norm(pos, axis=-1)

        def eval_at(p, a, start=False):
            if pathline:
                return _eval_stage_pathline(
                    cols_f, cols_b, p, depth_neg, a, nv, lane_valid,
                    vids_ok, vpos, exact_clamp, start)
            h, w, ok = _eval_stage_streamline(
                cols_f["ztop"], cols_f["vel"], cols_f["wvel"],
                p, depth_neg, nv, lane_valid, vids_ok, vpos, exact_clamp,
                start)
            return h, w, jnp.zeros((p.shape[0], 3), dtype=real), ok

        if euler:
            hvel, wvel, attr, step_ok = eval_at(pos, a1, start=True)
            axis = geo.rotation_axis(pos, hvel)
            speed = jnp.linalg.norm(hvel, axis=-1)
            theta = speed * dt / jnp.maximum(EPS_ZERO, r)
            return (geo.rotation_delta(pos, axis, theta), hvel, wvel, attr,
                    step_ok)
        dalpha = dt / jnp.asarray(duration, dtype=real)
        a2 = jnp.clip(a1 + 0.5 * dalpha, 0.0, 1.0)
        a4 = jnp.clip(a1 + dalpha, 0.0, 1.0)
        k1, w1, at1, ok1 = eval_at(pos, a1, start=True)
        p2 = _advect_on_sphere(pos, k1, dt * 0.5)
        k2, w2, at2, ok2 = eval_at(p2, a2)
        p3 = _advect_on_sphere(pos, k2, dt * 0.5)
        k3, w3, at3, ok3 = eval_at(p3, a2)
        p4 = _advect_on_sphere(pos, k3, dt)
        k4, w4, at4, ok4 = eval_at(p4, a4)

        step_ok = ok1 & ok2 & ok3 & ok4
        hvel = (k1 + 2.0 * k2 + 2.0 * k3 + k4) / 6.0
        wvel = (w1 + 2.0 * w2 + 2.0 * w3 + w4) / 6.0
        attr = (at1 + 2.0 * at2 + 2.0 * at3 + at4) / 6.0

        return hvel * dt, hvel, wvel, attr, step_ok

    def step(carry, x):
        pos, lo, depth, cell, alive, pts, vels, attrs_buf = carry
        is_first, rec_flag, rec_slot, alpha0 = x

        depth_neg = (-depth).astype(real)
        do_reloc = (~is_first) & alive
        new_cell = _relocate_packed(mesh, reloc_xyz, pos, cell)
        cell = jnp.where(do_reloc, new_cell, cell)
        a1 = jnp.broadcast_to(alpha0, pos.shape[:1]).astype(real)
        disp, hvel, wvel, attr, step_ok = xla_step(pos, depth_neg, a1, cell)

        write_ok = (alive & step_ok) if freeze else alive
        alive = write_ok if freeze else alive

        new_depth = jnp.maximum(0.0, depth.astype(real) - wvel * dt)
        # the endpoint goes back on the sphere at the radius moved by w*dt
        new_pos, new_lo = _compensated_add(
            pos, lo, _sphere_delta(pos, disp, wvel * dt))

        upd = write_ok[:, None]
        pos = jnp.where(upd, new_pos, pos)
        lo = jnp.where(upd, new_lo, lo)
        depth = jnp.where(write_ok, new_depth.astype(depth.dtype), depth)

        # first-step velocity/attr write into slot 0 (TBB kernel :988-991)
        first_mask = (write_ok & is_first)[:, None]
        vels = vels.at[:, 0].set(jnp.where(first_mask, hvel, vels[:, 0]))
        if attrs_buf is not None:
            attrs_buf = attrs_buf.at[:, 0].set(
                jnp.where(first_mask, attr, attrs_buf[:, 0]))

        rec_mask = (write_ok & rec_flag)[:, None]
        pts = pts.at[:, rec_slot].set(jnp.where(rec_mask, pos, pts[:, rec_slot]))
        vels = vels.at[:, rec_slot].set(
            jnp.where(rec_mask, hvel, vels[:, rec_slot]))
        if attrs_buf is not None:
            attrs_buf = attrs_buf.at[:, rec_slot].set(
                jnp.where(rec_mask, attr, attrs_buf[:, rec_slot]))

        return (pos, lo, depth, cell, alive, pts, vels, attrs_buf), None

    lo0 = jnp.where(jnp.zeros(seeds.shape, dtype=bool), seeds,
                    jnp.zeros((), dtype=real))
    init = (seeds, lo0, depths, cells, alive0, pts, vels, attrs_buf)
    xs = (is_first_xs, flags_xs, slots_xs, alphas_xs)
    (pos, _, depth, cell, alive, pts, vels, attrs_buf), _ = jax.lax.scan(
        step, init, xs)
    return RawTrajectories(points=pts, velocities=vels, attrs=attrs_buf,
                           final_position=pos, final_depth=depth,
                           final_cell=cell, alive=alive)


_ADVECT_STATIC = ("method", "fail_mode", "pathline", "duration", "n_records",
                  "exact_clamp")
_advect_jit = functools.partial(jax.jit, static_argnames=_ADVECT_STATIC)(
    _scan_core)


def run_advection(mesh: MPASMesh, front: SolutionFields,
                  seeds: np.ndarray, cells: np.ndarray,
                  settings: TrajectorySettings,
                  back: Optional[SolutionFields] = None,
                  exact_clamp: bool = True,
                  dtype=None,
                  chunk: Optional[int] = None) -> RawTrajectories:
    """Run a full streamline (back=None) or pathline advection.

    Mirrors the host orchestration in the reference backends: buffer setup per
    Common::InitTrajectoryOutputBuffers (src/Common/TrajectoryCommon.h:15-27),
    per-particle depths per BuildEffectiveDepths (:29-41), then the device
    loop.  ``seeds``/``cells`` are the sample positions and their KD-searched
    start cells (MPASOField::calcInWhichCells, src/Core/MPASOField.cpp:23-34).

    ``chunk`` runs the particles in slices of that size through one compiled
    program.
    """
    pathline = back is not None
    real = jnp.asarray(mesh.cell_xyz).dtype if dtype is None else jnp.dtype(dtype)
    n = len(seeds)
    n_steps, n_rec = settings.n_steps, settings.n_records
    if n_steps <= 0 or n_rec <= 0:
        raise ValueError("invalid integration steps "
                         f"(n_steps={n_steps}, n_records={n_rec})")

    if chunk is not None and n > chunk:
        # Particle-axis chunking: each slice is padded to `chunk` so every
        # piece reuses ONE compiled executable, bounding device memory for
        # the (N, R, 3) record buffers.  Eager-only.
        depths_all = np.asarray(settings.effective_depths(n))
        outs = []
        for i in range(0, n, chunk):
            j = min(i + chunk, n)
            pad = chunk - (j - i)
            seeds_c = np.asarray(seeds)[i:j]
            cells_c = np.asarray(cells)[i:j]
            depths_c = depths_all[i:j]
            if pad:
                seeds_c = np.concatenate(
                    [seeds_c, np.repeat(seeds_c[-1:], pad, axis=0)])
                cells_c = np.concatenate(
                    [cells_c, np.full(pad, -1, dtype=np.asarray(cells).dtype)])
                depths_c = np.concatenate([depths_c, np.zeros(pad)])
            cfg_c = dataclasses.replace(
                settings, particle_depths=depths_c.astype(np.float32))
            outs.append(run_advection(
                mesh, front, seeds_c, cells_c, cfg_c, back=back,
                exact_clamp=exact_clamp, dtype=dtype))
        keep = [n - i for i in range(0, n, chunk)]
        cat = lambda f: jnp.concatenate(
            [getattr(o, f)[:min(chunk, k)] for o, k in zip(outs, keep)])
        return RawTrajectories(
            points=cat("points"), velocities=cat("velocities"),
            attrs=cat("attrs") if outs[0].attrs is not None else None,
            final_position=cat("final_position"),
            final_depth=cat("final_depth"),
            final_cell=cat("final_cell"), alive=cat("alive"))

    # dtype consistency: mesh + solution tables must match the particle dtype
    # or the scan carry would silently promote (no-op casts when they agree)
    if jnp.asarray(mesh.cell_xyz).dtype != real:
        mesh = mesh.astype(real)
    if front.vertex_ztop.dtype != real:
        front = front.astype(real)
    if back is not None and back.vertex_ztop.dtype != real:
        back = back.astype(real)

    use_attrs = pathline and len(front.cell_attrs) > 1 and back is not None \
        and len(back.cell_attrs) > 0
    attr_front = stacked_vertex_attrs(front) if use_attrs else None
    attr_back = stacked_vertex_attrs(back) if use_attrs else None

    xs = advection_schedule(settings, pathline, real)
    return _advect_jit(
        mesh, front, back, attr_front, attr_back,
        jnp.asarray(seeds, dtype=real),
        jnp.asarray(settings.effective_depths(n)),
        jnp.asarray(cells, dtype=jnp.int32), *xs,
        method=settings.method, fail_mode=settings.fail_mode,
        pathline=pathline, duration=int(settings.simulation_duration),
        n_records=n_rec, exact_clamp=exact_clamp)


def advection_schedule(settings: TrajectorySettings, pathline: bool, real):
    """Device xs arrays (is_first, flags, slots, alphas) + signed dt."""
    n_steps = settings.n_steps
    flags, slots = record_schedule(settings, pathline)
    is_first = np.zeros(n_steps, dtype=bool)
    is_first[0] = True
    alphas = (np.arange(n_steps) / n_steps).astype(np.float64) if pathline \
        else np.zeros(n_steps)
    sign = 1 if settings.direction == CalcDirection.FORWARD else -1
    signed_dt = jnp.asarray(sign * int(settings.delta_t), dtype=real)
    return (jnp.asarray(is_first), jnp.asarray(flags), jnp.asarray(slots),
            jnp.asarray(alphas, dtype=real), signed_dt)
