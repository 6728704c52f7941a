"""Scalar NumPy oracle: an independent, loop-for-loop transcription of the
reference CPU (TBB) backend's SEMANTICS, used as the golden baseline in tests.

The reference repo ships no golden-trajectory tests (SURVEY.md section 4); the
verification bar here is trajectory allclose against the reference TBB backend
(reference src/CPU/TBB/Kernel/MPASOVisualizerKernels.cpp), which is the one
backend runnable without GPUs.  This module encodes those exact scalar
semantics in plain Python/NumPy -- deliberately slow and simple -- so the
vectorized JAX engine can be validated bit-tolerantly without network access
or a C++ toolchain build of the reference.

Every function cites the reference lines it mirrors.  This is NOT a compute
path; tests only.
"""

from __future__ import annotations

import numpy as np

EPS_LAYER = 1e-8
EPS_ZERO = 1e-12
CLAMP = 1e-9


# ---------------------------------------------------------------------------
# preprocessing (mirrors src/GPU/SYCL/MPASOSolutionSYCL.cpp kernels)
# ---------------------------------------------------------------------------

def _barycentric(p, a, b, c):
    """Interpolator::calcTriangleBarycentric (Interpolation.hpp:79-93)."""
    v0, v1, v2 = b - a, c - a, p - a
    d00, d01, d11 = v0 @ v0, v0 @ v1, v1 @ v1
    d20, d21 = v2 @ v0, v2 @ v1
    denom = d00 * d11 - d01 * d01
    v = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    return 1.0 - v - w, v, w


def oracle_preprocess(mesh, cell_field, clamp_negative=False):
    """Cell -> vertex transfer (MPASOSolutionSYCL.cpp:123-226 and siblings)."""
    cov = np.asarray(mesh.cells_on_vertex)
    vx = np.asarray(mesh.vertex_xyz)
    cx = np.asarray(mesh.cell_xyz)
    f = np.asarray(cell_field)
    out = np.zeros((vx.shape[0],) + f.shape[1:], dtype=f.dtype)
    for vid in range(vx.shape[0]):
        cells = cov[vid]
        if (cells < 0).any():
            continue  # boundary -> 0
        u, v, w = _barycentric(vx[vid], cx[cells[0]], cx[cells[1]], cx[cells[2]])
        val = u * f[cells[0]] + v * f[cells[1]] + w * f[cells[2]]
        if clamp_negative:
            val = np.where(val < 0, 0.0, val)
        out[vid] = val
    return out


def _gauss_elimination(a, b):
    """Interpolator::gauss_elimination_fixed (Interpolation.hpp:174-217):
    partial-pivot Gauss elimination."""
    a = np.array(a, dtype=np.float64)
    b = np.array(b, dtype=np.float64)
    n = len(b)
    piv = list(range(n))
    for j in range(n - 1):
        max_row = j
        for i in range(j + 1, n):
            if abs(a[piv[i], j]) > abs(a[piv[max_row], j]):
                max_row = i
        piv[j], piv[max_row] = piv[max_row], piv[j]
        for i in range(j + 1, n):
            factor = a[piv[i], j] / a[piv[j], j]
            a[piv[i], j] = factor
            for k in range(j + 1, n):
                a[piv[i], k] -= factor * a[piv[j], k]
            b[piv[i]] -= factor * b[piv[j]]
    x = np.zeros(n)
    x[n - 1] = b[piv[n - 1]] / a[piv[n - 1], n - 1]
    for i in range(n - 2, -1, -1):
        s = sum(a[piv[i], j] * x[j] for j in range(i + 1, n))
        x[i] = (b[piv[i]] - s) / a[piv[i], i]
    return x


def oracle_rbf_cell_velocity(mesh, normal_velocity, cell_id, layer):
    """One cell/layer of SYCLBackend::CalcCellCenterVelocity (reference
    src/GPU/SYCL/MPASOSolutionSYCL.cpp:290-431): tangent-plane RBF with
    alpha hard-coded to 1.0 and the rhs evaluate_rbf(1.0) quirk.  Lanes beyond
    the cell's edge count (uninitialized stack reads in the reference) are
    excluded, matching mops_jax's masked formulation."""
    nv = int(mesh.n_edges_on_cell[cell_id])
    eoc = np.asarray(mesh.edges_on_cell)[cell_id][:nv]
    coe = np.asarray(mesh.cells_on_edge)
    cx = np.asarray(mesh.cell_xyz)
    ex = np.asarray(mesh.edge_xyz)
    center = cx[cell_id]

    up = center / np.linalg.norm(center)
    east = np.cross([0.0, 0.0, 1.0], up)
    if np.linalg.norm(east) < 1e-6:
        east = np.cross([0.0, 1.0, 0.0], up)
    east = east / np.linalg.norm(east)
    north = np.cross(up, east)
    basis = np.stack([east, north])

    pts, normals, nvel = [], [], []
    for eid in eoc:
        if eid < 0:
            continue
        c0, c1 = coe[eid]
        if c0 >= 0 and c1 >= 0:
            n = cx[max(c0, c1)] - cx[min(c0, c1)]
        else:
            n = ex[eid] - cx[max(c0, c1)]
        ln = np.linalg.norm(n)
        if ln == 0.0:
            continue
        pts.append(ex[eid])
        normals.append(n / ln)
        nvel.append(np.asarray(normal_velocity)[eid, layer])
    k = len(pts)
    ps = np.asarray(pts) @ basis.T          # (k, 2)
    pu = np.asarray(normals) @ basis.T      # (k, 2)
    a = np.zeros((k, k))
    for i in range(k):
        for j in range(k):
            r2 = ((ps[i] - ps[j]) ** 2).sum()
            a[i, j] = (1.0 / np.sqrt(1.0 + r2)) * (pu[i] @ pu[j])
    rhs_scale = 1.0 / np.sqrt(2.0)          # evaluate_rbf(1.0) quirk
    x1 = _gauss_elimination(a, rhs_scale * pu[:, 0])
    x2 = _gauss_elimination(a, rhs_scale * pu[:, 1])
    coeffs = np.outer(x1, basis[0]) + np.outer(x2, basis[1])
    return (coeffs * np.asarray(nvel)[:, None]).sum(axis=0)


# ---------------------------------------------------------------------------
# kernel helpers (mirror src/GPU/SYCL/Kernel/SYCLKernel.cpp)
# ---------------------------------------------------------------------------

def _is_in_mesh(mesh, cell_id, pos):
    """SYCLKernel::IsInMesh (SYCLKernel.cpp:41-76)."""
    if not np.all(np.isfinite(pos)):
        return False
    nv = int(mesh.n_edges_on_cell[cell_id])
    if nv == 0:
        return False
    voc = np.asarray(mesh.vertices_on_cell)[cell_id]
    vx = np.asarray(mesh.vertex_xyz)
    for k in range(nv):
        a = vx[voc[k]]
        b = vx[voc[(k + 1) % nv]]
        if np.dot(np.cross(a, b), pos) < 0:
            return False
    return True


def _wachspress(p, poly):
    """Interpolator::CalcPolygonWachspress (Interpolation.hpp:137-165)."""
    n = len(poly)

    def area(a, b, c):
        return 0.5 * np.linalg.norm(np.cross(b - a, c - a))

    w = np.zeros(n)
    a_next = area(poly[n - 1], poly[0], p)
    for i in range(n):
        a_i = a_next
        a_next = area(poly[i], poly[(i + 1) % n], p)
        b = area(poly[(i - 1 + n) % n], poly[i], poly[(i + 1) % n])
        w[i] = b / (a_i * a_next)
    return w / w.sum()


def _layer_binary(z, depth):
    """Streamline optimized layer search (MPASOVisualizerSYCL.cpp:903-944)."""
    L = len(z)
    if depth > z[0] + EPS_LAYER:
        return 1
    if depth < z[L - 1] - EPS_LAYER:
        return L - 1
    lo, hi, ans = 1, L - 1, 1
    while lo <= hi:
        mid = (lo + hi) >> 1
        top_i, bot_i = z[mid - 1], z[mid]
        if depth <= top_i + EPS_LAYER and depth >= bot_i - EPS_LAYER:
            ans = mid
            break
        if depth > top_i + EPS_LAYER:
            hi = mid - 1
        else:
            lo = mid + 1
    return min(max(ans, 1), L - 1)


def _layer_linear(z, depth):
    """Pathline layer search (TBB kernel :1182-1222); returns -1 on miss.
    The above-surface branch returns 0 in the reference (then reads z[-1],
    UB); the oracle clamps to 1 like mops_jax."""
    L = len(z)
    if depth > z[0] + EPS_LAYER:
        return 1
    if depth < z[L - 1] - EPS_LAYER:
        return L - 1
    for k in range(1, L):
        if depth <= z[k - 1] + EPS_LAYER and depth >= z[k] - EPS_LAYER:
            return k
    return -1


def _profile(mesh, sol_vertex_ztop, cell_id, weights, nv):
    """Interpolated ztop column + monotonic clamp (kernel :845-867)."""
    voc = np.asarray(mesh.vertices_on_cell)[cell_id]
    z = np.zeros(sol_vertex_ztop.shape[1])
    for k in range(len(z)):
        acc = 0.0
        for i in range(nv):
            acc += weights[i] * sol_vertex_ztop[voc[i], k]
        z[k] = acc
    for k in range(1, len(z)):
        if z[k] > z[k - 1]:
            z[k] = z[k - 1] - CLAMP
    return z


def _weighted(table, voc, weights, nv, layer):
    """SYCLKernel::CalcVelocity / CalcAttribute."""
    acc = np.zeros(table.shape[2:]) if table.ndim == 3 else 0.0
    for i in range(nv):
        acc = acc + weights[i] * table[voc[i], layer]
    return acc


def oracle_velocity_at(mesh, sol, pos, cell_id, depth_neg):
    """TBB calc_velocity_at (MPASOVisualizerKernels.cpp:740-872).

    Returns (hvel(3,), wvel, ok)."""
    vz = np.asarray(sol.vertex_ztop)
    vv = np.asarray(sol.vertex_velocity)
    vw = np.asarray(sol.vertex_vert_velocity)
    L = vz.shape[1]
    lp1 = vw.shape[1]
    if cell_id < 0 or L <= 1:
        return np.zeros(3), 0.0, False
    nv = int(mesh.n_edges_on_cell[cell_id])
    if not _is_in_mesh(mesh, cell_id, pos):
        return np.zeros(3), 0.0, False
    voc = np.asarray(mesh.vertices_on_cell)[cell_id]
    if (voc[:nv] < 0).any():
        return np.zeros(3), 0.0, False
    poly = np.asarray(mesh.vertex_xyz)[voc[:nv]]
    w = _wachspress(pos, poly)
    z = _profile(mesh, vz, cell_id, w, nv)
    layer = _layer_binary(z, depth_neg)
    z_dn, z_up = z[layer], z[layer - 1]
    x = max(z_dn, min(depth_neg, z_up))
    denom = z_up - z_dn
    if abs(denom) < EPS_ZERO:
        return np.zeros(3), 0.0, False
    t = (x - z_dn) / denom
    v_dn = _weighted(vv, voc, w, nv, layer)
    v_up = _weighted(vv, voc, w, nv, layer - 1)
    if np.linalg.norm(v_dn) < EPS_ZERO or np.linalg.norm(v_up) < EPS_ZERO:
        return np.zeros(3), 0.0, False
    hvel = t * v_up + (1.0 - t) * v_dn
    if np.linalg.norm(hvel) < EPS_ZERO:
        return np.zeros(3), 0.0, False
    dn_if = min(layer, lp1 - 1)
    up_if = min(max(layer - 1, 0), lp1 - 1)
    w_dn = _weighted(vw, voc, w, nv, dn_if)
    w_up = _weighted(vw, voc, w, nv, up_if)
    return hvel, t * w_up + (1.0 - t) * w_dn, True


def _pathline_velocity_at(mesh, front, back, attrs_f, attrs_b,
                          pos, cell_id, depth_neg, alpha):
    """TBB pathline calc_velocity_at (kernel :1124-1327)."""
    vzf, vzb = np.asarray(front.vertex_ztop), np.asarray(back.vertex_ztop)
    L = vzf.shape[1]
    if cell_id < 0 or L <= 1:
        return np.zeros(3), 0.0, np.zeros(3), False
    nv = int(mesh.n_edges_on_cell[cell_id])
    if not _is_in_mesh(mesh, cell_id, pos):
        return np.zeros(3), 0.0, np.zeros(3), False
    voc = np.asarray(mesh.vertices_on_cell)[cell_id]
    if (voc[:nv] < 0).any():
        return np.zeros(3), 0.0, np.zeros(3), False
    poly = np.asarray(mesh.vertex_xyz)[voc[:nv]]
    w = _wachspress(pos, poly)
    zf = _profile(mesh, vzf, cell_id, w, nv)
    zb = _profile(mesh, vzb, cell_id, w, nv)
    lf = _layer_linear(zf, depth_neg)
    lb = _layer_linear(zb, depth_neg)
    if lf < 0 or lb < 0:
        return np.zeros(3), 0.0, np.zeros(3), False

    def tparam(z, layer):
        z_dn, z_up = z[layer], z[layer - 1]
        x = max(z_dn, min(depth_neg, z_up))
        denom = z_up - z_dn
        if abs(denom) < EPS_ZERO:
            return None
        return (x - z_dn) / denom

    tf, tb = tparam(zf, lf), tparam(zb, lb)
    if tf is None or tb is None:
        return np.zeros(3), 0.0, np.zeros(3), False

    def hv(sol, layer, t):
        vv = np.asarray(sol.vertex_velocity)
        return t * _weighted(vv, voc, w, nv, layer - 1) \
            + (1.0 - t) * _weighted(vv, voc, w, nv, layer)

    def wv(sol, layer, t):
        vw = np.asarray(sol.vertex_vert_velocity)
        lp1 = vw.shape[1]
        dn_if = min(layer, lp1 - 1)
        up_if = min(max(layer - 1, 0), lp1 - 1)
        return t * _weighted(vw, voc, w, nv, up_if) \
            + (1.0 - t) * _weighted(vw, voc, w, nv, dn_if)

    hvel = alpha * hv(back, lb, tb) + (1.0 - alpha) * hv(front, lf, tf)
    wvel = alpha * wv(back, lb, tb) + (1.0 - alpha) * wv(front, lf, tf)

    attr = np.zeros(3)
    if attrs_f is not None:
        for ai in range(min(attrs_f.shape[-1], attrs_b.shape[-1], 2)):
            def av(table, layer, t):
                return t * _weighted(table[..., ai], voc, w, nv, layer - 1) \
                    + (1.0 - t) * _weighted(table[..., ai], voc, w, nv, layer)
            attr[ai] = alpha * av(attrs_b, lb, tb) \
                + (1.0 - alpha) * av(attrs_f, lf, tf)
    return hvel, wvel, attr, True


# ---------------------------------------------------------------------------
# integration (mirrors the TBB particle loops)
# ---------------------------------------------------------------------------

def _rotate(pos, axis, theta):
    """TBBKernel::CalcPositionAfterRotation (no zero-axis guard)."""
    ct, st = np.cos(theta), np.sin(theta)
    u = axis / np.linalg.norm(axis)
    ux, uy, uz = u
    m = np.array([
        [ct + ux * ux * (1 - ct), ux * uy * (1 - ct) - uz * st, ux * uz * (1 - ct) + uy * st],
        [uy * ux * (1 - ct) + uz * st, ct + uy * uy * (1 - ct), uy * uz * (1 - ct) - ux * st],
        [uz * ux * (1 - ct) - uy * st, uz * uy * (1 - ct) + ux * st, ct + uz * uz * (1 - ct)],
    ])
    return m @ pos


def _advect_sphere(pos, vel, dt):
    """TBB advect_on_sphere (kernel :729-738)."""
    rr = np.linalg.norm(pos)
    speed = np.linalg.norm(vel)
    if rr < EPS_ZERO or speed < EPS_ZERO:
        return pos
    axis = np.cross(pos, vel)
    return _rotate(pos, axis, speed * dt / rr)


def _relocate(mesh, pos, cell_id):
    """Neighbor-walk relocation (TBB kernel :902-921)."""
    nv = int(mesh.n_edges_on_cell[cell_id])
    coc = np.asarray(mesh.cells_on_cell)[cell_id]
    cx = np.asarray(mesh.cell_xyz)
    cand = list(coc[:nv]) + [cell_id]
    best, best_len = cell_id, np.inf
    for cid in cand:
        if cid < 0 or cid >= mesh.n_cells:
            continue
        d = np.linalg.norm(cx[cid] - pos)
        if d < best_len:
            best_len, best = d, cid
    return best


def oracle_streamline(mesh, sol, seeds, cells, settings):
    """TBB StreamLine particle loop (kernel :874-1003).

    Returns (points (N,R,3), velocities (N,R,3), final_pos, final_depth)."""
    n = len(seeds)
    n_steps, n_rec = settings.n_steps, settings.n_records
    sign = 1 if settings.direction.value > 0 else -1
    dt = sign * int(settings.delta_t)
    euler = settings.method.value == "euler"
    depths = settings.effective_depths(n).copy()
    pts = np.zeros((n, n_rec, 3))
    vels = np.zeros((n, n_rec, 3))
    stable = np.array(seeds, dtype=np.float64).copy()

    for pid in range(n):
        run_time = 0
        cell_id = -1
        first_loop, first_vel = True, True
        slot = 0
        for _ in range(n_steps):
            run_time += abs(dt)
            pos = stable[pid].copy()
            depth_neg = -1.0 * float(depths[pid])
            if first_loop:
                first_loop = False
                cell_id = int(cells[pid])
                if cell_id < 0 or cell_id >= mesh.n_cells:
                    break
                pts[pid, 0] = pos
            else:
                if cell_id < 0 or cell_id >= mesh.n_cells:
                    break
                cell_id = _relocate(mesh, pos, cell_id)

            r = np.linalg.norm(pos)
            if euler:
                hvel, wvel, ok = oracle_velocity_at(mesh, sol, pos, cell_id, depth_neg)
                if not ok:
                    break
                axis = np.cross(pos, hvel)
                theta = np.linalg.norm(hvel) * dt / max(EPS_ZERO, r)
                new_pos = _rotate(pos, axis, theta)
            else:
                s1 = oracle_velocity_at(mesh, sol, pos, cell_id, depth_neg)
                if not s1[2]:
                    break
                p2 = _advect_sphere(pos, s1[0], dt * 0.5)
                s2 = oracle_velocity_at(mesh, sol, p2, cell_id, depth_neg)
                if not s2[2]:
                    break
                p3 = _advect_sphere(pos, s2[0], dt * 0.5)
                s3 = oracle_velocity_at(mesh, sol, p3, cell_id, depth_neg)
                if not s3[2]:
                    break
                p4 = _advect_sphere(pos, s3[0], dt)
                s4 = oracle_velocity_at(mesh, sol, p4, cell_id, depth_neg)
                if not s4[2]:
                    break
                hvel = (s1[0] + 2 * s2[0] + 2 * s3[0] + s4[0]) / 6.0
                wvel = (s1[1] + 2 * s2[1] + 2 * s3[1] + s4[1]) / 6.0
                x_trial = pos + hvel * dt
                xl = np.linalg.norm(x_trial)
                new_pos = (x_trial / xl) * r if xl > EPS_ZERO else pos

            old_depth = float(depths[pid])
            depths[pid] = np.float32(max(0.0, old_depth - wvel * dt))
            r_new = max(1.0, r + wvel * dt)
            nl = np.linalg.norm(new_pos)
            if nl > EPS_ZERO:
                new_pos = new_pos / nl * r_new
            if first_vel:
                first_vel = False
                vels[pid, 0] = hvel
            stable[pid] = new_pos
            if settings.record_t > 0 and run_time % int(settings.record_t) == 0:
                if slot < n_rec:
                    pts[pid, slot] = new_pos
                    vels[pid, slot] = hvel
                slot += 1
    return pts, vels, stable, depths


def oracle_pathline(mesh, front, back, seeds, cells, settings,
                    attrs_f=None, attrs_b=None):
    """TBB PathLine particle loop (kernel :1329-1483)."""
    n = len(seeds)
    n_steps, n_rec = settings.n_steps, settings.n_records
    sign = 1 if settings.direction.value > 0 else -1
    dt = sign * int(settings.delta_t)
    euler = settings.method.value == "euler"
    depths = settings.effective_depths(n).copy()
    pts = np.zeros((n, n_rec, 3))
    vels = np.zeros((n, n_rec, 3))
    attrs_out = np.zeros((n, n_rec, 3))
    stable = np.array(seeds, dtype=np.float64).copy()
    interval = int(settings.record_t) // int(settings.delta_t)
    duration = float(settings.simulation_duration)

    for pid in range(n):
        cell_id = -1
        first_loop, first_vel = True, True
        slot = 0
        for step_i in range(n_steps):
            alpha = step_i / n_steps
            pos = stable[pid].copy()
            depth_neg = -1.0 * float(depths[pid])
            if first_loop:
                first_loop = False
                cell_id = int(cells[pid])
                if cell_id < 0 or cell_id >= mesh.n_cells:
                    break
                pts[pid, 0] = pos
            else:
                if cell_id < 0 or cell_id >= mesh.n_cells:
                    break
                cell_id = _relocate(mesh, pos, cell_id)

            r = np.linalg.norm(pos)
            if euler:
                out = _pathline_velocity_at(mesh, front, back, attrs_f, attrs_b,
                                            pos, cell_id, depth_neg, alpha)
                if not out[3]:
                    break
                hvel, wvel, attr = out[0], out[1], out[2]
                axis = np.cross(pos, hvel)
                theta = np.linalg.norm(hvel) * dt / max(EPS_ZERO, r)
                new_pos = _rotate(pos, axis, theta)
            else:
                dalpha = dt / duration
                a2 = min(1.0, max(0.0, alpha + 0.5 * dalpha))
                a4 = min(1.0, max(0.0, alpha + dalpha))
                s1 = _pathline_velocity_at(mesh, front, back, attrs_f, attrs_b,
                                           pos, cell_id, depth_neg, alpha)
                if not s1[3]:
                    break
                p2 = _advect_sphere(pos, s1[0], dt * 0.5)
                s2 = _pathline_velocity_at(mesh, front, back, attrs_f, attrs_b,
                                           p2, cell_id, depth_neg, a2)
                if not s2[3]:
                    break
                p3 = _advect_sphere(pos, s2[0], dt * 0.5)
                s3 = _pathline_velocity_at(mesh, front, back, attrs_f, attrs_b,
                                           p3, cell_id, depth_neg, a2)
                if not s3[3]:
                    break
                p4 = _advect_sphere(pos, s3[0], dt)
                s4 = _pathline_velocity_at(mesh, front, back, attrs_f, attrs_b,
                                           p4, cell_id, depth_neg, a4)
                if not s4[3]:
                    break
                hvel = (s1[0] + 2 * s2[0] + 2 * s3[0] + s4[0]) / 6.0
                wvel = (s1[1] + 2 * s2[1] + 2 * s3[1] + s4[1]) / 6.0
                attr = (s1[2] + 2 * s2[2] + 2 * s3[2] + s4[2]) / 6.0
                x_trial = pos + hvel * dt
                xl = np.linalg.norm(x_trial)
                new_pos = (x_trial / xl) * r if xl > EPS_ZERO else pos

            if first_vel:
                first_vel = False
                vels[pid, 0] = hvel
                attrs_out[pid, 0] = attr
            old_depth = float(depths[pid])
            depths[pid] = np.float32(max(0.0, old_depth - wvel * dt))
            r_new = max(1.0, r + wvel * dt)
            nl = np.linalg.norm(new_pos)
            if nl > EPS_ZERO:
                new_pos = new_pos / nl * r_new
            stable[pid] = new_pos
            if interval > 0 and (step_i + 1) % interval == 0:
                if slot < n_rec:
                    pts[pid, slot] = new_pos
                    vels[pid, slot] = hvel
                    attrs_out[pid, slot] = attr
                slot += 1
    return pts, vels, attrs_out, stable, depths
