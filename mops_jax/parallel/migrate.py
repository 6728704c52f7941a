"""Domain-decomposed advection with particle migration (shard_map).

Each device advances only the particles inside its mesh partition against its
local cell/vertex tables (see decompose.py); every ``migrate_every`` steps,
particles whose relocated cell is owned by another shard are exchanged with a
fixed-capacity ``jax.lax.all_to_all`` and inserted into the destination pool's
free slots.  This is the scaling mode the reference lacks entirely (its MPI
mode duplicates identical work per rank, reference CLI/main.cpp:58-66): mesh
memory per device shrinks ~P-fold, and the interconnect carries only
boundary-crossing particles.

Coverage: streamline AND pathline (two snapshots blended by alpha, optional
named attributes recorded like the single-device engine), RK4/Euler, and both
failure modes (FailMode.ZERO zero-velocity continuation and FailMode.FREEZE,
where a failed particle permanently stops but keeps its pool slot).  Batched
migration (``migrate_every`` = k > 1) amortizes the all_to_all over k
advection steps; halo_rings >= k keeps every reachable cell resident because
the relocation argmin moves a particle at most one neighbor ring per step.

Particle records are tagged with global particle ids so trajectories are
reassembled exactly on the host regardless of which shard recorded each
segment.  Capacity limits (send slots per destination, pool slots per shard)
are explicit; overflow drops are COUNTED and reported, never silent.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..advect import (_advect_delta, _advect_on_sphere, _compensated_add,
                      _eval_stage_pathline, _sphere_delta,
                      _eval_stage_streamline, _gather_cell_vertices,
                      _relocate, record_schedule, stacked_vertex_attrs)
from ..mesh import MPASMesh
from ..settings import (CalcDirection, CalcMethod, FailMode,
                        TrajectorySettings)
from ..solution import SolutionFields
from .decompose import DecomposedMesh, decompose

SHARD_AXIS = "shards"

# jitted shard_map programs keyed on their closed-over statics (see
# run_advection_migrating): reusing the callable is what lets jax.jit reuse
# the compiled executable across calls
_PROGRAM_CACHE: dict = {}


def enc_i32(a):
    """int32 -> f32 VALUE encode, exact for |v| <= 2**24, so int fields can
    ride in the float exchange payload.  A value conversion, not a bitcast:
    small ints are subnormal f32 bit patterns and -1 is a NaN payload, which
    data movement may flush or canonicalise."""
    return a.astype(jnp.int32).astype(jnp.float32)


def dec_i32(f):
    """f32 VALUE-encoded int (see enc_i32) -> int32."""
    return f.astype(jnp.int32)


def _local_mesh(d: dict) -> MPASMesh:
    """Wrap squeezed per-shard tables as an MPASMesh for the advect helpers."""
    nlc = d["cell_xyz"].shape[0]
    K = d["vertices_on_cell"].shape[1]
    dummy_e = jnp.zeros((1, 3), dtype=d["cell_xyz"].dtype)
    dummy_i2 = jnp.full((1, 2), -1, dtype=jnp.int32)
    return MPASMesh(
        cell_xyz=d["cell_xyz"], vertex_xyz=d["vertex_xyz"],
        edge_xyz=dummy_e,
        n_edges_on_cell=d["n_edges_on_cell"],
        vertices_on_cell=d["vertices_on_cell"],
        cells_on_cell=d["cells_on_cell"],
        cells_on_vertex=jnp.full((d["vertex_xyz"].shape[0], 3), -1,
                                 dtype=jnp.int32),
        edges_on_cell=jnp.full((nlc, K), -1, dtype=jnp.int32),
        cells_on_edge=dummy_i2, vertices_on_edge=dummy_i2)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MigratingTrajectories:
    """Per-shard-slot outputs; reassemble by particle id (see reassemble)."""

    rec_pos: jax.Array      # (P, cap, R, 3)
    rec_vel: jax.Array      # (P, cap, R, 3)
    rec_attr: Optional[jax.Array]   # (P, cap, R, 3) or None
    rec_ids: jax.Array      # (P, cap, R) int32, -1 = no record in that slot
    final_pos: jax.Array    # (P, cap, 3)
    final_depth: jax.Array  # (P, cap)
    final_ids: jax.Array    # (P, cap) int32, -1 = empty slot
    dropped: jax.Array      # (P,) int32 particles lost to capacity overflow
    migrated: jax.Array     # (P,) int32 cumulative particles SENT by shard p


def run_advection_migrating(mesh: MPASMesh, sol: SolutionFields,
                            seeds: np.ndarray, cells: np.ndarray,
                            settings: TrajectorySettings,
                            dmesh: Optional[Mesh] = None,
                            capacity_factor: float = 2.0,
                            send_capacity: Optional[int] = None,
                            dtype=jnp.float32,
                            back: Optional[SolutionFields] = None,
                            migrate_every: int = 1,
                            ) -> MigratingTrajectories:
    """Advection over a domain-decomposed mesh with particle migration.

    ``back`` switches to pathline semantics (two snapshots, per-step alpha,
    optional named attributes).  ``migrate_every`` batches the all_to_all
    exchange every k steps (halo rings are widened to k so relocation between
    exchanges never leaves the resident region)."""
    if dmesh is None:
        devs = jax.devices()
        dmesh = jax.make_mesh((len(devs),), (SHARD_AXIS,), devices=devs)
    n_shards = dmesh.devices.size
    pathline = back is not None
    freeze = settings.fail_mode == FailMode.FREEZE
    k_mig = max(1, int(migrate_every))

    sol = sol.astype(dtype)
    back_s = back.astype(dtype) if pathline else None
    use_attrs = pathline and len(sol.cell_attrs) > 1 \
        and len(back_s.cell_attrs) > 0
    af = ab = None
    n_attrs = 0
    if use_attrs:
        af = np.asarray(stacked_vertex_attrs(sol))
        ab = np.asarray(stacked_vertex_attrs(back_s))
        n_attrs = min(af.shape[-1], ab.shape[-1], 2)
        af, ab = af[..., :n_attrs], ab[..., :n_attrs]

    dec = decompose(mesh, sol, n_shards, halo_rings=k_mig,
                    dtype=np.dtype(dtype), back=back_s,
                    attrs_front=af, attrs_back=ab)
    n = len(seeds)
    cap = int(np.ceil(n / n_shards * capacity_factor))
    send_cap = send_capacity or max(64, cap // 4)
    n_steps = settings.n_steps
    n_rec = settings.n_records

    # initial distribution: particle -> owner of its start cell
    owner_g = np.full(mesh.n_cells, -1, dtype=np.int32)
    for p in range(n_shards):
        nl = dec.n_local_cells[p]
        own = dec.owner[p, :nl] == p
        owner_g[dec.cell_l2g[p, :nl][own]] = p
    start_owner = owner_g[np.asarray(cells)]

    pos0 = np.zeros((n_shards, cap, 3), dtype=np.dtype(dtype))
    depth0 = np.zeros((n_shards, cap), dtype=np.float32)
    lcell0 = np.full((n_shards, cap), -1, dtype=np.int32)
    pid0 = np.full((n_shards, cap), -1, dtype=np.int32)
    alive0 = np.zeros((n_shards, cap), dtype=bool)
    depths_all = settings.effective_depths(n)
    init_drop0 = np.zeros(n_shards, dtype=np.int32)
    for p in range(n_shards):
        all_mine = np.nonzero(start_owner == p)[0]
        mine = all_mine[:cap]
        # seed-time pool truncation is particle loss and must be accounted
        # like migration overflow (raise capacity_factor to avoid it)
        init_drop0[p] = len(all_mine) - len(mine)
        k = len(mine)
        pos0[p, :k] = seeds[mine]
        depth0[p, :k] = depths_all[mine]
        lcell0[p, :k] = dec.cell_g2l[p][np.asarray(cells)[mine]]
        pid0[p, :k] = mine
        alive0[p, :k] = True

    flags, slots = record_schedule(settings, pathline=pathline)
    is_first = np.zeros(n_steps, dtype=bool)
    is_first[0] = True
    alphas = (np.arange(n_steps) / n_steps) if pathline \
        else np.zeros(n_steps)
    active = np.ones(n_steps, dtype=bool)
    sign = 1 if settings.direction == CalcDirection.FORWARD else -1
    dt = float(sign * settings.delta_t)
    duration = float(settings.simulation_duration)
    euler = settings.method == CalcMethod.EULER

    # pad the schedule to a multiple of k_mig with inactive steps, then fold
    # into (n_outer, k_mig) so one scan iteration = k steps + one exchange
    pad = (-n_steps) % k_mig
    if pad:
        zpad = np.zeros(pad)
        flags = np.concatenate([flags, zpad.astype(bool)])
        slots = np.concatenate([slots, zpad.astype(np.int32)])
        is_first = np.concatenate([is_first, zpad.astype(bool)])
        alphas = np.concatenate([alphas, zpad])
        active = np.concatenate([active, zpad.astype(bool)])
    fold = lambda a: np.asarray(a).reshape(-1, k_mig)

    local_tables = {
        "cell_xyz": dec.cell_xyz, "vertex_xyz": dec.vertex_xyz,
        "n_edges_on_cell": dec.n_edges_on_cell,
        "vertices_on_cell": dec.vertices_on_cell,
        "cells_on_cell": dec.cells_on_cell,
        "owner": dec.owner, "cell_l2g": dec.cell_l2g,
        "cell_g2l": dec.cell_g2l,
        "vertex_ztop": dec.vertex_ztop,
        "vertex_velocity": dec.vertex_velocity,
        "vertex_vert_velocity": dec.vertex_vert_velocity,
    }
    if pathline:
        local_tables.update(
            vertex_ztop_b=dec.vertex_ztop_b,
            vertex_velocity_b=dec.vertex_velocity_b,
            vertex_vert_velocity_b=dec.vertex_vert_velocity_b)
    if use_attrs:
        local_tables.update(vertex_attrs=dec.vertex_attrs,
                            vertex_attrs_b=dec.vertex_attrs_b)

    def body(tables, pos, depth, lcell, pid, alive, init_drop,
             rec_pos, rec_vel, rec_attr, rec_ids, is_first_xs, flags_xs,
             slots_xs, alphas_xs, active_xs):
        tables = {k: v[0] for k, v in tables.items()}
        lmesh = _local_mesh(tables)
        me = jax.lax.axis_index(SHARD_AXIS).astype(jnp.int32)
        pos, depth, lcell, pid = pos[0], depth[0], lcell[0], pid[0]
        alive = alive[0]
        rec_pos, rec_vel, rec_ids = rec_pos[0], rec_vel[0], rec_ids[0]
        rec_attr = rec_attr[0] if rec_attr is not None else None
        real = pos.dtype

        def advance(state, x):
            """One advection step on the local pool (no communication)."""
            pos, lo, depth, lcell, pid, alive, rec_pos, rec_vel, rec_attr, \
                rec_ids = state
            first, rec_flag, rec_slot, alpha0, act = x
            occupied = pid >= 0
            moving = occupied & alive if freeze else occupied
            moving = moving & act
            cell_safe = jnp.clip(lcell, 0)

            # first step: pre-seed record slot 0 with the start position
            # (single-device engine seeds pts[:, 0] before the scan)
            fm0 = first & occupied
            rec_pos = rec_pos.at[:, 0].set(
                jnp.where(fm0[:, None], pos, rec_pos[:, 0]))
            rec_ids = rec_ids.at[:, 0].set(
                jnp.where(fm0, pid, rec_ids[:, 0]))

            new_cell = _relocate(lmesh, pos, cell_safe)
            cell = jnp.where((~first) & moving, new_cell, cell_safe)
            vids, nv, lane_valid, vids_ok, vpos = _gather_cell_vertices(
                lmesh, cell)
            depth_neg = (-depth).astype(real)

            cols_f = {"ztop": tables["vertex_ztop"][vids],
                      "vel": tables["vertex_velocity"][vids],
                      "wvel": tables["vertex_vert_velocity"][vids]}
            cols_b = None
            if use_attrs:
                cols_f["attrs"] = tables["vertex_attrs"][vids]
            if pathline:
                cols_b = {"ztop": tables["vertex_ztop_b"][vids],
                          "vel": tables["vertex_velocity_b"][vids],
                          "wvel": tables["vertex_vert_velocity_b"][vids]}
                if use_attrs:
                    cols_b["attrs"] = tables["vertex_attrs_b"][vids]

            def eval_at(p, a, start=False):
                if pathline:
                    return _eval_stage_pathline(
                        cols_f, cols_b, p, depth_neg, a, nv, lane_valid,
                        vids_ok, vpos, False, start)
                h, w, ok = _eval_stage_streamline(
                    cols_f["ztop"], cols_f["vel"], cols_f["wvel"],
                    p, depth_neg, nv, lane_valid, vids_ok, vpos, False,
                    start)
                return h, w, jnp.zeros((p.shape[0], 3), dtype=real), ok

            a1 = jnp.broadcast_to(alpha0, pos.shape[:1]).astype(real)
            if euler:
                hvel, wvel, attr, step_ok = eval_at(pos, a1, start=True)
                disp = _advect_delta(pos, hvel, dt)
            else:
                dalpha = (jnp.asarray(dt, dtype=real)
                          / jnp.asarray(duration, dtype=real)) \
                    if pathline else 0.0
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
                hvel = (k1 + 2 * k2 + 2 * k3 + k4) / 6.0
                wvel = (w1 + 2 * w2 + 2 * w3 + w4) / 6.0
                attr = (at1 + 2 * at2 + 2 * at3 + at4) / 6.0
                disp = hvel * dt

            write_ok = (moving & step_ok) if freeze else moving
            alive = jnp.where(moving, write_ok, alive) if freeze else alive

            new_depth = jnp.maximum(0.0, depth - wvel.astype(depth.dtype) * dt)
            new_pos, new_lo = _compensated_add(
                pos, lo, _sphere_delta(pos, disp, wvel * dt))

            upd = write_ok[:, None]
            pos = jnp.where(upd, new_pos, pos)
            lo = jnp.where(upd, new_lo, lo)
            depth = jnp.where(write_ok, new_depth, depth)
            lcell = jnp.where(moving, cell, lcell)

            # first-step velocity/attr into record slot 0 (TBB kernel :988-991)
            fm = (write_ok & first)[:, None]
            rec_vel = rec_vel.at[:, 0].set(
                jnp.where(fm, hvel, rec_vel[:, 0]))
            if rec_attr is not None:
                rec_attr = rec_attr.at[:, 0].set(
                    jnp.where(fm, attr, rec_attr[:, 0]))

            wm = write_ok & rec_flag
            rec_pos = rec_pos.at[:, rec_slot].set(
                jnp.where(wm[:, None], pos, rec_pos[:, rec_slot]))
            rec_vel = rec_vel.at[:, rec_slot].set(
                jnp.where(wm[:, None], hvel, rec_vel[:, rec_slot]))
            if rec_attr is not None:
                rec_attr = rec_attr.at[:, rec_slot].set(
                    jnp.where(wm[:, None], attr, rec_attr[:, rec_slot]))
            rec_ids = rec_ids.at[:, rec_slot].set(
                jnp.where(wm, pid, rec_ids[:, rec_slot]))

            return (pos, lo, depth, lcell, pid, alive, rec_pos, rec_vel,
                    rec_attr, rec_ids)

        def step(carry, x):
            state, dropped, sent = carry[:10], carry[10], carry[11]
            if k_mig == 1:
                state = advance(state, tuple(v[0] for v in x))
            else:
                # inner scan (not a Python unroll): k_mig amortizes the
                # exchange without k-plicating the traced program
                state, _ = jax.lax.scan(
                    lambda s, xk: (advance(s, xk), None), state, x)
            (pos, lo, depth, lcell, pid, alive, rec_pos, rec_vel, rec_attr,
             rec_ids) = state

            # ---- migration (once per k_mig steps) ----
            occupied = pid >= 0
            dest = jnp.where(occupied, tables["owner"][jnp.clip(lcell, 0)], -1)
            leave = occupied & (dest >= 0) & (dest != me)
            gcell = tables["cell_l2g"][jnp.clip(lcell, 0)]

            # rank departures per destination, scatter into send buffers
            dest_oh = (dest[None, :] == jnp.arange(n_shards)[:, None]) & leave
            rank = jnp.cumsum(dest_oh, axis=1) - 1          # (P, cap)
            slot_ok = dest_oh & (rank < send_cap)
            flat_idx = jnp.where(slot_ok,
                                 jnp.arange(n_shards)[:, None] * send_cap + rank,
                                 n_shards * send_cap)       # OOB -> dropped
            # exactly one destination row is active per leaver; min picks it
            # (inactive rows hold the OOB sentinel)
            flat_idx = flat_idx.min(axis=0).astype(jnp.int32)
            # per-particle send slot (exactly one row is active for leavers)
            send_to = jnp.where(leave, flat_idx, n_shards * send_cap)

            # every particle gets a UNIQUE scatter index (non-leavers map to
            # distinct out-of-bounds slots that mode="drop" discards):
            # unique_indices=True lets XLA lower the scatter in parallel
            # instead of the serialized duplicate-safe form
            oob = n_shards * send_cap
            # condition on the index itself: non-leavers AND capacity-dropped
            # leavers both carry the shared oob sentinel and must be spread
            # over distinct dropped slots for the uniqueness claim to hold
            send_to_u = jnp.where(
                send_to < oob, send_to,
                oob + jnp.arange(send_to.shape[0], dtype=jnp.int32))

            over = leave & (send_to >= n_shards * send_cap)
            dropped = dropped + jnp.sum(over).astype(jnp.int32)
            sent = sent + jnp.sum(leave).astype(jnp.int32)
            cap_n = pos.shape[0]
            packed_exchange = real == jnp.float32

            if packed_exchange:
                # single-buffer exchange: all per-particle fields packed into
                # ONE (cap, 10) f32 payload (int fields value-encoded), so the
                # send is 1 scatter + 1 all_to_all and the insert is 2
                # scatters instead of 12 scatters + 6 collectives.
                payload = jnp.concatenate([
                    pos, depth.astype(jnp.float32)[:, None],
                    enc_i32(gcell)[:, None],
                    enc_i32(jnp.where(leave, pid, -1))[:, None],
                    alive.astype(jnp.float32)[:, None], lo], axis=1)
                neg1 = enc_i32(jnp.full((), -1))
                buf0 = jnp.zeros((n_shards * send_cap, 10), jnp.float32)
                buf0 = buf0.at[:, 4].set(neg1).at[:, 5].set(neg1)
                s_pay = buf0.at[send_to_u].set(
                    payload, mode="drop", unique_indices=True).reshape(
                    n_shards, send_cap, 10)
                pid = jnp.where(leave, -1, pid)   # vacate leaving slots
                arr = jax.lax.all_to_all(
                    s_pay, SHARD_AXIS, 0, 0).reshape(-1, 10)
                arr_pid = dec_i32(arr[:, 5])
                arr_valid = arr_pid >= 0
            else:
                def scatter(val, fill):
                    buf = jnp.full(
                        (n_shards * send_cap,) + val.shape[1:], fill,
                        dtype=val.dtype)
                    return buf.at[send_to_u].set(
                        val, mode="drop", unique_indices=True).reshape(
                        (n_shards, send_cap) + val.shape[1:])

                s_pos = scatter(pos, 0.0)
                s_lo = scatter(lo, 0.0)
                s_depth = scatter(depth, 0.0)
                s_gcell = scatter(gcell, -1)
                s_pid = scatter(jnp.where(leave, pid, -1), -1)
                s_alive = scatter(alive, False)
                pid = jnp.where(leave, -1, pid)   # vacate leaving slots

                # exchange: row p of the send stack goes to shard p
                arr_pos = jax.lax.all_to_all(
                    s_pos, SHARD_AXIS, 0, 0).reshape(-1, 3)
                arr_lo = jax.lax.all_to_all(
                    s_lo, SHARD_AXIS, 0, 0).reshape(-1, 3)
                arr_depth = jax.lax.all_to_all(
                    s_depth, SHARD_AXIS, 0, 0).reshape(-1)
                arr_gcell = jax.lax.all_to_all(
                    s_gcell, SHARD_AXIS, 0, 0).reshape(-1)
                arr_pid = jax.lax.all_to_all(
                    s_pid, SHARD_AXIS, 0, 0).reshape(-1)
                arr_alive = jax.lax.all_to_all(
                    s_alive, SHARD_AXIS, 0, 0).reshape(-1)
                arr_valid = arr_pid >= 0

            # free-slot assignment
            empty = pid < 0
            empty_rank = jnp.cumsum(empty) - 1
            slots_by_rank = jnp.full(cap_n + 1, cap_n, dtype=jnp.int32)
            slot_idx_u = jnp.where(
                empty, empty_rank,
                cap_n + jnp.arange(cap_n, dtype=jnp.int32))
            slots_by_rank = slots_by_rank.at[slot_idx_u].set(
                jnp.arange(cap_n, dtype=jnp.int32), mode="drop",
                unique_indices=True)
            arr_rank = jnp.cumsum(arr_valid) - 1
            n_empty = jnp.sum(empty)
            can_place = arr_valid & (arr_rank < n_empty)
            target = jnp.where(
                can_place,
                slots_by_rank[jnp.clip(arr_rank, 0, cap_n - 1)],
                cap_n + jnp.arange(arr_valid.shape[0])).astype(jnp.int32)

            dropped = dropped + jnp.sum(arr_valid & ~can_place).astype(jnp.int32)

            upd = dict(mode="drop", unique_indices=True)
            if packed_exchange:
                placed = jnp.zeros((cap_n,), bool).at[target].set(
                    jnp.ones_like(arr_valid), **upd)
                ins = jnp.zeros((cap_n, 10), jnp.float32).at[target].set(
                    arr, **upd)
                pos = jnp.where(placed[:, None], ins[:, :3], pos)
                lo = jnp.where(placed[:, None], ins[:, 7:], lo)
                depth = jnp.where(placed, ins[:, 3].astype(depth.dtype),
                                  depth)
                pid = jnp.where(placed, dec_i32(ins[:, 5]), pid)
                alive = jnp.where(placed, ins[:, 6] > 0.5, alive)
                lcl = tables["cell_g2l"][jnp.clip(dec_i32(ins[:, 4]), 0)]
                lcell = jnp.where(placed, lcl, lcell)
            else:
                pos = pos.at[target].set(arr_pos, **upd)
                lo = lo.at[target].set(arr_lo, **upd)
                depth = depth.at[target].set(arr_depth, **upd)
                pid = pid.at[target].set(arr_pid, **upd)
                alive = alive.at[target].set(arr_alive, **upd)
                lcl = tables["cell_g2l"][jnp.clip(arr_gcell, 0)]
                lcell = lcell.at[target].set(lcl, **upd)

            return (pos, lo, depth, lcell, pid, alive, rec_pos, rec_vel,
                    rec_attr, rec_ids, dropped, sent), None

        # derive from a shard-varying value so the scan carry vma type
        # matches; seeded with the seed-time pool-truncation count so every
        # lost particle is accounted in `dropped`
        zero_v = (pid[0] * 0).astype(jnp.int32)
        dropped0 = zero_v + init_drop[0, 0]
        lo0 = jnp.where(jnp.zeros(pos.shape, dtype=bool), pos,
                        jnp.zeros((), dtype=real))
        carry0 = (pos, lo0, depth, lcell, pid, alive, rec_pos, rec_vel,
                  rec_attr, rec_ids, dropped0, zero_v)
        (pos, _, depth, lcell, pid, alive, rec_pos, rec_vel, rec_attr,
         rec_ids, dropped, sent), _ = jax.lax.scan(
            step, carry0,
            (is_first_xs, flags_xs, slots_xs, alphas_xs, active_xs))
        rec_attr_out = rec_attr[None] if rec_attr is not None \
            else jnp.zeros((1, 1), dtype=real)
        return (rec_pos[None], rec_vel[None], rec_attr_out, rec_ids[None],
                pos[None], depth[None], pid[None], dropped[None], sent[None])

    rec_pos0 = jnp.zeros((n_shards, cap, n_rec, 3), dtype=dtype)
    rec_vel0 = jnp.zeros((n_shards, cap, n_rec, 3), dtype=dtype)
    rec_attr0 = jnp.zeros((n_shards, cap, n_rec, 3), dtype=dtype) \
        if use_attrs else None
    rec_ids0 = jnp.full((n_shards, cap, n_rec), -1, dtype=jnp.int32)

    # Cache the jitted shard_map program keyed on every closed-over static:
    # a fresh jax.jit per call would re-trace AND re-compile each run.
    # Shapes are not part of the key; jit itself retraces on shape change.
    p_shard = P(SHARD_AXIS)
    key = (dmesh, n_shards, pathline, use_attrs, n_attrs, freeze, k_mig,
           euler, dt, duration, send_cap)
    prog = _PROGRAM_CACHE.get(key)
    if prog is None:
        mapped = shard_map(
            body, mesh=dmesh,
            in_specs=(p_shard,) * 11 + (P(),) * 5,
            out_specs=(p_shard,) * 9)
        prog = _PROGRAM_CACHE[key] = jax.jit(mapped)

    shard_tables = {k: jax.device_put(
        jnp.asarray(v), NamedSharding(dmesh, P(SHARD_AXIS)))
        for k, v in local_tables.items()}
    (rec_pos, rec_vel, rec_attr, rec_ids, fpos, fdepth, fids, dropped,
     sent) = prog(
        shard_tables, jnp.asarray(pos0), jnp.asarray(depth0),
        jnp.asarray(lcell0), jnp.asarray(pid0), jnp.asarray(alive0),
        jnp.asarray(init_drop0[:, None]),
        rec_pos0, rec_vel0, rec_attr0, rec_ids0,
        jnp.asarray(fold(is_first)), jnp.asarray(fold(flags)),
        jnp.asarray(fold(slots)),
        jnp.asarray(fold(alphas), dtype=dtype), jnp.asarray(fold(active)))
    return MigratingTrajectories(
        rec_pos=rec_pos, rec_vel=rec_vel,
        rec_attr=rec_attr if use_attrs else None, rec_ids=rec_ids,
        final_pos=fpos, final_depth=fdepth, final_ids=fids, dropped=dropped,
        migrated=sent)


def reassemble(result: MigratingTrajectories, n_particles: int,
               seeds: np.ndarray):
    """Host-side reassembly by particle id.

    Returns (points (N, R, 3) with slot 0 pre-seeded like the single-device
    engine, velocities (N, R, 3), attrs (N, R, 3) or None, final_pos (N, 3),
    final_depth (N,))."""
    rec_pos = np.asarray(result.rec_pos)
    rec_vel = np.asarray(result.rec_vel)
    rec_ids = np.asarray(result.rec_ids)
    has_attr = result.rec_attr is not None
    rec_attr = np.asarray(result.rec_attr) if has_attr else None
    n_rec = rec_pos.shape[2]
    points = np.zeros((n_particles, n_rec, 3), dtype=np.float64)
    vels = np.zeros((n_particles, n_rec, 3), dtype=np.float64)
    attrs = np.zeros((n_particles, n_rec, 3), dtype=np.float64) \
        if has_attr else None
    points[:, 0] = seeds
    flat_ids = rec_ids.reshape(-1, n_rec)
    flat_pos = rec_pos.reshape(-1, n_rec, 3)
    flat_vel = rec_vel.reshape(-1, n_rec, 3)
    flat_attr = rec_attr.reshape(-1, n_rec, 3) if has_attr else None
    for r in range(n_rec):
        ids = flat_ids[:, r]
        ok = ids >= 0
        points[ids[ok], r] = flat_pos[ok, r]
        vels[ids[ok], r] = flat_vel[ok, r]
        if has_attr:
            attrs[ids[ok], r] = flat_attr[ok, r]

    final_pos = np.zeros((n_particles, 3))
    final_depth = np.zeros(n_particles)
    fids = np.asarray(result.final_ids).reshape(-1)
    ok = fids >= 0
    final_pos[fids[ok]] = np.asarray(result.final_pos).reshape(-1, 3)[ok]
    final_depth[fids[ok]] = np.asarray(result.final_depth).reshape(-1)[ok]
    return points, vels, attrs, final_pos, final_depth
