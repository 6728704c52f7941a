"""Multi-chip scaling: particle-axis data parallelism over a device mesh.

The reference's only distribution story is MPI ranks running IDENTICAL work
(reference CLI/main.cpp:58-66,276-284 -- no decomposition).  This design
instead shards the PARTICLE axis across devices with ``jax.sharding``: the
MPAS mesh + solution fields are replicated (they are read-only gather
tables), particle state is split N/devices per device, and the advection scan
partitions automatically with ZERO cross-device communication --
embarrassingly parallel.

Multi-host: call ``jax.distributed.initialize()`` first; the same NamedSharding
spans all hosts' devices and each host feeds its local shard.

Mesh domain decomposition with particle migration over all_to_all is in
parallel/migrate.py.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..advect import RawTrajectories, run_advection
from ..mesh import MPASMesh
from ..settings import TrajectorySettings
from ..solution import SolutionFields

PARTICLE_AXIS = "particles"


def device_mesh(n_devices: Optional[int] = None) -> Mesh:
    """1-D device mesh over the first n (default: all) devices."""
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return jax.make_mesh((len(devs),), (PARTICLE_AXIS,), devices=devs)


def _put(a, sh: NamedSharding):
    """device_put that also works under multi-process jax.distributed: every
    process passes the SAME full-size host array and contributes only its
    addressable shards."""
    import numpy as _np
    if jax.process_count() > 1:
        a = _np.asarray(a)
        # global_shape == local shape: the full array is passed on every
        # process and each contributes its addressable slices of it
        return jax.make_array_from_process_local_data(
            sh, a, global_shape=a.shape)
    return jax.device_put(a, sh)


def shard_particles(mesh: Mesh, *arrays):
    """Place per-particle arrays with the leading axis split across the mesh."""
    sh = NamedSharding(mesh, P(PARTICLE_AXIS))
    return tuple(_put(a, sh) for a in arrays)


def replicate(mesh: Mesh, tree):
    """Replicate a pytree (MPAS mesh / solution tables) on every device."""
    sh = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda a: _put(a, sh), tree)


def pad_to_multiple(arr: np.ndarray, multiple: int, fill=0.0):
    """Pad axis 0 to a multiple of the device count; returns (padded, n_real)."""
    n = arr.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad_width = [(0, rem)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=fill), n


def run_advection_sharded(mpas_mesh: MPASMesh, front: SolutionFields,
                          seeds: np.ndarray, cells: np.ndarray,
                          settings: TrajectorySettings,
                          dmesh: Optional[Mesh] = None,
                          back: Optional[SolutionFields] = None,
                          dtype=None) -> RawTrajectories:
    """run_advection with the particle axis sharded across ``dmesh``.

    The advection core runs inside ``shard_map``: every device advances its
    local particle shard against replicated mesh/solution tables (zero
    collectives).  Dead padding particles (cell=-1) round N up to the device
    count; outputs are sliced back to the real particle count."""
    import functools
    import jax.numpy as jnp
    from jax import shard_map

    from ..advect import _scan_core, advection_schedule, stacked_vertex_attrs

    dmesh = dmesh or device_mesh()
    n_dev = dmesh.devices.size
    pathline = back is not None

    real = jnp.asarray(mpas_mesh.cell_xyz).dtype if dtype is None \
        else jnp.dtype(dtype)
    if jnp.asarray(mpas_mesh.cell_xyz).dtype != real:
        mpas_mesh = mpas_mesh.astype(real)
    if front.vertex_ztop.dtype != real:
        front = front.astype(real)
    if back is not None and back.vertex_ztop.dtype != real:
        back = back.astype(real)

    seeds_p, n_real = pad_to_multiple(np.asarray(seeds), n_dev)
    cells_p, _ = pad_to_multiple(np.asarray(cells, dtype=np.int32), n_dev,
                                 fill=-1)
    depths = settings.effective_depths(n_real)
    depths_p, _ = pad_to_multiple(np.asarray(depths, dtype=np.float32), n_dev)

    use_attrs = pathline and len(front.cell_attrs) > 1 \
        and len(back.cell_attrs) > 0
    attr_front = stacked_vertex_attrs(front) if use_attrs else None
    attr_back = stacked_vertex_attrs(back) if use_attrs else None

    xs = advection_schedule(settings, pathline, real)

    mpas_r = replicate(dmesh, mpas_mesh)
    front_r = replicate(dmesh, front)
    back_r = replicate(dmesh, back) if back is not None else None
    # schedule arrays + stacked attrs must be explicitly replicated too so
    # every jit input carries a global sharding under multi-process jax
    attr_front = replicate(dmesh, attr_front)
    attr_back = replicate(dmesh, attr_back)
    xs = replicate(dmesh, xs)
    seeds_s, cells_s, depths_s = shard_particles(
        dmesh, jnp.asarray(seeds_p, dtype=real),
        jnp.asarray(cells_p), jnp.asarray(depths_p))

    core = functools.partial(
        _scan_core,
        method=settings.method, fail_mode=settings.fail_mode,
        pathline=pathline, duration=int(settings.simulation_duration),
        n_records=settings.n_records, exact_clamp=True)

    p_part = P(PARTICLE_AXIS)
    p_rep = P()
    mapped = shard_map(
        core, mesh=dmesh,
        in_specs=(p_rep, p_rep, p_rep, p_rep, p_rep,      # tables
                  p_part, p_part, p_part,                  # particle state
                  p_rep, p_rep, p_rep, p_rep, p_rep),      # schedule xs
        out_specs=p_part)
    raw = jax.jit(mapped)(mpas_r, front_r, back_r, attr_front, attr_back,
                          seeds_s, depths_s, cells_s, *xs)

    if n_real == seeds_p.shape[0]:
        return raw
    # The padded tail crosses shard boundaries, so a device-side slice has no
    # unambiguous sharding; results are final outputs, slice on the host.
    host = jax.device_get(raw)
    sl = slice(0, n_real)
    return RawTrajectories(
        points=host.points[sl], velocities=host.velocities[sl],
        attrs=None if host.attrs is None else host.attrs[sl],
        final_position=host.final_position[sl],
        final_depth=host.final_depth[sl], final_cell=host.final_cell[sl],
        alive=host.alive[sl])
