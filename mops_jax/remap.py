"""Rasterization ops: fixed-depth remap, fixed-layer map, fixed-latitude section.

Vectorized re-implementations of the reference visualizer kernels, following
the CPU/TBB backend's well-defined semantics (the SYCL fixed-depth kernel reads
ztop[-1] out of bounds in its layer-0 path; TBB clamps -- reference
src/CPU/TBB/Kernel/MPASOVisualizerKernels.cpp:403 vs
src/GPU/SYCL/MPASOVisualizerSYCL.cpp:422).

Reference quirk preserved (default): after the layer scan, fixed-depth remap
overrides local_layer to 0 whenever DEPTH <= ztop[0] -- which is true for any
depth below the surface -- so the reference image is always the average of
layer-0/1 velocities with t = 0.5 (TBB kernel :392-412).  Pass
``depth_accurate=True`` for the evidently-intended behavior that uses the
layer found by the scan.

The per-pixel KD lookup stays on host (scipy cKDTree), exactly where the
reference runs it (SYCLKernel::SearchKDTree is a serial host loop,
src/GPU/SYCL/Kernel/SYCLKernel.cpp:5-22); the per-pixel math is one jitted
batch over all pixels.
"""

from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from . import geo
from .advect import (_clamp_profile, _gather_cell_vertices, _in_mesh,
                     _weighted_vertex_value, weighted_profile)
from .config import EARTH_RADIUS
from .field import Field
from .interp import wachspress_weights
from .mesh import MPASMesh
from .settings import VisualizationSettings
from .solution import SolutionFields


def _pixel_positions(cfg: VisualizationSettings):
    """Pixel-center lat/lon -> XYZ for the full image, row 0 = max_lat."""
    w, h = cfg.image_width, cfg.image_height
    i = np.arange(h, dtype=np.float64)
    j = np.arange(w, dtype=np.float64)
    ii, jj = np.meshgrid(i, j, indexing="ij")
    lat, lon = geo.pixel_to_latlon_rad(
        ii, jj, w, h, cfg.lat_range[0], cfg.lat_range[1],
        cfg.lon_range[0], cfg.lon_range[1])
    xyz = geo.latlon_rad_to_xyz(lat, lon, EARTH_RADIUS)
    return np.asarray(xyz).reshape(-1, 3)


# pixel -> cell host KD query cache, keyed on (search structure, image
# geometry): at the reference demo size (3601x1801) the 6.5M-pixel query
# costs seconds and is identical across calls/timesteps on the same mesh.
# Values keep a strong ref to the search object so the id() key stays valid.
_PIXCELL_CACHE: dict = {}
_PIXCELL_CAP = 8


def _pixel_cells(field: Field, cfg: VisualizationSettings, kind: str,
                 builder):
    """(pix, cells) for this (mesh, image geometry), cached across calls."""
    key = (kind, id(field.search), cfg.image_width, cfg.image_height,
           tuple(cfg.lat_range), tuple(cfg.lon_range),
           float(cfg.fixed_latitude) if kind == "regrid" else 0.0)
    hit = _PIXCELL_CACHE.get(key)
    if hit is None:
        pix = builder()
        cells = field.search.query(pix)
        if len(_PIXCELL_CACHE) >= _PIXCELL_CAP:
            _PIXCELL_CACHE.pop(next(iter(_PIXCELL_CACHE)))
        hit = _PIXCELL_CACHE[key] = (field.search, pix, cells)
    return hit[1], hit[2]


@functools.partial(jax.jit, static_argnames=("depth_accurate", "use_attrs"))
def _fixed_depth_batch(mesh: MPASMesh, sol: SolutionFields, attrs,
                       pos, cell, depth_neg, *, depth_accurate: bool,
                       use_attrs: bool):
    """Per-pixel fixed-depth evaluation (TBB kernel :288-469)."""
    vids, nv, lane_valid, vids_ok, vpos = _gather_cell_vertices(mesh, cell)
    cell_ok = (cell >= 0) & (cell < mesh.n_cells)
    in_mesh = _in_mesh(pos, vpos, nv, lane_valid) & cell_ok & vids_ok

    w = wachspress_weights(pos, vpos, nv)
    z = weighted_profile(w, sol.vertex_ztop[vids])
    z = _clamp_profile(z, True)
    L = z.shape[1]

    z_surf = jnp.maximum(z[:, 0], z[:, -1])
    z_bot = jnp.minimum(z[:, 0], z[:, -1])
    epsd = jnp.maximum(1e-6, 1e-8 * jnp.abs(z_surf - z_bot))
    in_column = (depth_neg <= z_surf + epsd) & (depth_neg >= z_bot - epsd)

    top = jnp.maximum(z[:, :-1], z[:, 1:])
    bot = jnp.minimum(z[:, :-1], z[:, 1:])
    cond = (depth_neg[:, None] <= top + 1e-8) & (depth_neg[:, None] >= bot - 1e-8)
    found = jnp.any(cond, axis=1)
    first = jnp.argmax(cond, axis=1).astype(jnp.int32) + 1
    layer = jnp.where(found, first, -1)
    if not depth_accurate:
        # reference override (TBB kernel :392-394)
        layer = jnp.where(depth_neg <= z[:, 0], 0, layer)
    ok = in_mesh & in_column & (layer >= 0)
    layer = jnp.clip(layer, 0, L - 1)

    top_i = jnp.take_along_axis(z, jnp.maximum(0, layer - 1)[:, None], 1)[:, 0]
    bot_i = jnp.take_along_axis(z, layer[:, None], 1)[:, 0]
    top_s = jnp.maximum(top_i, bot_i)
    bot_s = jnp.minimum(top_i, bot_i)
    denom = top_s - bot_s
    t = jnp.where(denom > 1e-12, (depth_neg - bot_s) / jnp.where(denom == 0, 1.0, denom), 0.5)

    jt = jnp.clip(layer - 1, 0, L - 1)
    jb = jnp.minimum(jt + 1, L - 1)
    v_top = _weighted_vertex_value(sol.vertex_velocity, vids, jt, w)
    v_bot = _weighted_vertex_value(sol.vertex_velocity, vids, jb, w)
    mtop = jnp.linalg.norm(v_top, axis=-1)
    mbot = jnp.linalg.norm(v_bot, axis=-1)
    lerp = (1.0 - t[:, None]) * v_bot + t[:, None] * v_top
    final_vel = jnp.where((mtop < 1e-12)[:, None] & (mbot < 1e-12)[:, None],
                          0.0,
                          jnp.where((mtop < 1e-12)[:, None], v_bot,
                                    jnp.where((mbot < 1e-12)[:, None], v_top, lerp)))

    u_east, v_north = geo.xyz_velocity_to_enu(pos, final_vel)
    spd = jnp.sqrt(u_east ** 2 + v_north ** 2)
    vel_img = jnp.stack([u_east, v_north, spd], axis=-1)
    nanv = jnp.full_like(vel_img, jnp.nan)
    vel_img = jnp.where(ok[:, None], vel_img, nanv)

    attr_img = None
    if use_attrs and attrs is not None:
        # All active attributes (reference MAX_ATTRS=8); the caller fans them
        # out into ceil(A/3) three-channel images like MOPSApp::runRemapping
        # (reference src/Core/MOPSApp.cpp:176-185).
        aj = jnp.clip(layer - 1, 0, attrs.shape[1] - 1)
        vals = [_weighted_vertex_value(attrs[..., ai], vids, aj, w)
                for ai in range(min(attrs.shape[-1], 8))]
        while len(vals) % 3:
            vals.append(jnp.zeros_like(spd))
        attr_img = jnp.stack(vals, axis=-1)                # (N, 3*ceil(A/3))
        attr_img = jnp.where(ok[:, None], attr_img, jnp.nan)
    return vel_img, attr_img


def run_remapping(field: Field, cfg: VisualizationSettings,
                  depth_accurate: bool = False) -> List[np.ndarray]:
    """Fixed-depth remap -> [velocity image (h, w, 3), attr images...].

    Mirrors MOPSApp::runRemapping + TBB VisualizeFixedDepth: image[0] carries
    (u_east, v_north, speed); images[1..] pack the active named attributes
    (name order) three per image, ceil(nAttrs/3) images total, unused channels
    zero (reference src/Core/MOPSApp.cpp:171-196 allocates the groups; the TBB
    kernel :238-471 fills attrs 0-1 of group 0 -- this build fills every
    group).  All pixels are one jitted batch (the 3601x1801 demo image peaks
    under 15 GB in float64), and the host pixel->cell KD query is cached per
    (mesh, image geometry)."""
    mesh, sol = field.device_tables()
    w, h = cfg.image_width, cfg.image_height
    pix, cells = _pixel_cells(field, cfg, "remap",
                              lambda: _pixel_positions(cfg))

    use_attrs = len(sol.cell_attrs) > 0   # attr_size > 0 -> groups (reference)
    attrs = None
    if use_attrs:
        from .advect import stacked_vertex_attrs
        attrs = stacked_vertex_attrs(sol)

    real = jnp.asarray(mesh.cell_xyz).dtype
    depth_neg = jnp.full(pix.shape[0], -float(cfg.fixed_depth), dtype=real)
    vel_img, attr_img = _fixed_depth_batch(
        mesh, sol, attrs, jnp.asarray(pix, dtype=real), jnp.asarray(cells),
        depth_neg, depth_accurate=depth_accurate, use_attrs=use_attrs)

    out = [np.asarray(vel_img).reshape(h, w, 3)]
    if attr_img is not None:
        groups = np.asarray(attr_img).reshape(h, w, -1)
        for g in range(groups.shape[-1] // 3):
            out.append(groups[..., 3 * g:3 * g + 3])
    return out


@jax.jit
def _fixed_layer_batch(mesh: MPASMesh, sol: SolutionFields, pos, cell, layer):
    """Per-pixel fixed-layer evaluation (TBB VisualizeFixedLayer :141-236)."""
    vids, nv, lane_valid, vids_ok, vpos = _gather_cell_vertices(mesh, cell)
    cell_ok = (cell >= 0) & (cell < mesh.n_cells)
    ok = _in_mesh(pos, vpos, nv, lane_valid) & cell_ok & vids_ok
    w = wachspress_weights(pos, vpos, nv)
    vel = _weighted_vertex_value(sol.vertex_velocity, vids,
                                 jnp.broadcast_to(layer, cell.shape), w)
    u_east, v_north = geo.xyz_velocity_to_enu(pos, vel)
    img = jnp.stack([u_east, v_north, jnp.zeros_like(u_east)], axis=-1)
    return jnp.where(ok[:, None], img, jnp.nan)


def run_fixed_layer(field: Field, cfg: VisualizationSettings) -> np.ndarray:
    """Fixed-layer map -> (h, w, 3) image of (zonal, meridional, 0)."""
    mesh, sol = field.device_tables()
    w, h = cfg.image_width, cfg.image_height
    pix, cells = _pixel_cells(field, cfg, "remap",
                              lambda: _pixel_positions(cfg))
    L = sol.n_layers
    layer = int(np.clip(cfg.fixed_layer, 0, L - 1))
    real = jnp.asarray(mesh.cell_xyz).dtype

    img = _fixed_layer_batch(mesh, sol, jnp.asarray(pix, dtype=real),
                             jnp.asarray(cells), jnp.asarray(layer))
    return np.asarray(img).reshape(h, w, 3)


def _is_land_sign_test(mesh: MPASMesh, pos, cell):
    """MPASOField::isOnOcean's sign-consistency test (reference
    src/Core/MPASOField.cpp:36-81): d_k = dot(cross(A,B), p - A); land when the
    signs of d_k disagree.  (The reference name is inverted: it returns true
    ON LAND.)"""
    vids, nv, lane_valid, vids_ok, vpos = _gather_cell_vertices(mesh, cell)
    K = vpos.shape[1]
    lane = jnp.arange(K)[None, :]
    nxt = jnp.where(lane + 1 >= nv[:, None], 0, lane + 1)
    b = jnp.take_along_axis(vpos, nxt[..., None], axis=1)
    normal = jnp.cross(-vpos, -b)                        # cross(O-A, O-B)
    d = jnp.sum(normal * (pos[:, None, :] - vpos), axis=-1)
    sign0 = jnp.where(d[:, 0] > 0, 1.0, -1.0)
    signs = jnp.where(d > 0, 1.0, -1.0)
    disagree = jnp.any(jnp.where(lane_valid, signs != sign0[:, None], False), axis=1)
    return disagree


@jax.jit
def _fixed_lat_batch(mesh: MPASMesh, sol: SolutionFields, pos, cell, depth_neg):
    """Per-pixel fixed-latitude section (TBB VisualizeFixedLatitude :473-651)."""
    vids, nv, lane_valid, vids_ok, vpos = _gather_cell_vertices(mesh, cell)
    cell_ok = (cell >= 0) & (cell < mesh.n_cells)
    is_land = _is_land_sign_test(mesh, pos, cell)
    ok = cell_ok & vids_ok & ~is_land

    w = wachspress_weights(pos, vpos, nv)
    z = weighted_profile(w, sol.vertex_ztop[vids])
    z = _clamp_profile(z, True)
    L = z.shape[1]

    eps = 1e-6
    in_col = (depth_neg <= z[:, 0] + eps) & (depth_neg >= z[:, -1] - eps)
    top = jnp.maximum(z[:, :-1], z[:, 1:])
    bot = jnp.minimum(z[:, :-1], z[:, 1:])
    cond = (depth_neg[:, None] <= top + eps) & (depth_neg[:, None] >= bot - eps)
    found = jnp.any(cond, axis=1)
    layer = jnp.argmax(cond, axis=1).astype(jnp.int32) + 1
    ok = ok & in_col & found
    layer = jnp.clip(layer, 1, L - 1)

    z_dn = jnp.take_along_axis(z, layer[:, None], 1)[:, 0]
    z_up = jnp.take_along_axis(z, (layer - 1)[:, None], 1)[:, 0]
    up_s = jnp.maximum(z_up, z_dn)
    dn_s = jnp.minimum(z_up, z_dn)
    denom = up_s - dn_s
    ok = ok & (jnp.abs(denom) >= 1e-30)
    t = (depth_neg - dn_s) / jnp.where(denom == 0, 1.0, denom)

    v_up = _weighted_vertex_value(sol.vertex_velocity, vids, layer - 1, w)
    v_dn = _weighted_vertex_value(sol.vertex_velocity, vids, layer, w)
    vel = (1.0 - t[:, None]) * v_dn + t[:, None] * v_up
    u_east, v_north = geo.xyz_velocity_to_enu(pos, vel)
    img = jnp.stack([u_east, v_north, jnp.zeros_like(u_east)], axis=-1)
    return jnp.where(ok[:, None], img, jnp.nan)


def run_regrid(field: Field, cfg: VisualizationSettings) -> np.ndarray:
    """Fixed-latitude depth x longitude section -> (h, w, 3) image.

    Depth rows span refBottomDepth.front()..back(); columns span the lon range
    (reference TBB VisualizeFixedLatitude :473-651, exposed as MOPS_RunReGrid
    via tools/pyMOPS/bindings.cpp:305-312)."""
    mesh, sol = field.device_tables()
    if mesh.ref_bottom_depth is None:
        raise ValueError("regrid requires refBottomDepth")
    rbd = np.asarray(mesh.ref_bottom_depth)
    w, h = cfg.image_width, cfg.image_height
    min_depth, max_depth = float(rbd[0]), float(rbd[-1])
    min_lon, max_lon = cfg.lon_range
    i_step = (max_depth - min_depth) / (h - 1) if h > 1 else 0.0
    j_step = (max_lon - min_lon) / (w - 1) if w > 1 else 0.0

    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    depth_plot = min_depth + ii * i_step
    lon = np.deg2rad(min_lon + jj * j_step)
    lat = np.deg2rad(cfg.fixed_latitude)

    def build():
        return np.asarray(geo.latlon_rad_to_xyz(
            np.full_like(lon, lat), lon, EARTH_RADIUS)).reshape(-1, 3)

    xyz, cells = _pixel_cells(field, cfg, "regrid", build)
    depth_neg = -np.abs(depth_plot).ravel()

    real = jnp.asarray(mesh.cell_xyz).dtype
    img = _fixed_lat_batch(mesh, sol, jnp.asarray(xyz, dtype=real),
                           jnp.asarray(cells),
                           jnp.asarray(depth_neg, dtype=real))
    return np.asarray(img).reshape(h, w, 3)
