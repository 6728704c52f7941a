"""Geodetic conversions (vectorized JAX).

Re-derivation of the reference GeoConverter (reference src/Utils/GeoConverter.hpp)
as pure array functions.  All functions accept arbitrary leading batch dims.

Conventions (identical to reference):
- lat/lon as (lat, lon) pairs; "radians" vs "degrees" suffixed explicitly.
- XYZ on the sphere with z = r*sin(lat); lon measured from +x toward +y.
- ENU velocity: (zonal/east, meridional/north); pole singularity -> zeros.
"""

from __future__ import annotations

import jax.numpy as jnp

from .config import EARTH_RADIUS


def pixel_to_latlon_deg(i, j, width, height, min_lat, max_lat, min_lon, max_lon):
    """Image pixel (row i, col j) -> (lat, lon) degrees.

    Mirrors GeoConverter::convertPixelToLatLonToDegrees
    (reference src/Utils/GeoConverter.hpp:35-58): row 0 is max_lat, and the
    divisor is the full height/width (not height-1), matching the reference's
    half-open pixel grid.
    """
    lat = max_lat - (i / height) * (max_lat - min_lat)
    lon = (j / width) * (max_lon - min_lon) + min_lon
    return lat, lon


def pixel_to_latlon_rad(i, j, width, height, min_lat, max_lat, min_lon, max_lon):
    lat, lon = pixel_to_latlon_deg(i, j, width, height, min_lat, max_lat, min_lon, max_lon)
    return jnp.deg2rad(lat), jnp.deg2rad(lon)


def latlon_rad_to_xyz(lat, lon, r=EARTH_RADIUS):
    """(lat, lon) radians -> XYZ (reference GeoConverter.hpp:107-125)."""
    clat = jnp.cos(lat)
    x = r * clat * jnp.cos(lon)
    y = r * clat * jnp.sin(lon)
    z = r * jnp.sin(lat)
    return jnp.stack([x, y, z], axis=-1)


def xyz_to_latlon_rad(p):
    """XYZ -> (lat, lon) radians (reference GeoConverter.hpp:127-150)."""
    r = jnp.linalg.norm(p, axis=-1)
    lat = jnp.arcsin(p[..., 2] / r)
    lon = jnp.arctan2(p[..., 1], p[..., 0])
    return lat, lon


def _enu_coeffs(p):
    """(slon, clon, slat, clat, at_pole) geometric coefficients at point p."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    rxy = jnp.sqrt(x * x + y * y)
    rxyz = jnp.sqrt(x * x + y * y + z * z)
    at_pole = (x == 0.0) & (y == 0.0)
    safe_rxy = jnp.where(at_pole, 1.0, rxy)
    slon = y / safe_rxy
    clon = x / safe_rxy
    slat = z / jnp.where(rxyz == 0.0, 1.0, rxyz)
    clat = rxy / jnp.where(rxyz == 0.0, 1.0, rxyz)
    return slon, clon, slat, clat, at_pole


def xyz_velocity_to_enu(p, vel):
    """XYZ velocity -> (zonal, meridional) (reference GeoConverter.hpp:200-223)."""
    slon, clon, slat, clat, at_pole = _enu_coeffs(p)
    vx, vy, vz = vel[..., 0], vel[..., 1], vel[..., 2]
    uzon = -slon * vx + clon * vy
    umer = -slat * (clon * vx + slon * vy) + clat * vz
    zero = jnp.zeros_like(uzon)
    return jnp.where(at_pole, zero, uzon), jnp.where(at_pole, zero, umer)


def enu_velocity_to_xyz(p, uzon, umer, uup=0.0):
    """(zonal, meridional, up) -> XYZ velocity (reference GeoConverter.hpp:225-250)."""
    slon, clon, slat, clat, at_pole = _enu_coeffs(p)
    uup = jnp.asarray(uup, dtype=p.dtype)
    vx = -slon * uzon - slat * clon * umer + clon * clat * uup
    vy = clon * uzon - slat * slon * umer + slon * clat * uup
    vz = clat * umer + slat * uup
    zero = jnp.zeros_like(vx)
    vx = jnp.where(at_pole, zero, vx)
    vy = jnp.where(at_pole, zero, vy)
    vz = jnp.where(at_pole, jnp.broadcast_to(uup, vz.shape), vz)
    return jnp.stack([vx, vy, vz], axis=-1)


def rotation_axis(pos, vel):
    """pos x vel (reference SYCLKernel::CalcRotationAxis)."""
    return jnp.cross(pos, vel)


def rotate_around_axis(point, axis, theta):
    """Rodrigues rotation of `point` about normalized `axis` by `theta` radians.

    Mirrors SYCLKernel::CalcPositionAfterRotation (reference
    src/GPU/SYCL/Kernel/SYCLKernel.cpp:181-209): the axis is normalized by its
    length WITHOUT a zero guard, so a zero axis yields NaN -- deliberate, the
    reference relies on downstream NaN cleanup.
    """
    return point + rotation_delta(point, axis, theta)


def rotation_delta(point, axis, theta):
    """rotate_around_axis(point, axis, theta) - point, formed as (R - I) p so
    that a small rotation of an Earth-radius point keeps its digits: in
    float32 the rotated point itself holds only ~0.5 m.  1 - cos(theta) is
    taken as 2 sin^2(theta / 2), which does not cancel."""
    st = jnp.sin(theta)
    omc = 2.0 * jnp.sin(0.5 * theta) ** 2
    u = axis / jnp.linalg.norm(axis, axis=-1, keepdims=True)
    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    px, py, pz = point[..., 0], point[..., 1], point[..., 2]
    rx = (ux * ux - 1.0) * omc * px + (ux * uy * omc - uz * st) * py + (ux * uz * omc + uy * st) * pz
    ry = (uy * ux * omc + uz * st) * px + (uy * uy - 1.0) * omc * py + (uy * uz * omc - ux * st) * pz
    rz = (uz * ux * omc - uy * st) * px + (uz * uy * omc + ux * st) * py + (uz * uz - 1.0) * omc * pz
    return jnp.stack([rx, ry, rz], axis=-1)
