"""Geodetic conversion unit tests (reference GeoConverter semantics)."""

import numpy as np
import jax.numpy as jnp

from mops_jax import geo
from mops_jax.config import EARTH_RADIUS


def test_latlon_xyz_roundtrip():
    lat = np.deg2rad(np.array([-80.0, -30.0, 0.0, 45.0, 89.0]))
    lon = np.deg2rad(np.array([-170.0, -10.0, 0.0, 90.0, 179.0]))
    xyz = geo.latlon_rad_to_xyz(lat, lon)
    lat2, lon2 = geo.xyz_to_latlon_rad(xyz)
    np.testing.assert_allclose(lat2, lat, atol=1e-12)
    np.testing.assert_allclose(lon2, lon, atol=1e-12)
    np.testing.assert_allclose(np.linalg.norm(np.asarray(xyz), axis=-1),
                               EARTH_RADIUS, rtol=1e-15)


def test_enu_roundtrip():
    p = np.asarray(geo.latlon_rad_to_xyz(np.deg2rad(33.0), np.deg2rad(-120.0)))
    vel = np.asarray(geo.enu_velocity_to_xyz(p, 1.5, -0.7, 0.0))
    uz, um = geo.xyz_velocity_to_enu(p, vel)
    np.testing.assert_allclose(float(uz), 1.5, atol=1e-12)
    np.testing.assert_allclose(float(um), -0.7, atol=1e-12)


def test_enu_pole_singularity():
    p = np.array([0.0, 0.0, EARTH_RADIUS])
    uz, um = geo.xyz_velocity_to_enu(p, np.array([1.0, 2.0, 3.0]))
    assert float(uz) == 0.0 and float(um) == 0.0
    v = np.asarray(geo.enu_velocity_to_xyz(p, 5.0, 5.0, 2.0))
    np.testing.assert_allclose(v, [0.0, 0.0, 2.0], atol=0)


def test_rotate_around_axis_quarter_turn():
    p = np.array([1.0, 0.0, 0.0])
    axis = np.array([0.0, 0.0, 2.0])      # unnormalized on purpose
    out = np.asarray(geo.rotate_around_axis(p, axis, np.pi / 2))
    np.testing.assert_allclose(out, [0.0, 1.0, 0.0], atol=1e-15)


def test_rotate_zero_axis_nans():
    # Deliberate reference behavior: zero axis -> NaN (SYCLKernel.cpp:181-209)
    out = np.asarray(geo.rotate_around_axis(
        np.array([1.0, 0.0, 0.0]), np.array([0.0, 0.0, 0.0]), 0.1))
    assert np.isnan(out).all()


def test_pixel_mapping_matches_reference_formula():
    # row 0 = max_lat; divisor = full image extent (GeoConverter.hpp:28-29)
    lat, lon = geo.pixel_to_latlon_deg(0.0, 0.0, 360, 180, -90, 90, -180, 180)
    assert float(lat) == 90.0 and float(lon) == -180.0
    lat, lon = geo.pixel_to_latlon_deg(90.0, 180.0, 360, 180, -90, 90, -180, 180)
    assert float(lat) == 0.0 and float(lon) == 0.0
