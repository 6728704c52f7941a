"""Trajectory finalization / NaN-cleanup semantics tests (reference
src/Common/TrajectoryCommon.h + test/test_trajector.cpp scenarios)."""

import numpy as np

import mops_jax as mt


def _cfg(n_rec=4):
    return mt.TrajectorySettings(delta_t=60, simulation_duration=60 * n_rec,
                                 record_t=60, depth=10.0)


def test_all_valid_roundtrip():
    seeds = np.zeros((1, 3)) + [1.0, 0.0, 0.0]
    pts = np.arange(12, dtype=np.float64).reshape(1, 4, 3)
    vels = np.ones((1, 4, 3))
    lines = mt.finalize_trajectories(seeds, pts, vels, _cfg())
    line = lines[0]
    assert line.points.shape == (5, 3)
    np.testing.assert_array_equal(line.points[0], seeds[0])
    np.testing.assert_array_equal(line.points[1:], pts[0])
    # velocity: R records + one trailing zero (reference resize-append)
    np.testing.assert_array_equal(line.velocity[:4], vels[0])
    np.testing.assert_array_equal(line.velocity[4], 0.0)
    np.testing.assert_array_equal(line.last_point, pts[0, -1])


def test_nan_middle_padded_with_last_valid():
    """Reference test/test_trajector.cpp NaN-middle case: truncate at first
    non-finite, pad with last valid, zero velocity there."""
    seeds = np.array([[1.0, 0.0, 0.0]])
    pts = np.ones((1, 4, 3))
    pts[0, 2] = np.nan                       # first bad index k=3 (incl. seed)
    vels = np.full((1, 4, 3), 7.0)
    lines = mt.finalize_trajectories(seeds, pts, vels, _cfg())
    line = lines[0]
    assert np.isfinite(line.points).all()
    np.testing.assert_array_equal(line.points[3], line.points[2])
    np.testing.assert_array_equal(line.points[4], line.points[2])
    np.testing.assert_array_equal(line.velocity[2:], 0.0)
    np.testing.assert_array_equal(line.velocity[:2], 7.0)
    np.testing.assert_array_equal(line.last_point, line.points[2])


def test_nan_first_point():
    seeds = np.array([[np.nan, 0.0, 0.0]])
    pts = np.ones((1, 3, 3))
    vels = np.ones((1, 3, 3))
    lines = mt.finalize_trajectories(seeds, pts, vels, _cfg(3))
    line = lines[0]
    # k == 0: all points become the (NaN-x) first point, velocities zeroed
    assert np.isnan(line.points[:, 0]).all()
    np.testing.assert_array_equal(line.points[:, 1:], 0.0)
    np.testing.assert_array_equal(line.velocity, 0.0)


def test_reindex_preserves_order():
    seeds = np.zeros((3, 3))
    pts = np.zeros((3, 2, 3))
    vels = np.zeros((3, 2, 3))
    lines = mt.finalize_trajectories(seeds, pts, vels, _cfg(2))
    assert [l.line_id for l in lines] == [0, 1, 2]


def test_with_attrs_temperature_is_velocity_x():
    """Reference bug preserved: FinalizeTrajectoryLinesWithAttrs stores
    velocity.x/.y as temperature/salinity (TrajectoryCommon.h:179-180)."""
    seeds = np.zeros((1, 3))
    pts = np.ones((1, 2, 3))
    vels = np.arange(6, dtype=np.float64).reshape(1, 2, 3)
    attrs = np.full((1, 2, 3), 9.0)
    lines = mt.finalize_trajectories(seeds, pts, vels, _cfg(2),
                                     attrs=attrs, with_attrs=True)
    line = lines[0]
    np.testing.assert_array_equal(line.temperature[:2], vels[0, :, 0])
    np.testing.assert_array_equal(line.salinity[:2], vels[0, :, 1])
    np.testing.assert_array_equal(line.attrs[:2], attrs[0])
