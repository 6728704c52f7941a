"""End-to-end API tests: the reference CLI pipeline on a synthetic mesh."""

import numpy as np
import pytest

import mops_jax as mt
from mops_jax import api


@pytest.fixture()
def app(mesh, raw_fields):
    a = api.MOPSApp()
    a.init("cpu", precision="fp64")
    a.begin()
    a.add_grid(mesh)
    a.add_solution(1, dict(raw_fields), timestamp="t1", timestep=0)
    raw2 = {k: np.asarray(v) * (1.1 if k.startswith("velocity") else 1.0)
            for k, v in raw_fields.items()}
    a.add_solution(2, raw2, timestamp="t2", timestep=1)
    a.end()
    return a


def test_state_machine_guards(mesh):
    a = api.MOPSApp()
    with pytest.raises(RuntimeError):
        a.end()                      # End outside Configuring
    with pytest.raises(RuntimeError):
        a.run_streamline(mt.TrajectorySettings(), np.zeros((1, 3)))


def test_solution_id_fnv1a():
    # FNV-1a 32-bit of "x_0": independently computed
    key = b"x_0"
    h = 2166136261
    for c in key:
        h = ((h ^ c) * 16777619) & 0xFFFFFFFF
    expect = h - (1 << 32) if h >= (1 << 31) else h
    assert api.solution_id("x", 0) == expect


def test_streamline_end_to_end(app):
    pts = mt.MOPS_GenerateSamplePoints.__wrapped__ if False else None
    seeds = app.generate_sample_points(mt.SamplingSettings(
        sample_range=(5, 5), lat_range=(-30, 30), lon_range=(-60, 60),
        depth=100.0))
    assert seeds.shape[1] == 3 and len(seeds) >= 9
    cfg = mt.TrajectorySettings(delta_t=600, simulation_duration=600 * 20,
                                record_t=1200, depth=100.0,
                                fail_mode=mt.FailMode.ZERO)
    app.active_attribute(1)
    lines = app.run_streamline(cfg, seeds)
    assert len(lines) == len(seeds)
    assert lines[0].points.shape == (cfg.n_records + 1, 3)
    assert np.isfinite([l.last_point for l in lines]).all()


def test_pathline_advances_seeds(app):
    seeds = app.generate_sample_points(mt.SamplingSettings(
        sample_range=(4, 4), lat_range=(-30, 30), lon_range=(-60, 60),
        depth=100.0))
    before = seeds.copy()
    app.active_attribute(1, 2)
    cfg = mt.TrajectorySettings(delta_t=600, simulation_duration=600 * 12,
                                record_t=1200, depth=100.0,
                                fail_mode=mt.FailMode.ZERO)
    lines = app.run_pathline(cfg, seeds)
    assert len(lines) == len(before)
    # reference semantics: seeds updated in place to lastPoint
    moved = np.linalg.norm(seeds - before, axis=1)
    assert (moved > 0).any()
    for i, line in enumerate(lines):
        np.testing.assert_array_equal(seeds[i], line.last_point)


def test_pathline_requires_two_solutions(app):
    app.active_attribute(1)
    with pytest.raises(RuntimeError):
        app.run_pathline(mt.TrajectorySettings(), np.zeros((1, 3)))


def test_remapping_end_to_end(app):
    app.active_attribute(1)
    cfg = mt.VisualizationSettings(image_width=64, image_height=32,
                                   fixed_depth=100.0)
    imgs = app.run_remapping(cfg)
    assert imgs[0].shape == (32, 64, 3)
    # full-sphere synthetic mesh: every pixel is ocean -> finite
    assert np.isfinite(imgs[0]).all()
    # velocity image: speed channel == hypot(u, v)
    u, v, s = imgs[0][..., 0], imgs[0][..., 1], imgs[0][..., 2]
    np.testing.assert_allclose(s, np.hypot(u, v), rtol=1e-10)
    # two attrs (temperature, salinity) -> second image present
    assert len(imgs) == 2


def test_remapping_attr_fanout(mesh, raw_fields):
    """ceil(nAttrs/3) attribute images of 3 channels
    (reference src/Core/MOPSApp.cpp:176-185)."""
    raw = dict(raw_fields)
    t = np.asarray(raw["temperature"])
    raw["oxygen"] = t * 0.1 + 1.0          # extra (nCells, L) attrs
    raw["nitrate"] = t * 0.2 + 2.0
    a = api.MOPSApp()
    a.init("cpu", precision="fp64")
    a.begin()
    a.add_grid(mesh)
    a.add_solution(1, raw, timestamp="t1", timestep=0)
    a.end()
    a.active_attribute(1)
    cfg = mt.VisualizationSettings(image_width=32, image_height=16,
                                   fixed_depth=100.0)
    imgs = a.run_remapping(cfg)
    # 4 attrs -> 2 attr groups after the velocity image
    assert len(imgs) == 3
    assert all(im.shape == (16, 32, 3) for im in imgs)
    # group 1: [nitrate, oxygen, salinity] (name order); group 2:
    # [temperature, 0, 0] -- unused channels are zero where ocean
    ocean = np.isfinite(imgs[1][..., 0])
    assert ocean.any()
    assert np.all(imgs[2][..., 1][ocean] == 0.0)
    assert np.all(imgs[2][..., 2][ocean] == 0.0)
    # temperature values land somewhere in group 2 channel 0
    assert np.nanmax(imgs[2][..., 0]) > 1.0


def test_regrid_end_to_end(app):
    app.active_attribute(1)
    cfg = mt.VisualizationSettings(image_width=48, image_height=16,
                                   fixed_latitude=20.0)
    img = app.run_regrid(cfg)
    assert img.shape == (16, 48, 3)
    assert np.isfinite(img).any()


def test_gaussian_seeding():
    cfg = mt.SamplingSettings(lat_range=(-90, 90), lon_range=(-180, 180))
    pts = mt.seeding.generate_gaussian_points(cfg, 200, 25.0, -90.0, 5.0, seed=7)
    assert pts.shape == (200, 3)
    lat, lon = mt.geo.xyz_to_latlon_rad(pts)
    lat_d = np.rad2deg(np.asarray(lat))
    lon_d = np.rad2deg(np.asarray(lon))
    assert abs(lat_d.mean() - 25.0) < 2.0
    assert abs(lon_d.mean() + 90.0) < 2.0


def test_uniform_seeding_replicates_reference_loop():
    """(n-1) points per axis due to the reference's `< max` accumulation loop
    (MPASOVisualizer.cpp:128-135)."""
    cfg = mt.SamplingSettings(sample_range=(31, 31), lat_range=(20.0, 50.0),
                              lon_range=(-80.0, -50.0), depth=10.0)
    pts = mt.seeding.generate_sample_points(cfg)
    assert len(pts) in (30 * 30, 30 * 31, 31 * 30, 31 * 31)
    np.testing.assert_allclose(np.linalg.norm(pts, axis=1), mt.EARTH_RADIUS,
                               rtol=1e-12)
