"""High-level task-class + cache/checkpoint tests."""

import os

import numpy as np
import pytest

import mops_jax as mt
from mops_jax.io.cache import (load_particle_checkpoint, load_solution_cache,
                               save_particle_checkpoint, save_solution_cache)
from mops_jax.pymops import (MOPSPathline, MOPSReGrid, MOPSRemapping,
                             MOPSStreamline)


def test_remapping_task(tmp_path):
    task = MOPSRemapping(synthetic_cells=400, synthetic_layers=5,
                         width=60, height=30, fixed_depth=50.0,
                         output_dir=str(tmp_path))
    imgs = task.run()
    assert imgs[0].shape == (30, 60, 3)
    paths = task.save()
    assert all(os.path.exists(p) for p in paths)
    plot = task.plot()
    assert os.path.exists(plot)


def test_regrid_task(tmp_path):
    task = MOPSReGrid(synthetic_cells=400, synthetic_layers=5,
                      width=60, fixed_latitude=30.0, output_dir=str(tmp_path))
    img = task.run()
    assert img.shape == (5, 60, 3)


def test_streamline_task(tmp_path):
    task = MOPSStreamline(synthetic_cells=400, synthetic_layers=5,
                          grid=(4, 4), duration=3600 * 3, delta_t=600,
                          record_t=1200, output_dir=str(tmp_path))
    lines = task.run()
    assert len(lines) == 9      # (4-1) x (4-1) reference seeding quirk
    files = task.save()
    assert all(os.path.exists(p) for p in files)
    assert os.path.exists(task.plot())


def test_pathline_task_chains_pairs(tmp_path):
    task = MOPSPathline(synthetic_cells=400, synthetic_layers=5,
                        timesteps=(0, 1, 2), grid=(3, 3),
                        duration_per_pair=3600 * 2, delta_t=600,
                        record_t=1200, output_dir=str(tmp_path))
    lines = task.run()
    # 2 pairs x 6 records each + seed
    assert lines[0].points.shape[0] == 1 + 2 * 6
    files = task.save()
    assert all(os.path.exists(p) for p in files)


def test_solution_cache_roundtrip(tmp_path, mesh, sol):
    path = save_solution_cache(str(tmp_path), mesh, sol)
    assert os.path.exists(path)
    loaded = load_solution_cache(str(tmp_path), mesh, sol.timestep)
    assert loaded is not None
    np.testing.assert_array_equal(np.asarray(loaded.vertex_ztop),
                                  np.asarray(sol.vertex_ztop))
    np.testing.assert_array_equal(np.asarray(loaded.vertex_velocity),
                                  np.asarray(sol.vertex_velocity))
    assert set(loaded.vertex_attrs) == set(sol.vertex_attrs)
    assert load_solution_cache(str(tmp_path), mesh, 999) is None


def test_particle_checkpoint_roundtrip(tmp_path):
    p = str(tmp_path / "ckpt.npz")
    pos = np.random.default_rng(0).normal(size=(10, 3))
    save_particle_checkpoint(p, pos, np.ones(10), np.arange(10),
                             np.ones(10, bool), meta={"step": 42})
    pos2, d2, c2, a2, meta = load_particle_checkpoint(p)
    np.testing.assert_array_equal(pos2, pos)
    assert int(meta["step"]) == 42
