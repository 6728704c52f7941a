"""Test configuration: force CPU with a virtual 8-device mesh, enable x64."""

import os

import jax  # noqa: E402

# The tests run on the CPU with 8 virtual devices (the sharded and migrating
# engines' meshes), set through the config so that it holds whatever
# JAX_PLATFORMS says.  On the GPU the main path is exercised by chip_smoke.py
# and bench.py instead.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

from mops_jax.config import use_compile_cache  # noqa: E402

# persistent compilation cache: the advection scan compiles once per config
use_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

import mops_jax as mt  # noqa: E402


@pytest.fixture(scope="session")
def mesh():
    return mt.synth.build_voronoi_mesh(500, n_layers=6)


@pytest.fixture(scope="session")
def raw_fields(mesh):
    return mt.synth.solid_body_fields(mesh, n_layers=6, w_scale=1e-4)


@pytest.fixture(scope="session")
def sol(mesh, raw_fields):
    return mt.preprocess(mesh, raw_fields)


@pytest.fixture(scope="session")
def sol_back(mesh, raw_fields):
    """A second snapshot with a perturbed field for pathline tests."""
    raw2 = dict(raw_fields)
    raw2 = {k: (np.asarray(v) * (1.2 if k.startswith("velocity") else 1.0))
            for k, v in raw2.items()}
    return mt.preprocess(mesh, raw2)


@pytest.fixture(scope="session")
def seeds(mesh):
    rng = np.random.default_rng(0)
    lat = rng.uniform(-60, 60, 8)
    lon = rng.uniform(-180, 180, 8)
    return np.asarray(mt.geo.latlon_rad_to_xyz(np.deg2rad(lat), np.deg2rad(lon)))


@pytest.fixture(scope="session")
def cells(mesh, seeds):
    return mt.CellSearch(mesh).query(seeds)
