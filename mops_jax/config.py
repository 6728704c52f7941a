"""Global numerics configuration for mops_jax.

The reference implementation (YosefQiu/MOPS) computes everything in C++ double
precision (``vec3`` = ``double3``, see reference src/Utils/BackendCompat.hpp:158).
The framework exposes two modes:

- ``fp64`` (default): bit-faithful parity mode used for verification against
  the reference trajectories.  Requires ``jax_enable_x64``.
- ``fp32``: throughput mode.  Positions are kept in float32 (~0.5 m
  resolution at Earth radius); use for benchmarks and large-scale runs where
  metre-level tolerance is acceptable.

Constants mirror the reference:
- EARTH_RADIUS: 6,371,010 m (reference src/Utils/GeoConverter.hpp:107)
- EARTH_RADIUS_KM_BASED: 6,371,010 m via 6371.01 km (GeoConverter.hpp:322)
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import jax
import jax.numpy as jnp

EARTH_RADIUS = 6371010.0

# Precision of every float contraction (einsum): HIGHEST keeps float32 out of
# TF32 wherever XLA hands one to cuBLAS.  ztop runs to thousands of metres,
# and TF32's ~1e-3 relative error would move the layer search by whole layers.
HIGHEST = jax.lax.Precision.HIGHEST

# Numerical guards copied from the reference kernels.
EPS_LAYER = 1e-8        # layer-search tolerance   (MPASOVisualizerSYCL.cpp:869)
EPS_ZERO = 1e-12        # zero-velocity / zero-denominator guard (:845,:833)
ZTOP_CLAMP = 1e-9       # monotonic ztop clamp     (:865)


# JAX's persistent compilation cache when JAX_COMPILATION_CACHE_DIR is unset:
# a fixed directory inside the checkout (listed in .gitignore)
CACHE_DIR = Path(__file__).resolve().parent.parent / ".jax_cache"


def use_compile_cache() -> str:
    """Place JAX's persistent compilation cache and return its directory.

    JAX reads JAX_COMPILATION_CACHE_DIR itself, so when it is set nothing is
    changed; otherwise the cache goes to CACHE_DIR."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


def enable_x64() -> None:
    """Turn on float64 support (parity mode requires this)."""
    jax.config.update("jax_enable_x64", True)


@dataclasses.dataclass(frozen=True)
class Precision:
    """Dtype bundle for one precision mode."""

    name: str
    real: jnp.dtype        # positions / fields
    depth: jnp.dtype       # particle depth carry (reference keeps float32!)
    index: jnp.dtype

    @property
    def is_x64(self) -> bool:
        return self.real == jnp.float64


def precision(mode: str = "fp64") -> Precision:
    if mode == "fp64":
        enable_x64()
        return Precision("fp64", jnp.dtype(jnp.float64), jnp.dtype(jnp.float32), jnp.dtype(jnp.int32))
    if mode == "fp32":
        return Precision("fp32", jnp.dtype(jnp.float32), jnp.dtype(jnp.float32), jnp.dtype(jnp.int32))
    raise ValueError(f"unknown precision mode: {mode!r}")
