"""Compile-cache placement and what the package imports."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from mops_jax import config

ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR, when set, is left to JAX and nothing is
    changed; otherwise the cache goes to the fixed directory in the
    checkout."""
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", "unchanged")
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert config.use_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == "unchanged"
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            assert config.use_compile_cache() == str(ROOT / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == str(
                ROOT / ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_no_platform_specific_kernel_code():
    """Nothing imports a Pallas dialect other than the GPU ones, and
    nothing branches on which backend JAX runs."""
    dialect = re.compile(
        r"jax\.experimental\.pallas\.(\w+)|"
        r"from jax\.experimental\.pallas import (\w+)")
    branch = re.compile(r"default_backend\(\)\s*[!=]=")
    hits = []
    for sub in ("mops_jax", "scripts"):
        for path in (ROOT / sub).rglob("*.py"):
            text = path.read_text()
            for m in dialect.finditer(text):
                if (m.group(1) or m.group(2)) not in ("triton", "mosaic_gpu"):
                    hits.append(f"{path.relative_to(ROOT)}: {m.group(0)}")
            hits += [f"{path.relative_to(ROOT)}: {m.group(0)}"
                     for m in branch.finditer(text)]
    assert not hits, hits


def test_cli_imports_without_yaml():
    """The CLI (and the main path under it) imports without PyYAML."""
    code = ("import sys; sys.modules['yaml'] = None; "
            "import mops_jax.cli; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
