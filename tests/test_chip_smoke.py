"""chip_smoke.py: refuses to run without a GPU, and its phases at toy size
on the CPU (the virtual 8-device mesh stands in for four cards)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_fails_without_gpu_or_repo(tmp_path, where):
    """On a CPU, and in a directory holding chip_smoke.py and nothing else
    of the repo, the script exits non-zero and prints no result."""
    if where == "alone":
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    else:
        cwd = ROOT
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.fixture(scope="module")
def case():
    return chip_smoke.build_case(400, 8, 8)


@pytest.mark.parametrize("phase", ["streamline", "pathline", "remap",
                                   "four"])
def test_phases_at_toy_size(case, phase):
    mesh, raw1, raw2, seeds, depths = case
    assert seeds.shape == (64, 3)
    if phase == "streamline":
        out = chip_smoke.phase_streamline(mesh, raw1, seeds, depths,
                                          duration=7200, oracle_lanes=4)
        assert out["gate"]["ok"] and out["oracle_err"] <= 5e-6
    elif phase == "pathline":
        out = chip_smoke.phase_pathline(mesh, raw1, raw2, seeds, depths,
                                        duration=6 * 3600, record=3600,
                                        oracle_lanes=4)
        assert out["gate"]["ok"] and out["attrs"] == 2
    elif phase == "remap":
        out = chip_smoke.phase_remap(mesh, raw1, size=(90, 45))
        assert out["mask_diff"] <= 1e-3 and out["rel"] <= 1e-4
    else:
        out = chip_smoke.phase_four(mesh, raw1, seeds, jax.devices()[:4],
                                    100, duration=7200)
        assert out["gate"]["ok"] and out["dropped"] == 0
        assert len(out["occupancy"]) == 4


def test_result_line_format(capsys):
    line = chip_smoke.result_line(jax.devices()[:1])
    assert "\n" not in line
    doc = json.loads(line)
    assert doc == {"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind, "count": 1}}
