"""Lane-wise agreement gate between two advection runs of the same seeds.

A handful of lanes legitimately diverge when a rounding difference flips a
near-tie relocation argmin or layer pick (chaotic but valid); a broken path
moves nothing, or everything wrong.  So the gate asks that at least 99.5% of
lanes end within max(100 m, 1e-4 x median displacement) of the reference and
that the median displacements agree within 5%.
"""

from __future__ import annotations

import numpy as np

LANE_SHARE = 0.995


def lane_gate(final: np.ndarray, ref_final: np.ndarray,
              seeds: np.ndarray) -> dict:
    """Compare final positions (N, 3) of a run with a reference run."""
    final = np.asarray(final, np.float64)
    ref_final = np.asarray(ref_final, np.float64)
    seeds = np.asarray(seeds, np.float64)
    err = np.linalg.norm(final - ref_final, axis=1)
    disp_ref = float(np.median(np.linalg.norm(ref_final - seeds, axis=1)))
    disp = float(np.median(np.linalg.norm(final - seeds, axis=1)))
    tol = max(100.0, 1e-4 * max(disp_ref, 1.0))
    share_off = float(1.0 - np.mean(err <= tol))
    ok = (share_off <= 1.0 - LANE_SHARE
          and abs(disp - disp_ref) <= 0.05 * max(disp_ref, 1.0))
    return {"ok": bool(ok), "lanes": int(len(err)), "share_off": share_off,
            "tol_m": tol, "median_disp_m": disp,
            "median_disp_ref_m": disp_ref}
