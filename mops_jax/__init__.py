"""mops_jax: an MPAS-Ocean particle advection framework in JAX.

A from-scratch JAX/XLA re-design with the capabilities of YosefQiu/MOPS
(reference mounted at /root/reference): remapping, streamline and pathline
trajectory integration on the unstructured MPAS-O Voronoi sphere mesh, with
uniform/Gaussian seeding, NetCDF ingest, and image/VTK-style outputs.

Quick start (synthetic mesh, no data files needed):

    import mops_jax as mt
    mesh = mt.synth.build_voronoi_mesh(2000)
    raw = mt.synth.solid_body_fields(mesh, n_layers=8)
    sol = mt.preprocess(mesh, raw)
    seeds = mt.seeding.generate_sample_points(
        mt.SamplingSettings(sample_range=(10, 10), lat_range=(-40, 40),
                            lon_range=(-40, 40), depth=10.0))
    cells = mt.CellSearch(mesh).query(seeds)
    cfg = mt.TrajectorySettings(delta_t=120, simulation_duration=86400,
                                record_t=120)
    raw_traj = mt.run_advection(mesh, sol, seeds, cells, cfg)
"""

from . import (advect, api, cellsearch, config, field, geo, interp, mesh,
               remap, seeding, settings, solution, synth, trajectory)
from .advect import RawTrajectories, run_advection
from .api import (MOPS_ActiveAttribute, MOPS_AddAttribute, MOPS_AddGridMesh,
                  MOPS_Begin, MOPS_End, MOPS_GenerateSamplePoints,
                  MOPS_GetCategoryTime, MOPS_GetFieldSnapshots,
                  MOPS_GetTotalTime, MOPS_Init, MOPS_PrintTimingDetailed,
                  MOPS_PrintTimingSummary, MOPS_ResetTiming, MOPS_RunPathLine,
                  MOPS_RunReGrid, MOPS_RunRemapping, MOPS_RunStreamLine,
                  MOPSApp, solution_id)
from .cellsearch import BucketGrid, CellSearch
from .config import EARTH_RADIUS, precision
from .field import Field
from .mesh import MPASMesh
from .settings import (CalcDirection, CalcMethod, FailMode, SamplingSettings,
                       TrajectoryLine, TrajectorySettings,
                       VisualizationSettings, VisualizeType, SaveType,
                       ONE_SECOND, ONE_MINUTE, ONE_HOUR, ONE_DAY, ONE_WEEK,
                       ONE_MONTH, ONE_YEAR)
from .solution import SolutionFields, preprocess
from .trajectory import finalize_trajectories, remove_nan_trajectories_and_reindex

__version__ = "0.5.0"


def _git_revision() -> str:
    """Best-effort git SHA stamp, mirroring the reference's version.h
    (reference CMakeLists.txt:77-100, src/version.h.in): the reference bakes
    the SHA at configure time; here it is resolved lazily from the repo."""
    import os
    import subprocess
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=5)
        return out.stdout.strip() or "unknown"
    except Exception:
        return "unknown"


def version_string() -> str:
    """'<semver>+g<sha>' like the reference's MOPS_VERSION_FULL."""
    return f"{__version__}+g{_git_revision()}"
