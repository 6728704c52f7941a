"""Multi-process jax.distributed smoke test (2 processes x 4 CPU devices).

Proves the particle-sharded advection path works across PROCESS boundaries --
the multi-host story claimed in parallel/sharding.py -- on one machine:
each process owns 4 virtual CPU devices of a global 8-device mesh, feeds its
local shards, and checks its addressable slice of the sharded result against
a locally-computed single-device reference.

Usage:
  python scripts/dist_smoke.py            # launcher: spawns the 2 workers
  python scripts/dist_smoke.py --worker I # internal
"""

import os
import subprocess
import sys

PORT = int(os.environ.get("MOPS_DIST_PORT", "18765"))
N_PROC = 2
DEV_PER_PROC = 4


def worker(pid: int) -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(f"localhost:{PORT}", num_processes=N_PROC,
                               process_id=pid)
    import numpy as np

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import mops_jax as mt
    from mops_jax.parallel.sharding import device_mesh, run_advection_sharded

    assert jax.process_count() == N_PROC
    assert len(jax.devices()) == N_PROC * DEV_PER_PROC
    assert len(jax.local_devices()) == DEV_PER_PROC

    # identical inputs on every process (same seeds)
    mesh = mt.synth.build_voronoi_mesh(400, jitter=0.05, seed=0, n_layers=4)
    raw = mt.synth.solid_body_fields(mesh, n_layers=4, w_scale=1e-4)
    sol = mt.preprocess(mesh, raw)
    rng = np.random.default_rng(0)
    v = rng.normal(size=(64, 3))
    seeds = v / np.linalg.norm(v, axis=1, keepdims=True) * mt.EARTH_RADIUS
    cells = mt.CellSearch(mesh).query(seeds)
    cfg = mt.TrajectorySettings(delta_t=600, simulation_duration=600 * 10,
                                record_t=1200, depth=100.0,
                                fail_mode=mt.FailMode.ZERO)

    # single-device reference, computed locally by every process
    single = mt.run_advection(mesh, sol, seeds, cells, cfg)
    ref_final = np.asarray(single.final_position)
    ref_points = np.asarray(single.points)

    dmesh = device_mesh()     # all 8 global devices
    sharded = run_advection_sharded(mesh, sol, seeds, cells, cfg, dmesh=dmesh)

    # compare this process's addressable shards against the reference slices
    checked = 0
    for arr, ref in ((sharded.final_position, ref_final),
                     (sharded.points, ref_points)):
        for s in arr.addressable_shards:
            lo = s.index[0].start or 0
            np.testing.assert_allclose(
                np.asarray(s.data), ref[lo:lo + s.data.shape[0]],
                rtol=0, atol=1e-6)
            checked += s.data.shape[0]
    print(f"[worker {pid}] ok: checked {checked} sharded rows", flush=True)
    return 0


def launch() -> int:
    env_base = dict(os.environ)
    env_base["XLA_FLAGS"] = (
        env_base.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={DEV_PER_PROC}").strip()
    procs = []
    for pid in range(N_PROC):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(pid)],
            env=env_base))
    rc = 0
    for p in procs:
        rc |= p.wait(timeout=900)
    print("dist_smoke:", "PASS" if rc == 0 else "FAIL", flush=True)
    return rc


if __name__ == "__main__":
    if "--worker" in sys.argv:
        sys.exit(worker(int(sys.argv[sys.argv.index("--worker") + 1])))
    sys.exit(launch())
