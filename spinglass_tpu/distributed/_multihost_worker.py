"""Worker for the two-process multi-host dryrun (run via subprocess).

Each process brings up jax.distributed over localhost, builds the host-major
replica mesh spanning BOTH processes' virtual CPU devices, and runs sharded
parallel tempering across the process boundary — the real
jax.distributed.initialize + GSPMD path that several GPU hosts use
(SURVEY §2.6; the reference's communication_backend was never wired,
multi_gpu.py:27).

Usage: python -m spinglass_tpu.distributed._multihost_worker \
           <process_id> <num_processes> <port> <out_dir> [n_spins]
"""

import json
import os
import sys
import time

# timed super-steps per worker — benchmarks.multihost_scaling divides by
# this to report per-super-step overhead, so it must be THE constant
N_SUPER = 10


def main() -> None:
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]
    outdir = sys.argv[4]
    n = int(sys.argv[5]) if len(sys.argv) > 5 else 64

    # 2 virtual CPU devices per process; must be set before backend init
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=2").strip()

    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
    except RuntimeError:
        pass

    from spinglass_tpu.distributed import multihost

    info = multihost.initialize(coordinator_address=f"localhost:{port}",
                                num_processes=nproc, process_id=pid)
    assert info["process_count"] == nproc, info

    import numpy as np

    from spinglass_tpu.anneal.pt import PTConfig
    from spinglass_tpu.core import topology
    from spinglass_tpu.core.problem import IsingProblem
    from spinglass_tpu.distributed import pt_sharded

    mesh = multihost.replica_mesh()
    j = topology.fully_connected(n, dist="gaussian", scale=1.0 / np.sqrt(n),
                                 seed=0)
    problem = IsingProblem.from_dense(j)
    ndev = mesh.devices.size
    cfg = PTConfig(n_replicas=2 * ndev, exchange_interval=5,
                   use_pallas="never", min_temp=0.2, max_temp=5.0, seed=0)
    step, init, betas, engine, sh = pt_sharded.make_sharded_pt_step(
        problem, cfg, mesh)

    state = init(jax.random.key(0))
    state, stats = step(state)                   # compile + warm
    jax.block_until_ready(state.energy)

    n_super = N_SUPER
    t0 = time.perf_counter()
    for _ in range(n_super):
        state, stats = step(state)
    jax.block_until_ready(state.energy)
    dt = time.perf_counter() - t0

    best = float(stats["best_energy"])           # replicated -> addressable
    # flips/dt is the GLOBAL program rate (every process times the same
    # SPMD program over all n_replicas); this process only swept
    # n_replicas/process_count of them, so its own contribution is
    # flips_per_sec_per_process — sum THOSE across processes for totals
    flips = n_super * cfg.exchange_interval * cfg.n_replicas * problem.n_spins
    out = {
        "process": pid,
        "process_count": info["process_count"],
        "global_devices": info["global_devices"],
        "local_devices": info["local_devices"],
        "n_replicas": cfg.n_replicas,
        "flips_per_sec": flips / dt,
        "flips_per_sec_per_process": flips / dt / info["process_count"],
        "seconds": dt,
        "best_energy": best,
        "finite": bool(np.isfinite(best)),
        "engine": engine.name,
    }
    with open(os.path.join(outdir, f"proc{pid}.json"), "w") as f:
        json.dump(out, f)
    print(f"proc{pid} ok: {out['flips_per_sec']:.3g} flips/s", flush=True)


if __name__ == "__main__":
    main()
