"""Measured multi-process scaling artifact.

Runs the SAME per-process sharded-PT workload (2 virtual CPU devices per
process, 2 replicas per device, via distributed._multihost_worker) first as
ONE process, then as TWO processes connected through
jax.distributed.initialize over localhost, and writes a scaling_report
comparing the two to MULTIHOST_scaling.json.

CAVEAT (recorded in the artifact): the cross-process boundary here is
localhost TCP between virtual CPU devices — it validates the code path and
the per-super-step collective payload sizes, NOT interconnect bandwidth.
Real >=80%-to-N-hosts efficiency (BASELINE.md:29) needs several hosts. The PT exchange moves only O(R) slot/energy vectors per
super-step (anneal/pt.py), so the communication term is a few KB.

Usage: python -m spinglass_tpu.benchmarks.multihost_scaling [out.json]
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time


def _worker_n_super() -> int:
    from spinglass_tpu.distributed._multihost_worker import N_SUPER

    return N_SUPER


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_procs(nproc: int, outdir: str, n_spins: int,
               timeout: float = 300.0) -> list:
    """Spawn nproc workers, wait, return their per-process reports.

    Each worker is PINNED to its own CPU core (taskset): without pinning, a
    2-core box runs the 1-process baseline on both cores but oversubscribes
    them 2x in the 2-process run, and the 'scaling efficiency' measures CPU
    contention instead of the cross-process design (measured: 0.42 at
    n=512 unpinned on 2 cores). Pinned, every 'host' is one core in both
    runs — an apples-to-apples per-host workload."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # workers set their own device count
    env["JAX_PLATFORMS"] = "cpu"
    ncores = os.cpu_count() or 1
    pin = ncores >= nproc
    port = _free_port()
    procs = [
        subprocess.Popen(
            (["taskset", "-c", str(i % ncores)] if pin else [])
            + [sys.executable, "-m",
               "spinglass_tpu.distributed._multihost_worker",
               str(i), str(nproc), str(port), outdir, str(n_spins)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode(errors="replace"))
    finally:
        # a failed or hung worker must not orphan its siblings: they sit
        # forever in a collective with a dead peer, pinned to a core and
        # holding the coordinator port (r4 review)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(
                f"worker {i} rc={p.returncode}:\n{outs[i][-2000:]}")
    reports = []
    for i in range(nproc):
        with open(os.path.join(outdir, f"proc{i}.json")) as f:
            reports.append(json.load(f))
    return reports


def measure(n_spins: int = 512, tmpdir: str | None = None) -> dict:
    """1-process baseline then 2-process run; returns the scaling report.

    Accounting: every process times the same SPMD program, so its
    flips_per_sec is the GLOBAL rate; the per-HOST contribution is
    global/process_count (each host sweeps its local replica shard).
    Efficiency = sum(per-host rates at N=2) / (2 x the 1-process rate) —
    the 1-process run sweeps the same per-host workload (2 replicas per
    device on 2 devices). n_spins defaults to 512: at 64 spins the
    per-super-step collective latency over localhost TCP dwarfs the
    microseconds of local sweep compute and the number measures only the
    transport, not the design."""
    import tempfile

    from spinglass_tpu.distributed.multihost import scaling_report

    with tempfile.TemporaryDirectory(dir=tmpdir) as d1:
        base = _run_procs(1, d1, n_spins)[0]
    with tempfile.TemporaryDirectory(dir=tmpdir) as d2:
        two = _run_procs(2, d2, n_spins)

    rep = scaling_report(
        [r["flips_per_sec_per_process"] for r in two],
        baseline_rate=base["flips_per_sec_per_process"])
    rep.update({
        "workload": {
            "n_spins": n_spins,
            "devices_per_process": base["local_devices"],
            "replicas_per_device": base["n_replicas"]
            // base["local_devices"],
            "engine": base["engine"],
        },
        "single_process": {k: base[k] for k in
                           ("flips_per_sec", "seconds", "n_replicas")},
        "two_process": [
            {k: r[k] for k in ("process", "flips_per_sec",
                               "flips_per_sec_per_process", "seconds",
                               "n_replicas", "best_energy")} for r in two],
        "caveat": ("localhost TCP between virtual CPU devices on one "
                   "machine — validates the jax.distributed code path and "
                   "O(R) exchange payloads, not ICI/DCN bandwidth; real "
                   "N-host efficiency needs pod hardware"),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    })
    return rep


def main() -> None:
    out_path = sys.argv[1] if len(sys.argv) > 1 else "MULTIHOST_scaling.json"
    # Two sizes expose the overhead structure. On a QUIET box two
    # consecutive runs agree: ~10-15 ms/super-step of roughly constant
    # localhost-transport latency, so efficiency RISES with per-sweep
    # compute (92-93% at n=512, ~97% at n=2048); the compiled HLO's
    # collectives are O(R) ([1,8] payloads, verified at n=64 and n=2048).
    # CAVEAT: any concurrent load on this 2-core machine inflates the
    # 2-process run disproportionately (one contaminated session measured
    # 75% at n=2048 with 0.111 s/step) — rerun on an idle box before
    # trusting a low number.
    runs = {n: measure(n_spins=n) for n in (512, 2048)}
    sizes = sorted(runs)
    summary = {
        "efficiency_by_n_spins": {str(n): runs[n]["efficiency"]
                                  for n in sizes},
        "per_super_step_overhead_seconds": {
            str(n): (runs[n]["two_process"][0]["seconds"]
                     - runs[n]["single_process"]["seconds"]) / _worker_n_super()
            for n in sizes},
        "interpretation": ("collectives are O(R) in the compiled HLO "
                           "([1,8] s32/f32 payloads, verified at n=64 and "
                           "n=2048); the ~10-15 ms/super-step residual is "
                           "roughly constant localhost-transport latency, "
                           "so efficiency rises with per-sweep compute. "
                           "Numbers require an IDLE box: concurrent load "
                           "on this 2-core rig inflates the 2-process run "
                           "disproportionately (a contaminated session "
                           "read 75% at n=2048). On a pod the same O(R) "
                           "exchange rides us-scale ICI"),
        "runs": {str(n): runs[n] for n in sizes},
    }
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({"efficiency_by_n": summary["efficiency_by_n_spins"],
                      "out": out_path}))


if __name__ == "__main__":
    main()
