"""Multi-host runtime setup: jax.distributed init + host-major meshes.

The reference declared nccl/gloo/mpi backends it never used
(multi_gpu.py:27,40-43; SURVEY §2.6); the equivalent here is the JAX
multi-host runtime. This module is the thin layer around it:

  initialize(...)      — jax.distributed.initialize with env autodetection
                         (no-op on single host / inside a colocated runtime).
  replica_mesh(...)    — 1-D "replica" mesh over all global devices, ordered
                         host-major so each host's replica shard is local and
                         exchange collectives stay on a host's NVLink, using
                         the network only across hosts.
  hybrid_mesh(...)     — 2-D ("host", "replica") mesh for workloads that
                         shard problems across hosts and replicas within one.
  local_replica_slice  — this process's slice of a replica-sharded batch (for
                         host-local IO like checkpoint writes).

Scaling model (BASELINE.md north star: >=80% spin-flips/s efficiency to >=2
hosts): the PT sweep is embarrassingly parallel over replicas — per-sweep
communication is only the [R] (energy, slot) exchange vectors (anneal/pt.py
swaps slots, never spin payloads), a few KB per super-step, so scaling is
bounded by compile-time constants, not bandwidth."""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> dict:
    """Bring up the multi-host runtime. Safe to call on a single host (no-op
    unless coordinator info is provided or discoverable from the standard
    env vars). Returns a summary dict."""
    import jax

    explicit = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS") or os.environ.get("COORDINATOR_ADDRESS")
    # probe WITHOUT touching the backend: jax.process_count() would
    # initialize XLA, after which jax.distributed.initialize errors out
    already = jax.distributed.is_initialized()
    if not already and explicit:
        jax.distributed.initialize(
            coordinator_address=explicit,
            num_processes=num_processes
            or int(os.environ.get("JAX_NUM_PROCESSES", "0")) or None,
            process_id=process_id
            if process_id is not None
            else (int(os.environ["JAX_PROCESS_ID"])
                  if "JAX_PROCESS_ID" in os.environ else None),
        )
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def replica_mesh(devices: Optional[Sequence] = None, axis: str = "replica"):
    """1-D mesh over all global devices, host-major order (each host's
    devices contiguous), so equal replica shards land on local chips."""
    import jax
    from jax.sharding import Mesh

    if devices is None:
        devices = sorted(jax.devices(),
                         key=lambda d: (d.process_index, d.id))
    return Mesh(np.array(devices), (axis,))


def hybrid_mesh(devices: Optional[Sequence] = None,
                axes: tuple = ("host", "replica")):
    """2-D (n_hosts, devices_per_host) mesh: shard independent problems over
    hosts (network axis) and replicas within a host (NVLink axis)."""
    import jax
    from jax.sharding import Mesh

    if devices is None:
        devices = sorted(jax.devices(),
                         key=lambda d: (d.process_index, d.id))
    n_proc = max(len({d.process_index for d in devices}), 1)
    per_host = len(devices) // n_proc
    grid = np.array(devices).reshape(n_proc, per_host)
    return Mesh(grid, axes)


def local_replica_slice(n_replicas: int) -> slice:
    """This process's contiguous slice of a replica-sharded leading axis
    (for host-local result IO; replica shards are host-major by
    construction in replica_mesh)."""
    import jax

    per = n_replicas // max(jax.process_count(), 1)
    start = jax.process_index() * per
    return slice(start, start + per)


def scaling_report(flips_per_sec_per_host: Sequence[float],
                   baseline_rate: Optional[float] = None) -> dict:
    """Scaling-efficiency summary for N-host runs (north-star metric,
    BASELINE.md:29 >=80% to N>=2 hosts).

    ``baseline_rate``: the measured single-host throughput of the SAME
    per-host workload. When given, efficiency = total / (N * baseline) —
    true scaling efficiency vs one host. Without it, the first host's rate
    stands in as the baseline, which only measures load balance across the
    N hosts (it cannot see uniform slowdown)."""
    rates = np.asarray(list(flips_per_sec_per_host), float)
    if rates.size == 0:
        return {"n_hosts": 0, "efficiency": 0.0}
    # `is not None`, not truthiness: an explicit 0.0 baseline means the
    # single-host measurement FAILED and must surface as efficiency 0,
    # not silently fall back to load-balance-only mode (the falsy-zero
    # class once found in quality_gates)
    explicit = baseline_rate is not None
    base = float(baseline_rate) if explicit else float(rates[0])
    ideal = base * len(rates)
    return {
        "n_hosts": int(rates.size),
        "total_flips_per_sec": float(rates.sum()),
        "efficiency": float(rates.sum() / ideal) if ideal else 0.0,
        "baseline_flips_per_sec": base,
        "baseline_kind": ("measured_single_host" if explicit
                          else "first_host"),
        "per_host": rates.tolist(),
    }
