"""Tour of the advanced tiers: cluster updates, sparse 10k-spin solves,
auto algorithm selection, federated optimization, auto-scaling, monitoring.

Run: python examples/advanced_features.py  (CPU or GPU; small sizes)
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))

import numpy as np

from spinglass_tpu.core import topology
from spinglass_tpu.core.problem import IsingProblem


def swendsen_wang_demo():
    """Cluster updates decorrelate a critical 2D Ising model."""
    import jax
    import jax.numpy as jnp

    from spinglass_tpu.core.cluster import SwendsenWang
    from spinglass_tpu.core.problem import random_spins

    j = topology.grid_2d(16, 16, dist="ferromagnetic")
    p = IsingProblem.from_dense(np.asarray(j))
    sw = SwendsenWang(p)
    key = jax.random.key(0)
    spins = random_spins(key, (8, p.n_padded), p.active_mask)
    beta_c = 0.4407  # 2D Ising critical point
    for i in range(10):
        key, sub = jax.random.split(key)
        spins, de, n_clusters = sw.sweep(spins, jnp.float32(beta_c), sub)
    m = np.abs(np.asarray(spins[:, :256]).mean(axis=1))
    print(f"[swendsen-wang] clusters/replica ~ "
          f"{np.asarray(n_clusters).mean():.0f}, |m| = {m.mean():.3f}")


def sparse_10k_demo():
    """Dense-free 10k-spin parallel tempering (sub-second warm solves)."""
    from spinglass_tpu.anneal import pt
    from spinglass_tpu.kernels.sparse import EllProblem

    n = 10_000
    rows, cols, vals = topology.sparse_random_graph_coo(
        n, avg_degree=6.0, seed=7)
    ell = EllProblem.from_coo(n, rows, cols, vals)
    cfg = pt.PTConfig(n_replicas=16, n_sweeps=300, exchange_interval=10,
                      seed=0)
    res = pt.run(ell, cfg)      # first call compiles...
    res = pt.run(ell, cfg)      # ...repeat solves reuse the executable
    print(f"[sparse-10k] best={res.best_energy:.0f} "
          f"flips/s={res.spin_flips_per_second:.3g} "
          f"({res.total_time:.2f}s warm)")


def unified_research_demo():
    """Analyze -> auto-select algorithm -> solve -> statistical compare."""
    from spinglass_tpu.research.unified import UnifiedResearchFramework

    j = topology.fully_connected(48, dist="gaussian", scale=1 / np.sqrt(48),
                                 seed=5)
    p = IsingProblem.from_dense(j)
    fw = UnifiedResearchFramework(n_sweeps=200, n_replicas=8)
    analysis = fw.analyzer.analyze(p)
    res = fw.solve(p)
    print(f"[unified] class={analysis.problem_class} "
          f"algo={fw.history[-1]['algorithm']} best={res.best_energy:.2f}")


def federated_demo():
    """Clients anneal private problems; server aggregates schedules only."""
    from spinglass_tpu.research.federated import (FederatedAnnealingServer,
                                                  FederatedConfig)

    problems = [IsingProblem.from_dense(topology.fully_connected(
        24, dist="gaussian", scale=0.2, seed=i)) for i in range(3)]
    out = FederatedAnnealingServer(FederatedConfig(
        n_rounds=2, local_sweeps=100, n_replicas=4)).run(problems)
    print(f"[federated] global schedule={out['global_params']} "
          f"best per client={[round(e, 1) for e in out['final_best']]}")


def autoscale_monitor_demo():
    """Auto-scaling decisions + anomaly detection with self-healing."""
    from spinglass_tpu.utils.anomaly import AdaptiveMonitoringSystem
    from spinglass_tpu.utils.autoscale import AutoScalingManager

    mgr = AutoScalingManager()
    d = mgr.tick(n_replicas=256, utilization=0.93, hbm_used_fraction=0.4,
                 queue_depth=6)
    print(f"[autoscale] {d.resource}: {d.current} -> {d.target} ({d.reason})")

    mon = AdaptiveMonitoringSystem()
    mon.healer.register("sweep_latency*", "*",
                        lambda a: print(f"[self-heal] shrink batch after "
                                        f"{a.kind} on {a.metric}"))
    for v in [1.0, 1.1, 0.9, 1.0, 1.05, 9.0]:
        mon.record("sweep_latency_ms", v)
    print(f"[monitoring] anomalies={mon.report()['n_anomalies']}")


if __name__ == "__main__":
    swendsen_wang_demo()
    unified_research_demo()
    federated_demo()
    autoscale_monitor_demo()
    sparse_10k_demo()
