"""Edge-computing orchestration over heterogeneous solver nodes.

Rebuilds the reference's quantum-edge tier (optimization/
quantum_edge_computing.py:80-633 and its near-duplicate scaling/
quantum_edge_computing.py:94-885 — EdgeNode registry, capability-aware
dispatch, latency-modeled offload decisions) as ONE module. Nodes declare a
solver backend (classical SA, parallel tempering, simulated quantum
annealing), capacity, and a network latency; the orchestrator assigns each
job to the node minimizing modeled completion time and executes locally
through the real solvers (the reference's nodes were simulations too —
ours at least run the actual algorithms).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from spinglass_tpu.core.problem import IsingProblem

BACKENDS = ("sa", "pt", "sqa")


@dataclass
class EdgeNode:
    name: str
    backend: str = "sa"            # one of BACKENDS
    capacity: int = 1              # concurrent jobs
    latency_s: float = 0.01        # round-trip network latency
    flops_scale: float = 1.0       # relative compute speed
    busy: int = 0

    def est_completion(self, n_spins: int, n_sweeps: int) -> float:
        """Latency + modeled solve time, penalized when at capacity."""
        solve = n_spins * n_sweeps * 1e-7 / self.flops_scale
        queue_penalty = (self.busy / self.capacity) * solve
        return self.latency_s + solve + queue_penalty


@dataclass
class EdgeJobResult:
    node: str
    backend: str
    best_energy: float
    runtime: float
    est_time: float


class EdgeOrchestrator:
    """Capability-aware dispatch (reference QuantumEdgeOrchestrator,
    quantum_edge_computing.py:~200-500)."""

    def __init__(self, nodes: Optional[Sequence[EdgeNode]] = None,
                 n_sweeps: int = 200, n_replicas: int = 8, seed: int = 0):
        self.nodes: List[EdgeNode] = list(nodes) if nodes else [
            EdgeNode("edge-cpu-0", "sa", capacity=2, latency_s=0.005),
            EdgeNode("edge-cpu-1", "pt", capacity=2, latency_s=0.005),
            EdgeNode("hub-accel", "sqa", capacity=4, latency_s=0.05,
                     flops_scale=8.0),
        ]
        for n in self.nodes:
            if n.backend not in BACKENDS:
                raise ValueError(f"unknown backend {n.backend!r}")
        self.n_sweeps = n_sweeps
        self.n_replicas = n_replicas
        self.seed = seed
        self.log: List[EdgeJobResult] = []

    def pick_node(self, problem: IsingProblem,
                  prefer_backend: Optional[str] = None) -> EdgeNode:
        candidates = [n for n in self.nodes
                      if prefer_backend in (None, n.backend)]
        if not candidates:
            raise RuntimeError(f"no node offers backend {prefer_backend!r}")
        return min(candidates, key=lambda n: n.est_completion(
            problem.n_spins, self.n_sweeps))

    def _run_on(self, node: EdgeNode, problem: IsingProblem):
        from spinglass_tpu.anneal.sa import SAConfig, anneal

        if node.backend == "pt":
            from spinglass_tpu.anneal import pt as pt_mod

            return pt_mod.run(problem, pt_mod.PTConfig(
                n_replicas=self.n_replicas, n_sweeps=self.n_sweeps,
                seed=self.seed))
        if node.backend == "sqa":
            from spinglass_tpu.research.quantum import (
                SQAConfig, simulated_quantum_annealing)

            return simulated_quantum_annealing(problem, SQAConfig(
                n_stages=4, sweeps_per_stage=max(self.n_sweeps // 4, 10),
                n_replicas=self.n_replicas, seed=self.seed))
        return anneal(problem, SAConfig(
            n_sweeps=self.n_sweeps, n_replicas=self.n_replicas,
            seed=self.seed))

    def submit(self, problem: IsingProblem,
               prefer_backend: Optional[str] = None) -> EdgeJobResult:
        node = self.pick_node(problem, prefer_backend)
        est = node.est_completion(problem.n_spins, self.n_sweeps)
        node.busy += 1
        t0 = time.perf_counter()
        try:
            res = self._run_on(node, problem)
        finally:
            node.busy -= 1
        out = EdgeJobResult(node=node.name, backend=node.backend,
                            best_energy=float(res.best_energy),
                            runtime=time.perf_counter() - t0, est_time=est)
        self.log.append(out)
        return out

    def submit_many(self, problems: Sequence[IsingProblem]
                    ) -> List[EdgeJobResult]:
        return [self.submit(p) for p in problems]

    def report(self) -> dict:
        by_node: Dict[str, int] = {}
        for r in self.log:
            by_node[r.node] = by_node.get(r.node, 0) + 1
        return {
            "n_jobs": len(self.log),
            "by_node": by_node,
            "mean_runtime": float(np.mean([r.runtime for r in self.log]))
            if self.log else 0.0,
        }
