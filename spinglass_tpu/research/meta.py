"""Meta-optimization: problem characterization, algorithm selection, and
schedule learning from problem embeddings.

Rebuilds the reference's meta tier — ProblemCharacterizer
(adaptive_meta_rl.py:139), ProblemEmbedding/AnnealingStrategyGenerator/
MetaOptimizer (meta_learning_optimization.py:30-285), and the
ProblemAnalyzer/AlgorithmSelector of unified_research_framework.py:137-541 —
as one compact module: a feature extractor over (J, h), a rule+data-driven
algorithm selector, and a nearest-neighbor schedule memory that improves
with every solved instance."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np

from spinglass_tpu.anneal.sa import SAConfig, anneal
from spinglass_tpu.anneal.schedules import ScheduleConfig, ScheduleType
from spinglass_tpu.core import topology
from spinglass_tpu.core.problem import IsingProblem


def characterize(problem: IsingProblem) -> np.ndarray:
    """8-dim problem embedding (reference ProblemCharacterizer,
    adaptive_meta_rl.py:139-283): size, density, coupling stats, frustration
    proxy, field strength, degree spread."""
    n = problem.n_spins
    j = np.asarray(problem.j)[:n, :n]
    h = np.asarray(problem.h)[:n]
    nz = j[j != 0]
    density = topology.density(j)
    degs = topology.degrees(j)
    frustration = 0.0
    if len(nz):
        # negative-triangle proxy via sampled 3-cycles
        rng = np.random.default_rng(0)
        m = min(n, 64)
        sel = rng.choice(n, m, replace=False)
        sub = j[np.ix_(sel, sel)]
        tri = sub @ sub * sub  # (J^2 ∘ J) counts weighted triangles
        frustration = float((tri < 0).sum() / max((tri != 0).sum(), 1))
    return np.asarray([
        np.log10(max(n, 1)),
        density,
        float(np.mean(np.abs(nz))) if len(nz) else 0.0,
        float(np.std(nz)) if len(nz) else 0.0,
        frustration,
        float(np.mean(np.abs(h))),
        float(np.std(degs) / max(np.mean(degs), 1e-9)),
        float(np.mean(nz < 0)) if len(nz) else 0.0,
    ])


def select_algorithm(problem: IsingProblem) -> str:
    """Rule-based selector (reference AlgorithmSelector,
    unified_research_framework.py:338-540): returns one of
    sa | pt | adaptive_sa | sqa."""
    feats = characterize(problem)
    log_n, density, _, j_std, frustration = feats[0], feats[1], feats[2], \
        feats[3], feats[4]
    if frustration > 0.4 and log_n <= 3.0:
        return "sqa"        # heavy frustration, small: quantum-inspired
    if frustration > 0.25 or j_std > 1.0:
        return "pt"         # rugged landscape: replica exchange
    if density < 0.05 and log_n >= 3.3:
        return "sa"         # large sparse: colored SA is near-optimal
    if log_n >= 3.0:
        return "adaptive_sa"
    return "sa"


@dataclass
class ScheduleMemory:
    """Nearest-neighbor memory of (embedding -> best schedule params)
    (reference EpisodicMemory, adaptive_meta_rl.py:384-427)."""

    embeddings: List[np.ndarray] = field(default_factory=list)
    params: List[dict] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)

    def suggest(self, embedding: np.ndarray,
                default: Optional[dict] = None) -> dict:
        if not self.embeddings:
            return default or {"initial_temp": 5.0, "alpha": 0.99}
        d = np.linalg.norm(np.stack(self.embeddings) - embedding, axis=1)
        # among the 3 nearest, take the best-scoring
        near = np.argsort(d)[:3]
        best = near[int(np.argmax(np.asarray(self.scores)[near]))]
        return dict(self.params[best])

    def record(self, embedding: np.ndarray, params: dict,
               score: float) -> None:
        self.embeddings.append(np.asarray(embedding))
        self.params.append(dict(params))
        self.scores.append(float(score))


class MetaOptimizer:
    """Auto-select algorithm + learned schedule, improve from experience
    (reference UnifiedResearchFramework.solve, unified_research_framework.py
    :541-1039)."""

    def __init__(self, n_sweeps: int = 500, n_replicas: int = 16,
                 seed: int = 42):
        self.n_sweeps = n_sweeps
        self.n_replicas = n_replicas
        self.seed = seed
        self.memory = ScheduleMemory()
        self.solve_log: List[dict] = []

    def solve(self, problem: IsingProblem, algorithm: Optional[str] = None):
        emb = characterize(problem)
        algo = algorithm or select_algorithm(problem)
        params = self.memory.suggest(emb)
        t0 = time.perf_counter()
        if algo == "pt":
            from spinglass_tpu.anneal import pt as pt_mod

            res = pt_mod.run(problem, pt_mod.PTConfig(
                n_replicas=min(self.n_replicas, 16), n_sweeps=self.n_sweeps,
                max_temp=params["initial_temp"], seed=self.seed))
        elif algo == "sqa":
            from spinglass_tpu.research.quantum import (SQAConfig,
                                                        simulated_quantum_annealing)

            res = simulated_quantum_annealing(problem, SQAConfig(
                n_stages=5, sweeps_per_stage=self.n_sweeps // 5,
                n_replicas=self.n_replicas, seed=self.seed))
        elif algo == "adaptive_sa":
            from spinglass_tpu.anneal.adaptive import (AdaptiveSAConfig,
                                                       adaptive_anneal)

            res = adaptive_anneal(problem, AdaptiveSAConfig(
                base=SAConfig(
                    n_sweeps=self.n_sweeps, n_replicas=self.n_replicas,
                    schedule=ScheduleConfig(
                        ScheduleType.GEOMETRIC,
                        initial_temp=params["initial_temp"],
                        final_temp=0.01, alpha=params["alpha"],
                        total_sweeps=self.n_sweeps),
                    seed=self.seed)))
        else:
            res = anneal(problem, SAConfig(
                n_sweeps=self.n_sweeps, n_replicas=self.n_replicas,
                schedule=ScheduleConfig(
                    ScheduleType.GEOMETRIC,
                    initial_temp=params["initial_temp"], final_temp=0.01,
                    alpha=params["alpha"], total_sweeps=self.n_sweeps),
                enable_early_stop=False, seed=self.seed))
        runtime = time.perf_counter() - t0
        # score: normalized energy improvement per second
        first = (float(res.mean_energy_history[0])
                 if len(res.mean_energy_history) else 0.0)
        score = (first - res.best_energy) / max(abs(first), 1e-9)
        self.memory.record(emb, params, score)
        self.solve_log.append({
            "algorithm": algo, "best_energy": res.best_energy,
            "runtime": runtime, "score": score,
        })
        return res

    def report(self) -> dict:
        algos = [s["algorithm"] for s in self.solve_log]
        return {
            "n_solved": len(self.solve_log),
            "algorithms_used": {a: algos.count(a) for a in set(algos)},
            "memory_size": len(self.memory.embeddings),
        }
