"""Unified research framework: analyze → select → solve → validate → report.

Rebuilds the reference's top research facade — ProblemAnalyzer
(unified_research_framework.py:137), AlgorithmSelector (:338), and
UnifiedResearchFramework (:541-1039) — by composing the existing
tiers: research/meta.py's embedding + selector, the SA/PT/adaptive/SQA
solvers, research/validation.py's statistics, and research/novel.py's
algorithm comparison harness. One object gives the reference's "hand me a
problem, run the full research pipeline" capability.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from spinglass_tpu.core.problem import IsingProblem
from spinglass_tpu.research import meta as meta_mod
from spinglass_tpu.research.validation import (bootstrap_ci, cohens_d,
                                               welch_t)


@dataclass
class ProblemAnalysis:
    """Structured analysis of one instance (reference ProblemAnalyzer output,
    unified_research_framework.py:137-337)."""

    n_spins: int
    embedding: np.ndarray
    density: float
    frustration: float
    field_strength: float
    problem_class: str
    recommended_algorithm: str

    def to_dict(self) -> dict:
        return {
            "n_spins": self.n_spins,
            "density": self.density,
            "frustration": self.frustration,
            "field_strength": self.field_strength,
            "problem_class": self.problem_class,
            "recommended_algorithm": self.recommended_algorithm,
        }


class ProblemAnalyzer:
    """Feature extraction + classification (reference
    unified_research_framework.py:137-337). Classes mirror the reference's
    taxonomy: ferromagnetic / antiferromagnetic / spin_glass / field_driven /
    sparse_structured."""

    def analyze(self, problem: IsingProblem) -> ProblemAnalysis:
        emb = meta_mod.characterize(problem)
        n = problem.n_spins
        j = np.asarray(problem.j)[:n, :n]
        h = np.asarray(problem.h)[:n]
        nz = j[j != 0]
        density = float(emb[1])
        frustration = float(emb[4])
        field_strength = float(np.mean(np.abs(h)))
        neg_frac = float(np.mean(nz < 0)) if len(nz) else 0.0
        coupling_scale = float(np.mean(np.abs(nz))) if len(nz) else 0.0
        if field_strength > 2.0 * max(coupling_scale, 1e-12):
            klass = "field_driven"
        elif neg_frac < 0.05:
            klass = "ferromagnetic"
        elif neg_frac > 0.95:
            klass = "antiferromagnetic"
        elif density < 0.05:
            klass = "sparse_structured"
        else:
            klass = "spin_glass"
        return ProblemAnalysis(
            n_spins=n, embedding=emb, density=density,
            frustration=frustration, field_strength=field_strength,
            problem_class=klass,
            recommended_algorithm=meta_mod.select_algorithm(problem))


class AlgorithmSelector:
    """Performance-informed selector (reference AlgorithmSelector,
    unified_research_framework.py:338-540): starts from the rule-based
    recommendation and overrides it once measured win-rates by problem class
    accumulate."""

    def __init__(self, min_evidence: int = 3):
        self.min_evidence = min_evidence
        # problem_class -> algorithm -> list of scores
        self.evidence: Dict[str, Dict[str, List[float]]] = {}

    def record(self, problem_class: str, algorithm: str,
               score: float) -> None:
        self.evidence.setdefault(problem_class, {}).setdefault(
            algorithm, []).append(float(score))

    def select(self, analysis: ProblemAnalysis) -> str:
        by_algo = self.evidence.get(analysis.problem_class, {})
        scored = {a: float(np.mean(s)) for a, s in by_algo.items()
                  if len(s) >= self.min_evidence}
        if scored:
            return max(scored, key=scored.get)
        return analysis.recommended_algorithm


class UnifiedResearchFramework:
    """End-to-end research pipeline (reference UnifiedResearchFramework,
    unified_research_framework.py:541-1039):

      solve(problem)           — analyze, select, run, learn
      compare(problem, algos)  — n-trial comparison with Welch t / Cohen d
      report()                 — cumulative evidence + selector state
    """

    def __init__(self, n_sweeps: int = 500, n_replicas: int = 16,
                 seed: int = 42):
        self.analyzer = ProblemAnalyzer()
        self.selector = AlgorithmSelector()
        self.meta = meta_mod.MetaOptimizer(
            n_sweeps=n_sweeps, n_replicas=n_replicas, seed=seed)
        self.history: List[dict] = []

    def solve(self, problem: IsingProblem, algorithm: Optional[str] = None):
        analysis = self.analyzer.analyze(problem)
        algo = algorithm or self.selector.select(analysis)
        t0 = time.perf_counter()
        result = self.meta.solve(problem, algorithm=algo)
        runtime = time.perf_counter() - t0
        score = self.meta.solve_log[-1]["score"]
        self.selector.record(analysis.problem_class, algo, score)
        self.history.append({
            "analysis": analysis.to_dict(), "algorithm": algo,
            "best_energy": float(result.best_energy), "runtime": runtime,
        })
        return result

    def compare(self, problem: IsingProblem,
                algorithms: Sequence[str] = ("sa", "pt"),
                n_trials: int = 3) -> dict:
        """Statistical head-to-head (reference experimental comparison,
        unified_research_framework.py:820-1039 + experimental_validation.py
        :210-353)."""
        runs: Dict[str, List[float]] = {a: [] for a in algorithms}
        for trial in range(n_trials):
            for algo in algorithms:
                self.meta.seed = 1000 + trial
                res = self.meta.solve(problem, algorithm=algo)
                runs[algo].append(float(res.best_energy))
        algos = list(algorithms)
        out: dict = {"energies": {a: runs[a] for a in algos}}
        if len(algos) >= 2:
            a, b = runs[algos[0]], runs[algos[1]]
            tt = welch_t(a, b)
            out["welch_t"] = tt["t"]
            out["p_value"] = tt["p_value"]
            out["cohens_d"] = cohens_d(a, b)
            out["ci_95"] = {algo: bootstrap_ci(runs[algo])
                            for algo in algos}
            out["winner"] = min(algos, key=lambda x: float(np.mean(runs[x])))
        return out

    def report(self) -> dict:
        classes = [h["analysis"]["problem_class"] for h in self.history]
        return {
            "n_solved": len(self.history),
            "problem_classes": {c: classes.count(c) for c in set(classes)},
            "selector_evidence": {
                k: {a: len(s) for a, s in v.items()}
                for k, v in self.selector.evidence.items()},
            "meta": self.meta.report(),
        }
