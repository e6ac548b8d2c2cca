"""AnnealResult — outcome container mirroring the reference's result object
(spin_glass_rl/annealing/result.py:9-197), adapted to batched replica runs."""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np


@dataclass
class AnnealResult:
    """Result of an annealing run.

    best_spins/best_energy are the best over *all* replicas and sweeps;
    per-replica bests are kept for PT/ensemble analysis. Histories are recorded
    every ``record_interval`` sweeps (reference gpu_annealer.py:156-160).
    """

    best_spins: np.ndarray                 # [n_spins] (logical, unpadded)
    best_energy: float
    replica_best_energy: np.ndarray        # [R]
    energy_history: np.ndarray             # [n_records] best-so-far energy
    mean_energy_history: np.ndarray        # [n_records] mean replica energy
    temperature_history: np.ndarray        # [n_records]
    acceptance_history: np.ndarray         # [n_records] mean acceptance rate
    n_sweeps: int = 0
    n_replicas: int = 1
    total_time: float = 0.0
    sweeps_per_second: float = 0.0
    spin_flips_per_second: float = 0.0
    algorithm: str = "sa"
    device: str = "gpu"
    seed: Optional[int] = None
    converged: bool = False
    convergence_sweep: Optional[int] = None
    metadata: dict = field(default_factory=dict)

    def __post_init__(self):
        if not np.isfinite(self.best_energy):
            raise ValueError(f"non-finite best energy: {self.best_energy}")

    @property
    def final_energy_std(self) -> float:
        tail = self.energy_history[-20:]
        return float(np.std(tail)) if len(tail) else 0.0

    def summary(self) -> dict:
        return {
            "best_energy": float(self.best_energy),
            "n_sweeps": self.n_sweeps,
            "n_replicas": self.n_replicas,
            "total_time": self.total_time,
            "sweeps_per_second": self.sweeps_per_second,
            "spin_flips_per_second": self.spin_flips_per_second,
            "converged": self.converged,
            "convergence_sweep": self.convergence_sweep,
            "algorithm": self.algorithm,
            "device": self.device,
        }

    def save(self, path: str) -> None:
        """Compressed npz, mirroring reference result.py:147-169."""
        np.savez_compressed(
            path,
            best_spins=self.best_spins,
            best_energy=self.best_energy,
            replica_best_energy=self.replica_best_energy,
            energy_history=self.energy_history,
            mean_energy_history=self.mean_energy_history,
            temperature_history=self.temperature_history,
            acceptance_history=self.acceptance_history,
            n_sweeps=self.n_sweeps,
            n_replicas=self.n_replicas,
            total_time=self.total_time,
            sweeps_per_second=self.sweeps_per_second,
            spin_flips_per_second=self.spin_flips_per_second,
            algorithm=self.algorithm,
            seed=-1 if self.seed is None else self.seed,
        )

    @staticmethod
    def load(path: str) -> "AnnealResult":
        with np.load(path) as z:
            seed = int(z["seed"])
            return AnnealResult(
                best_spins=z["best_spins"],
                best_energy=float(z["best_energy"]),
                replica_best_energy=z["replica_best_energy"],
                energy_history=z["energy_history"],
                mean_energy_history=z["mean_energy_history"],
                temperature_history=z["temperature_history"],
                acceptance_history=z["acceptance_history"],
                n_sweeps=int(z["n_sweeps"]),
                n_replicas=int(z["n_replicas"]),
                total_time=float(z["total_time"]),
                sweeps_per_second=float(z["sweeps_per_second"])
                if "sweeps_per_second" in z else 0.0,
                spin_flips_per_second=float(z["spin_flips_per_second"])
                if "spin_flips_per_second" in z else 0.0,
                algorithm=str(z["algorithm"]),
                seed=None if seed < 0 else seed,
            )
