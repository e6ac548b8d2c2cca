"""Quantum-inspired annealing: path-integral Monte Carlo + simulated quantum
annealing.

Rebuilds the reference's real quantum-inspired capability
(research/quantum_hybrid_algorithms.py:103-402): the quantum Ising model with
transverse field Gamma maps, via Suzuki-Trotter, to a classical action over P
imaginary-time slices:

    E_eff(s) = (1/P) sum_p E_classical(s_p)
               - J_perp * sum_p sum_i s_{p,i} s_{p+1,i}        (periodic in p)
    J_perp   = -(1/(2 beta)) * ln tanh(beta * Gamma / P)  > 0

Design: instead of the reference's per-site Python Metropolis on
the quantum action (quantum_hybrid_algorithms.py:262-402), we *compile the
Trotter system into an ordinary IsingProblem of P*N spins* (block-diagonal
J/P + inter-slice ferromagnetic couplings) and reuse the exact batched sweep
engines — the Trotter axis becomes part of the one dense spin axis the
sweep's matrix products already cover. SQA then anneals Gamma on a schedule, rebuilding the
(cheap, host-side) inter-slice coupling each stage."""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from spinglass_tpu.anneal.result import AnnealResult
from spinglass_tpu.anneal.sa import SAConfig, anneal
from spinglass_tpu.anneal.schedules import ScheduleConfig, ScheduleType
from spinglass_tpu.core import energy as energy_ops
from spinglass_tpu.core.problem import IsingProblem


def j_perp(beta: float, gamma: float, n_trotter: int) -> float:
    """Inter-slice coupling strength; diverges as Gamma -> 0 (slices lock)."""
    x = math.tanh(max(beta * gamma / n_trotter, 1e-12))
    return -0.5 / beta * math.log(min(max(x, 1e-300), 1.0 - 1e-16))


def trotterize(problem: IsingProblem, n_trotter: int, beta: float,
               gamma: float) -> IsingProblem:
    """Build the P*N-spin classical problem for transverse field gamma."""
    n = problem.n_spins
    p = n_trotter
    j_cls = np.asarray(problem.j, np.float64)[:n, :n] / p
    h_cls = np.asarray(problem.h, np.float64)[:n] / p
    jp = j_perp(beta, gamma, p)

    big = np.zeros((p * n, p * n))
    for s in range(p):
        sl = slice(s * n, (s + 1) * n)
        big[sl, sl] = j_cls
        nxt = (s + 1) % p
        if p > 1 and not (p == 2 and s == 1):  # avoid double edge for P=2
            big[sl, slice(nxt * n, (nxt + 1) * n)] += jp * np.eye(n)
            big[slice(nxt * n, (nxt + 1) * n), sl] += jp * np.eye(n)
    h_big = np.tile(h_cls, p)
    return IsingProblem.from_dense(big, h_big)


@dataclass(frozen=True)
class SQAConfig:
    """Reference QuantumAnnealingSimulator params
    (quantum_hybrid_algorithms.py:103-160)."""

    n_trotter: int = 8
    beta: float = 2.0
    gamma_start: float = 2.5
    gamma_end: float = 0.01
    n_stages: int = 10
    sweeps_per_stage: int = 100
    n_replicas: int = 16
    seed: int = 42


def simulated_quantum_annealing(problem: IsingProblem,
                                cfg: Optional[SQAConfig] = None
                                ) -> AnnealResult:
    """Anneal the transverse field Gamma from gamma_start to gamma_end,
    running Metropolis sweeps on the Trotter system at each stage, then
    decode the best classical slice (reference
    quantum_hybrid_algorithms.py:160-260)."""
    cfg = cfg or SQAConfig()
    n = problem.n_spins
    gammas = np.geomspace(cfg.gamma_start, max(cfg.gamma_end, 1e-3),
                          cfg.n_stages)
    key = jax.random.key(cfg.seed)
    spins = None
    best_energy = np.inf
    best_spins = None
    e_hist = []
    t0 = time.perf_counter()
    for stage, gamma in enumerate(gammas):
        tp = trotterize(problem, cfg.n_trotter, cfg.beta, float(gamma))
        sa_cfg = SAConfig(
            n_sweeps=cfg.sweeps_per_stage, n_replicas=cfg.n_replicas,
            schedule=ScheduleConfig(ScheduleType.CONSTANT,
                                    initial_temp=1.0 / cfg.beta,
                                    final_temp=1.0 / cfg.beta),
            enable_early_stop=False, seed=cfg.seed + stage)
        key, sub = jax.random.split(key)
        res = anneal(tp, sa_cfg, key=sub, init_spins=spins)
        # carry the full Trotter state between stages (replica 0 layout)
        spins = None  # fresh random next stage keeps ergodicity; best tracked
        # decode: evaluate every slice of the best replica classically
        slices = res.best_spins[: cfg.n_trotter * n].reshape(cfg.n_trotter, n)
        pad = np.ones((cfg.n_trotter, problem.n_padded - n))
        full = jnp.asarray(np.concatenate([slices, pad], axis=1))
        e_slices = np.asarray(energy_ops.energy(problem, full))
        k = int(np.argmin(e_slices))
        if e_slices[k] < best_energy:
            best_energy = float(e_slices[k])
            best_spins = slices[k]
        e_hist.append(best_energy)
    total = time.perf_counter() - t0
    return AnnealResult(
        best_spins=np.asarray(best_spins),
        best_energy=best_energy,
        replica_best_energy=np.asarray([best_energy]),
        energy_history=np.asarray(e_hist),
        mean_energy_history=np.asarray(e_hist),
        temperature_history=1.0 / cfg.beta * np.ones(len(e_hist)),
        acceptance_history=np.zeros(len(e_hist)),
        n_sweeps=cfg.n_stages * cfg.sweeps_per_stage,
        n_replicas=cfg.n_replicas,
        total_time=total,
        sweeps_per_second=cfg.n_stages * cfg.sweeps_per_stage / total,
        spin_flips_per_second=(cfg.n_stages * cfg.sweeps_per_stage
                               * cfg.n_replicas * cfg.n_trotter * n / total),
        algorithm="sqa",
        device=jax.default_backend(),
        seed=cfg.seed,
        metadata={"gammas": gammas.tolist(), "n_trotter": cfg.n_trotter},
    )


@dataclass(frozen=True)
class PIMCConfig:
    """Reference QuantumMonteCarlo params
    (quantum_hybrid_algorithms.py:262-310)."""

    n_trotter: int = 8
    beta: float = 2.0
    gamma: float = 1.0
    n_sweeps: int = 500
    n_replicas: int = 16
    seed: int = 42


def path_integral_monte_carlo(problem: IsingProblem,
                              cfg: Optional[PIMCConfig] = None
                              ) -> AnnealResult:
    """Sample the quantum action at fixed (beta, gamma); return the best
    classical slice seen (reference quantum_hybrid_algorithms.py:310-402)."""
    cfg = cfg or PIMCConfig()
    n = problem.n_spins
    tp = trotterize(problem, cfg.n_trotter, cfg.beta, cfg.gamma)
    sa_cfg = SAConfig(
        n_sweeps=cfg.n_sweeps, n_replicas=cfg.n_replicas,
        schedule=ScheduleConfig(ScheduleType.CONSTANT,
                                initial_temp=1.0 / cfg.beta,
                                final_temp=1.0 / cfg.beta),
        enable_early_stop=False, seed=cfg.seed)
    res = anneal(tp, sa_cfg)
    slices = res.best_spins[: cfg.n_trotter * n].reshape(cfg.n_trotter, n)
    pad = np.ones((cfg.n_trotter, problem.n_padded - n))
    full = jnp.asarray(np.concatenate([slices, pad], axis=1))
    e_slices = np.asarray(energy_ops.energy(problem, full))
    k = int(np.argmin(e_slices))
    res.best_spins = slices[k]
    res.best_energy = float(e_slices[k])
    res.algorithm = "pimc"
    res.metadata.update({"n_trotter": cfg.n_trotter, "gamma": cfg.gamma,
                         "slice_energies": e_slices.tolist()})
    return res
