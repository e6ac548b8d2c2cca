"""The reference's three headline 'novel' algorithms, rebuilt in JAX
(research/novel_algorithms.py:65-770):

* AQIA — adaptive quantum-inspired annealing: per-spin probability-amplitude
  angles rotated toward the local field, tunneling flips under an adaptive
  transverse field (:65-250). Here one jitted lax.scan over iterations,
  batched over replicas.
* MSHO — multi-scale hierarchical optimization: greedy |J|-matching coarsens
  the graph, the coarse problem is solved with the standard annealer, the
  solution lifts back and refines (:253-498). Host-driven recursion around
  jitted solves.
* LESD — learning-enhanced spin dynamics: a small MLP scores spins from
  local features and biases proposal selection; trained online from observed
  dE (:499-770)."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import lax

from spinglass_tpu.anneal.result import AnnealResult
from spinglass_tpu.anneal.sa import SAConfig, anneal
from spinglass_tpu.anneal.schedules import ScheduleConfig
from spinglass_tpu.core import energy as energy_ops
from spinglass_tpu.core.problem import IsingProblem, random_spins
from spinglass_tpu.rl.mlp import MLP


# ---------------------------------------------------------------------------
# AQIA
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class AQIAConfig:
    n_iterations: int = 500
    n_replicas: int = 32
    field_start: float = 2.0          # transverse field strength
    field_decay: float = 0.995
    rotation_rate: float = 0.1
    tunnel_prob: float = 0.05
    seed: int = 42


def adaptive_quantum_inspired_annealing(problem: IsingProblem,
                                        cfg: Optional[AQIAConfig] = None
                                        ) -> AnnealResult:
    cfg = cfg or AQIAConfig()
    r, n_pad = cfg.n_replicas, problem.n_padded
    key = jax.random.key(cfg.seed)
    key, k0 = jax.random.split(key)
    # theta in [0, pi]: P(s=+1) = cos^2(theta/2). Start uniform (theta=pi/2).
    theta0 = jnp.full((r, n_pad), jnp.pi / 2)

    def measure(theta, k):
        p_up = jnp.cos(theta / 2.0) ** 2
        s = jnp.where(jax.random.uniform(k, theta.shape) < p_up, 1.0, -1.0)
        return jnp.where(problem.active_mask[None, :] > 0, s, 1.0)

    def body(carry, it):
        theta, field, best_e, best_s, key = carry
        key, km, kt = jax.random.split(key, 3)
        s = measure(theta, km)
        e = energy_ops.energy(problem, s)
        improved = e < best_e
        best_e = jnp.where(improved, e, best_e)
        best_s = jnp.where(improved[:, None], s, best_s)
        # Bloch rotation toward the field direction: aligning spin i with
        # sign(local field) lowers E when s_i f_i < 0 ... E-convention has
        # dE(flip i) = 2 s_i f_i, so the energetically preferred value is
        # s_i = -sign(f_i)? No: flipping is good when dE<0 i.e. s_i f_i < 0;
        # staying is good when s_i f_i > 0 — preferred s_i = sign(f_i).
        f = energy_ops.local_fields(problem, s)
        target = jnp.where(f >= 0, 0.0, jnp.pi)  # theta=0 → s=+1
        theta = theta + cfg.rotation_rate * (target - theta)
        # tunneling: random spins re-randomized with prob ∝ field strength
        tunnel = jax.random.uniform(kt, theta.shape) < (
            cfg.tunnel_prob * field / cfg.field_start)
        theta = jnp.where(tunnel, jnp.pi / 2.0, theta)
        field = field * cfg.field_decay
        return (theta, field, best_e, best_s, key), jnp.min(best_e)

    s_init = measure(theta0, k0)
    e_init = energy_ops.energy(problem, s_init)
    init = (theta0, jnp.float32(cfg.field_start), e_init, s_init, key)
    t0 = time.perf_counter()
    (theta, field, best_e, best_s, _), hist = lax.scan(
        jax.jit(body), init, jnp.arange(cfg.n_iterations))
    jax.block_until_ready(best_e)
    total = time.perf_counter() - t0
    b = int(jnp.argmin(best_e))
    return AnnealResult(
        best_spins=np.asarray(best_s[b])[: problem.n_spins],
        best_energy=float(jnp.min(best_e)),
        replica_best_energy=np.asarray(best_e),
        energy_history=np.asarray(hist),
        mean_energy_history=np.asarray(hist),
        temperature_history=np.zeros(cfg.n_iterations),
        acceptance_history=np.zeros(cfg.n_iterations),
        n_sweeps=cfg.n_iterations, n_replicas=r, total_time=total,
        sweeps_per_second=cfg.n_iterations / total,
        spin_flips_per_second=cfg.n_iterations * r * problem.n_spins / total,
        algorithm="aqia", device=jax.default_backend(), seed=cfg.seed,
    )


# ---------------------------------------------------------------------------
# MSHO
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MSHOConfig:
    min_size: int = 16
    coarse_sweeps: int = 300
    refine_sweeps: int = 200
    n_replicas: int = 16
    seed: int = 42


def _coarsen(j: np.ndarray, h: np.ndarray) -> Tuple[np.ndarray, np.ndarray,
                                                    np.ndarray]:
    """Greedy heavy-edge matching: pair (i, k) with max |J_ik|; the pair
    becomes one coarse variable (s_i = s_k if J_ik > 0 else s_i = -s_k).
    Returns (J_coarse, h_coarse, mapping[n] = coarse index signed +-1)."""
    n = j.shape[0]
    matched = np.full(n, -1)
    order = np.argsort(-np.abs(j), axis=None)
    pairs = []
    for flat in order:
        a, b = divmod(int(flat), n)
        if a >= b or j[a, b] == 0:
            continue
        if matched[a] < 0 and matched[b] < 0:
            matched[a] = matched[b] = len(pairs)
            pairs.append((a, b, np.sign(j[a, b])))
    # unmatched spins become singleton coarse variables
    groups = []
    signs = np.zeros(n)
    cidx = np.zeros(n, dtype=np.int64)
    for gi, (a, b, sgn) in enumerate(pairs):
        groups.append([a, b])
        cidx[a], cidx[b] = gi, gi
        signs[a], signs[b] = 1.0, sgn  # s_b = sgn * coarse
    for i in range(n):
        if matched[i] < 0:
            gi = len(groups)
            groups.append([i])
            cidx[i] = gi
            signs[i] = 1.0
    m = len(groups)
    jc = np.zeros((m, m))
    hc = np.zeros(m)
    for i in range(n):
        hc[cidx[i]] += signs[i] * h[i]
        for k in range(i + 1, n):
            if cidx[i] != cidx[k]:
                jc[cidx[i], cidx[k]] += signs[i] * signs[k] * j[i, k]
                jc[cidx[k], cidx[i]] = jc[cidx[i], cidx[k]]
    return jc, hc, cidx, signs


def multi_scale_optimization(problem: IsingProblem,
                             cfg: Optional[MSHOConfig] = None) -> AnnealResult:
    cfg = cfg or MSHOConfig()
    n = problem.n_spins
    j = np.asarray(problem.j, np.float64)[:n, :n]
    h = np.asarray(problem.h, np.float64)[:n]

    # build the coarsening hierarchy
    levels = [(j, h, None, None)]
    while levels[-1][0].shape[0] > cfg.min_size:
        jc, hc, cidx, signs = _coarsen(levels[-1][0], levels[-1][1])
        if jc.shape[0] >= levels[-1][0].shape[0]:
            break
        levels.append((jc, hc, cidx, signs))

    t0 = time.perf_counter()
    # solve coarsest, lift + refine upward
    spins = None
    total_sweeps = 0
    for li in range(len(levels) - 1, -1, -1):
        jl, hl, cidx, signs = levels[li]
        pl = IsingProblem.from_dense(jl, hl)
        sweeps = cfg.coarse_sweeps if li == len(levels) - 1 else cfg.refine_sweeps
        init = None
        if spins is not None:
            # lift the coarser solution: s_i = signs[i] * coarse[cidx[i]]
            nxt_cidx = levels[li + 1][2]
            nxt_signs = levels[li + 1][3]
            lifted = nxt_signs * spins[nxt_cidx]
            init = np.ones((cfg.n_replicas, pl.n_padded))
            init[:, : len(lifted)] = lifted
            init = jnp.asarray(init)
        res = anneal(pl, SAConfig(
            n_sweeps=sweeps, n_replicas=cfg.n_replicas,
            schedule=ScheduleConfig(
                initial_temp=2.0 if init is None else 0.5, final_temp=0.01),
            enable_early_stop=False, seed=cfg.seed + li),
            init_spins=init)
        spins = res.best_spins
        total_sweeps += sweeps
    total = time.perf_counter() - t0
    res.algorithm = "msho"
    res.metadata["n_levels"] = len(levels)
    res.total_time = total
    res.n_sweeps = total_sweeps
    return res


# ---------------------------------------------------------------------------
# LESD
# ---------------------------------------------------------------------------

class SpinScorer:
    """Tiny per-spin MLP on local features [s, f, s*f] -> score [...]."""

    def __init__(self, hidden: int = 16):
        self.mlp = MLP((hidden,), 1, activation=jax.nn.relu)

    def init(self, key, feats):
        return self.mlp.init(key, feats)

    def apply(self, params, feats):  # [..., 3]
        return self.mlp.apply(params, feats)[..., 0]


@dataclass(frozen=True)
class LESDConfig:
    n_iterations: int = 300
    n_replicas: int = 16
    temperature: float = 0.5
    lr: float = 1e-2
    explore: float = 0.1
    seed: int = 42


def learning_enhanced_dynamics(problem: IsingProblem,
                               cfg: Optional[LESDConfig] = None
                               ) -> AnnealResult:
    """NN-guided single-spin Metropolis: the scorer biases which spin each
    replica proposes; it is trained online to predict -dE (so high score ==
    energetically good flip)."""
    cfg = cfg or LESDConfig()
    r, n_pad = cfg.n_replicas, problem.n_padded
    model = SpinScorer()
    tx = optax.adam(cfg.lr)
    key = jax.random.key(cfg.seed)
    key, kp, ks = jax.random.split(key, 3)
    params = model.init(kp, jnp.zeros((1, 3)))
    opt_state = tx.init(params)
    spins = random_spins(ks, (r, n_pad), problem.active_mask)
    e = energy_ops.energy(problem, spins)
    beta = 1.0 / cfg.temperature

    def features(spins, f):
        return jnp.stack([spins, f, spins * f], axis=-1)  # [R, N, 3]

    @jax.jit
    def step(params, opt_state, spins, e, best_e, best_s, key):
        key, k_sel, k_acc, k_exp = jax.random.split(key, 4)
        f = energy_ops.local_fields(problem, spins)
        feats = features(spins, f)
        scores = model.apply(params, feats)           # [R, N]
        scores = jnp.where(problem.active_mask[None, :] > 0, scores, -1e9)
        # softmax-sample a proposal spin per replica; epsilon exploration
        gumbel = -jnp.log(-jnp.log(
            jax.random.uniform(k_sel, scores.shape) + 1e-12) + 1e-12)
        pick = jnp.argmax(scores + gumbel, axis=-1)
        rand_pick = jax.random.randint(k_exp, (r,), 0, problem.n_spins)
        explore = jax.random.uniform(k_exp, (r,)) < cfg.explore
        pick = jnp.where(explore, rand_pick, pick)
        de = 2.0 * spins[jnp.arange(r), pick] * f[jnp.arange(r), pick]
        accept = jax.random.uniform(k_acc, (r,)) < jnp.exp(
            -beta * jnp.maximum(de, 0.0))
        spins = spins.at[jnp.arange(r), pick].multiply(
            jnp.where(accept, -1.0, 1.0))
        e = e + jnp.where(accept, de, 0.0)
        improved = e < best_e
        best_e = jnp.where(improved, e, best_e)
        best_s = jnp.where(improved[:, None], spins, best_s)

        # train the scorer to predict -dE of the proposed flips
        def loss_fn(p):
            pred = model.apply(p, feats[jnp.arange(r), pick])
            return jnp.mean((pred - (-de)) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, spins, e, best_e, best_s, key, loss

    best_e, best_s = e, spins
    losses = []
    t0 = time.perf_counter()
    for it in range(cfg.n_iterations):
        (params, opt_state, spins, e, best_e, best_s, key,
         loss) = step(params, opt_state, spins, e, best_e, best_s, key)
        losses.append(float(loss))
    total = time.perf_counter() - t0
    b = int(jnp.argmin(best_e))
    return AnnealResult(
        best_spins=np.asarray(best_s[b])[: problem.n_spins],
        best_energy=float(jnp.min(best_e)),
        replica_best_energy=np.asarray(best_e),
        energy_history=np.asarray(losses),
        mean_energy_history=np.asarray(losses),
        temperature_history=cfg.temperature * np.ones(len(losses)),
        acceptance_history=np.zeros(len(losses)),
        n_sweeps=cfg.n_iterations, n_replicas=r, total_time=total,
        sweeps_per_second=cfg.n_iterations / total,
        spin_flips_per_second=cfg.n_iterations * r / total,
        algorithm="lesd", device=jax.default_backend(), seed=cfg.seed,
        metadata={"final_loss": losses[-1] if losses else None},
    )


# ---------------------------------------------------------------------------
# QEC annealer
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class QECConfig:
    repetition: int = 3        # physical spins per logical spin (odd)
    code_coupling: float = 2.0  # intra-triple ferromagnetic lock
    n_sweeps: int = 400
    n_replicas: int = 16
    seed: int = 42


def quantum_error_corrected_annealing(problem: IsingProblem,
                                      cfg: Optional[QECConfig] = None
                                      ) -> AnnealResult:
    """Repetition-code annealing (reference QuantumErrorCorrectedAnnealer,
    breakthrough_algorithms.py:162-279): each logical spin is encoded as
    ``repetition`` physical spins bound by strong ferromagnetic couplings;
    logical couplings are distributed over the copies; majority vote decodes.
    Thermal single-spin errors inside a triple cost code energy, suppressing
    them — a classical analog of error suppression."""
    cfg = cfg or QECConfig()
    rep = cfg.repetition
    n = problem.n_spins
    j = np.asarray(problem.j, np.float64)[:n, :n]
    h = np.asarray(problem.h, np.float64)[:n]

    big = np.kron(j / (rep * rep), np.ones((rep, rep)))
    for i in range(n):
        sl = slice(i * rep, (i + 1) * rep)
        big[sl, sl] = cfg.code_coupling * (np.ones((rep, rep)) - np.eye(rep))
    h_big = np.repeat(h / rep, rep)
    encoded = IsingProblem.from_dense(big, h_big)

    from spinglass_tpu.anneal.schedules import ScheduleConfig

    res = anneal(encoded, SAConfig(
        n_sweeps=cfg.n_sweeps, n_replicas=cfg.n_replicas,
        schedule=ScheduleConfig(initial_temp=3.0, final_temp=0.01,
                                total_sweeps=cfg.n_sweeps),
        enable_early_stop=False, seed=cfg.seed))
    # majority decode
    phys = res.best_spins[: n * rep].reshape(n, rep)
    logical = np.where(phys.sum(axis=1) >= 0, 1.0, -1.0)
    s = np.ones(problem.n_padded)
    s[:n] = logical
    res.best_spins = logical
    res.best_energy = float(energy_ops.energy(problem, jnp.asarray(s)))
    res.algorithm = "qec_annealer"
    res.metadata["repetition"] = rep
    res.metadata["code_violations"] = int(
        np.sum(np.abs(phys.sum(axis=1)) != rep))
    return res


ALGORITHM_REGISTRY = {
    "aqia": adaptive_quantum_inspired_annealing,
    "msho": multi_scale_optimization,
    "lesd": learning_enhanced_dynamics,
    "qec": quantum_error_corrected_annealing,
}


def compare_algorithms(problem: IsingProblem, algorithms=None,
                       seed: int = 42) -> dict:
    """Comparison harness (reference novel_algorithms.py:771-845)."""
    out = {}
    for name in (algorithms or list(ALGORITHM_REGISTRY)):
        res = ALGORITHM_REGISTRY[name](problem)
        out[name] = {"best_energy": res.best_energy,
                     "total_time": res.total_time}
    return out
