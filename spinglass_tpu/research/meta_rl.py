"""Adaptive meta-RL over problem classes.

Rebuilds the reference's ``research/adaptive_meta_rl.py`` tier (SURVEY §2.8):
ProblemCharacterizer (:139), MetaLearningNetwork (:284), EpisodicMemory
(:384), NeuralArchitectureSearch (:428) and AdaptiveMetaRLAgent (:565) —
an agent that looks at a problem instance, proposes an annealing strategy
(temperature endpoints, cooling rate, replica budget) from a learned model
plus an episodic memory of past solves, executes it, and improves from the
outcome.

Design: the strategy network is a plain-JAX MLP whose regression fit
runs as one jitted full-batch Adam loop over the episodic dataset (the
reference trains a torch net sample-by-sample); the solves it controls are
the jitted SA/PT engines. The architecture search is a host-side
evolutionary loop — its *evaluations* (network fits) are the jitted part.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from spinglass_tpu.anneal.sa import SAConfig, anneal
from spinglass_tpu.anneal.schedules import ScheduleConfig, ScheduleType
from spinglass_tpu.core.problem import IsingProblem
from spinglass_tpu.research.meta import characterize
from spinglass_tpu.rl.mlp import MLP

EMBED_DIM = 8       # characterize() feature vector
STRATEGY_DIM = 3    # [log10 T0, logit(alpha scaled), log2 replica-mult]


class ProblemCharacterizer:
    """Class facade over :func:`characterize` (reference ProblemCharacterizer,
    adaptive_meta_rl.py:139-283), plus batch characterization and feature
    names for reporting."""

    feature_names = (
        "log10_n", "density", "mean_abs_j", "std_j", "frustration",
        "mean_abs_h", "degree_cv", "frac_negative_j",
    )

    def characterize(self, problem: IsingProblem) -> np.ndarray:
        return characterize(problem)

    def characterize_batch(self,
                           problems: Sequence[IsingProblem]) -> np.ndarray:
        return np.stack([characterize(p) for p in problems])

    def describe(self, problem: IsingProblem) -> dict:
        return dict(zip(self.feature_names, characterize(problem).tolist()))


# ---------------------------------------------------------------------------
# Strategy <-> vector codec
# ---------------------------------------------------------------------------

def encode_strategy(initial_temp: float, alpha: float,
                    replica_mult: float = 1.0) -> np.ndarray:
    """Map strategy params to an unconstrained R^3 vector for regression."""
    a = min(max((alpha - 0.9) / 0.0999, 1e-4), 1 - 1e-4)  # alpha in (0.9, 1)
    return np.asarray([
        math.log10(max(initial_temp, 1e-3)),
        math.log(a / (1 - a)),
        math.log2(max(replica_mult, 0.25)),
    ], dtype=np.float32)


def decode_strategy(vec: np.ndarray) -> dict:
    v = np.asarray(vec, dtype=np.float64)
    alpha = 0.9 + 0.0999 / (1.0 + math.exp(-float(v[1])))
    return {
        "initial_temp": float(10.0 ** np.clip(v[0], -1.0, 2.0)),
        "alpha": float(alpha),
        "replica_mult": float(2.0 ** np.clip(v[2], -2.0, 2.0)),
    }


# ---------------------------------------------------------------------------
# Episodic memory
# ---------------------------------------------------------------------------

@dataclass
class Episode:
    embedding: np.ndarray    # [EMBED_DIM]
    strategy: np.ndarray     # [STRATEGY_DIM]
    score: float             # outcome (higher is better)


@dataclass
class EpisodicMemory:
    """Bounded store of (problem embedding, strategy, outcome) episodes with
    kernel-weighted nearest-neighbor recall (reference EpisodicMemory,
    adaptive_meta_rl.py:384-427). Eviction drops the worst-scoring episode
    once ``capacity`` is reached, so memory quality is monotone."""

    capacity: int = 256
    episodes: List[Episode] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.episodes)

    def store(self, embedding: np.ndarray, strategy: np.ndarray,
              score: float) -> None:
        self.episodes.append(Episode(np.asarray(embedding, np.float32),
                                     np.asarray(strategy, np.float32),
                                     float(score)))
        if len(self.episodes) > self.capacity:
            worst = int(np.argmin([e.score for e in self.episodes]))
            self.episodes.pop(worst)

    def recall(self, embedding: np.ndarray, k: int = 5,
               bandwidth: float = 1.0) -> Optional[np.ndarray]:
        """Score-and-distance-weighted blend of the k nearest strategies;
        None when the memory is empty."""
        if not self.episodes:
            return None
        emb = np.stack([e.embedding for e in self.episodes])
        d = np.linalg.norm(emb - np.asarray(embedding, np.float32), axis=1)
        near = np.argsort(d)[:k]
        w = np.exp(-d[near] / max(bandwidth, 1e-6))
        w = w * np.maximum([self.episodes[i].score for i in near], 1e-6)
        if w.sum() <= 0:
            w = np.ones_like(w)
        strat = np.stack([self.episodes[i].strategy for i in near])
        return (w[:, None] * strat).sum(0) / w.sum()

    def nearest_distance(self, embedding: np.ndarray) -> float:
        if not self.episodes:
            return float("inf")
        emb = np.stack([e.embedding for e in self.episodes])
        return float(np.linalg.norm(
            emb - np.asarray(embedding, np.float32), axis=1).min())

    def dataset(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        x = np.stack([e.embedding for e in self.episodes])
        y = np.stack([e.strategy for e in self.episodes])
        s = np.asarray([e.score for e in self.episodes], np.float32)
        return x, y, s


# ---------------------------------------------------------------------------
# Meta-learning network
# ---------------------------------------------------------------------------

class MetaLearningNetwork(MLP):
    """MLP: problem embedding -> strategy vector (reference
    MetaLearningNetwork, adaptive_meta_rl.py:284-383)."""

    def __init__(self, hidden_sizes: Tuple[int, ...] = (64, 64),
                 out_dim: int = STRATEGY_DIM):
        super().__init__(hidden_sizes, out_dim, activation=jnp.tanh,
                         layer_norm=True)


def fit_meta_network(model: MetaLearningNetwork, x: np.ndarray,
                     y: np.ndarray, weights: np.ndarray,
                     n_steps: int = 200, lr: float = 3e-3,
                     seed: int = 0, params=None) -> Tuple[dict, float]:
    """Score-weighted regression of strategies onto embeddings as ONE jitted
    ``lax.scan`` of full-batch Adam steps (episodic datasets are tiny, so
    full-batch on-device beats the reference's per-sample torch loop).
    Returns (params, final weighted MSE)."""
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    w = jnp.asarray(weights, jnp.float32)
    w = jnp.maximum(w, 0.0) + 1e-3
    w = w / jnp.mean(w)
    if params is None:
        params = model.init(jax.random.key(seed), x[:1])
    tx = optax.adam(lr)
    opt_state = tx.init(params)

    def loss_fn(p):
        pred = model.apply(p, x)
        return jnp.mean(w[:, None] * (pred - y) ** 2)

    def step(carry, _):
        p, s = carry
        loss, g = jax.value_and_grad(loss_fn)(p)
        updates, s = tx.update(g, s, p)
        return (optax.apply_updates(p, updates), s), loss

    (params, _), losses = jax.lax.scan(step, (params, opt_state),
                                       None, length=n_steps)
    return params, float(losses[-1])


# ---------------------------------------------------------------------------
# Neural architecture search
# ---------------------------------------------------------------------------

@dataclass
class NASResult:
    architecture: Tuple[int, ...]
    score: float
    history: List[dict]


class NeuralArchitectureSearch:
    """Evolutionary width/depth search for the meta network (reference
    NeuralArchitectureSearch, adaptive_meta_rl.py:428-564).

    Mutations grow/shrink/widen/narrow the hidden-layer tuple; candidates are
    scored by ``eval_fn(arch) -> score`` (higher is better). The default
    eval, built by :meth:`default_eval`, is the negative held-out regression
    loss of a :class:`MetaLearningNetwork` with that architecture on an
    episodic dataset — each evaluation is one jitted fit."""

    WIDTHS = (16, 32, 64, 128, 256)

    def __init__(self, population: int = 6, generations: int = 3,
                 seed: int = 0):
        self.population = population
        self.generations = generations
        self.rng = np.random.default_rng(seed)

    def _mutate(self, arch: Tuple[int, ...]) -> Tuple[int, ...]:
        arch = list(arch)
        op = self.rng.choice(["widen", "narrow", "deepen", "shrink"])
        i = self.rng.integers(len(arch))
        wi = self.WIDTHS.index(min(self.WIDTHS,
                                   key=lambda w: abs(w - arch[i])))
        if op == "widen" and wi + 1 < len(self.WIDTHS):
            arch[i] = self.WIDTHS[wi + 1]
        elif op == "narrow" and wi > 0:
            arch[i] = self.WIDTHS[wi - 1]
        elif op == "deepen" and len(arch) < 4:
            arch.insert(i, arch[i])
        elif op == "shrink" and len(arch) > 1:
            arch.pop(i)
        return tuple(arch)

    def search(self, eval_fn: Callable[[Tuple[int, ...]], float],
               initial: Tuple[int, ...] = (64, 64)) -> NASResult:
        pop = [tuple(initial)]
        while len(pop) < self.population:
            cand = self._mutate(pop[-1])
            if cand not in pop:
                pop.append(cand)
        history = []
        scored = {}
        for gen in range(self.generations):
            for arch in pop:
                if arch not in scored:
                    scored[arch] = float(eval_fn(arch))
            ranked = sorted(pop, key=lambda a: scored[a], reverse=True)
            history.append({"generation": gen,
                            "best": ranked[0], "score": scored[ranked[0]]})
            # next generation: elites + their mutations
            elites = ranked[: max(2, self.population // 3)]
            pop = list(elites)
            while len(pop) < self.population:
                cand = self._mutate(elites[self.rng.integers(len(elites))])
                if cand not in pop:
                    pop.append(cand)
        best = max(scored, key=scored.get)
        return NASResult(best, scored[best], history)

    @staticmethod
    def default_eval(x: np.ndarray, y: np.ndarray, weights: np.ndarray,
                     n_steps: int = 100, seed: int = 0):
        """eval_fn factory: negative final fit loss on (x, y, weights)."""

        def eval_fn(arch: Tuple[int, ...]) -> float:
            model = MetaLearningNetwork(hidden_sizes=tuple(arch))
            _, loss = fit_meta_network(model, x, y, weights,
                                       n_steps=n_steps, seed=seed)
            return -loss

        return eval_fn


# ---------------------------------------------------------------------------
# The agent
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MetaRLConfig:
    n_sweeps: int = 400
    n_replicas: int = 16
    memory_capacity: int = 256
    refit_interval: int = 8        # retrain the network every k solves
    fit_steps: int = 150
    recall_distance: float = 1.5   # use memory when a neighbor is this close
    explore_std: float = 0.15      # Gaussian exploration in strategy space
    nas_after: int = 0             # run NAS once memory has this many episodes (0 = off)
    seed: int = 0


class AdaptiveMetaRLAgent:
    """Meta-level controller (reference AdaptiveMetaRLAgent,
    adaptive_meta_rl.py:565-1027): characterize -> propose strategy
    (episodic recall near known problems, network prediction otherwise,
    plus Gaussian exploration) -> run the jitted annealer -> score the
    outcome -> store the episode -> periodically refit the network (and
    optionally re-search its architecture)."""

    def __init__(self, cfg: Optional[MetaRLConfig] = None):
        self.cfg = cfg or MetaRLConfig()
        self.characterizer = ProblemCharacterizer()
        self.memory = EpisodicMemory(capacity=self.cfg.memory_capacity)
        self.model = MetaLearningNetwork()
        self.params = None
        self.rng = np.random.default_rng(self.cfg.seed)
        self.n_solves = 0
        self.fit_log: List[float] = []

    # -- strategy proposal ---------------------------------------------------

    def propose(self, problem: IsingProblem) -> Tuple[np.ndarray, dict, str]:
        emb = self.characterizer.characterize(problem)
        source = "default"
        vec = encode_strategy(5.0, 0.99)
        if (self.memory.nearest_distance(emb) < self.cfg.recall_distance):
            rec = self.memory.recall(emb)
            if rec is not None:
                vec, source = rec, "memory"
        elif self.params is not None:
            vec = np.asarray(
                self.model.apply(self.params, jnp.asarray(emb)[None])[0])
            source = "network"
        vec = vec + self.rng.normal(0.0, self.cfg.explore_std, STRATEGY_DIM)
        return emb, decode_strategy(vec) | {"_vec": vec}, source

    # -- solve + learn -------------------------------------------------------

    def solve(self, problem: IsingProblem):
        emb, strat, source = self.propose(problem)
        n_rep = max(4, int(round(self.cfg.n_replicas * strat["replica_mult"])))
        res = anneal(problem, SAConfig(
            n_sweeps=self.cfg.n_sweeps, n_replicas=n_rep,
            schedule=ScheduleConfig(
                ScheduleType.GEOMETRIC, initial_temp=strat["initial_temp"],
                final_temp=0.01, alpha=strat["alpha"],
                total_sweeps=self.cfg.n_sweeps),
            enable_early_stop=False, seed=self.cfg.seed + self.n_solves))
        first = (float(res.mean_energy_history[0])
                 if len(res.mean_energy_history) else 0.0)
        score = (first - res.best_energy) / max(abs(first), 1e-9)
        self.memory.store(emb, strat["_vec"], score)
        self.n_solves += 1
        if (self.n_solves % self.cfg.refit_interval == 0
                and len(self.memory) >= 4):
            self.refit()
        return res, {"strategy": {k: v for k, v in strat.items()
                                  if not k.startswith("_")},
                     "source": source, "score": score}

    def refit(self) -> float:
        x, y, s = self.memory.dataset()
        if (self.cfg.nas_after and len(self.memory) >= self.cfg.nas_after
                and not self.fit_log):
            nas = NeuralArchitectureSearch(seed=self.cfg.seed)
            best = nas.search(NeuralArchitectureSearch.default_eval(
                x, y, s, n_steps=self.cfg.fit_steps // 2))
            self.model = MetaLearningNetwork(hidden_sizes=best.architecture)
            self.params = None
        self.params, loss = fit_meta_network(
            self.model, x, y, s, n_steps=self.cfg.fit_steps,
            seed=self.cfg.seed, params=self.params)
        self.fit_log.append(loss)
        return loss

    def report(self) -> dict:
        return {
            "n_solves": self.n_solves,
            "memory_size": len(self.memory),
            "fits": len(self.fit_log),
            "last_fit_loss": self.fit_log[-1] if self.fit_log else None,
            "architecture": tuple(self.model.hidden_sizes),
        }
