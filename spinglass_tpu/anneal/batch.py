"""Batch annealing over many problem instances.

Rebuilds the reference's BatchProcessor/AdaptiveBatchProcessor
(annealing/batch_processor.py:180-652), which thread-pooled GPUAnnealer calls
over <=4 workers. Here same-shape problems stack into a leading
problem axis and anneal as ONE jitted vmapped run (problems x replicas
batched together in one matrix product); differently-sized problems bucket by padded
size so each bucket compiles once. Memory-aware batch sizing uses device HBM
stats instead of the reference's CUDA heuristics (cuda_kernels.py:458-490),
and per-batch checkpoints mirror batch_processor.py:521-531."""

from __future__ import annotations

import time
from dataclasses import dataclass, field as dfield
from typing import Iterable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from spinglass_tpu.anneal import schedules
from spinglass_tpu.anneal.result import AnnealResult
from spinglass_tpu.anneal.sa import SAConfig
from spinglass_tpu.core import energy as energy_ops
from spinglass_tpu.core.problem import IsingProblem, random_spins
from spinglass_tpu.kernels import sweeps as sweep_kernels


@dataclass(frozen=True)
class BatchConfig:
    """Reference BatchConfig (batch_processor.py:22-42)."""

    max_batch_size: int = 16
    memory_fraction: float = 0.6       # of free HBM
    checkpoint_interval: int = 0       # batches; 0 = off
    checkpoint_dir: Optional[str] = None


def stack_problems(problems: Sequence[IsingProblem]) -> IsingProblem:
    """Stack same-padded-size problems into a [P, Np, Np] / [P, Np] pytree.

    The result is an IsingProblem whose leaves carry a leading problem axis;
    all energy/sweep functions vmap over it."""
    n_pad = problems[0].n_padded
    if any(p.n_padded != n_pad for p in problems):
        raise ValueError("stack_problems requires equal padded sizes")
    return IsingProblem(
        j=jnp.stack([p.j for p in problems]),
        h=jnp.stack([p.h for p in problems]),
        active_mask=jnp.stack([p.active_mask for p in problems]),
        n_spins=max(p.n_spins for p in problems),
    )


def estimate_batch_size(n_padded: int, n_replicas: int,
                        cfg: BatchConfig) -> int:
    """HBM-based batch sizing (replaces GPUMemoryOptimizer,
    cuda_kernels.py:458-490)."""
    try:
        dev = jax.local_devices()[0]
        stats = dev.memory_stats() or {}
        free = stats.get("bytes_limit", 16e9) - stats.get("bytes_in_use", 0)
    except Exception:
        free = 8e9
    per_problem = 4.0 * (n_padded * n_padded          # J
                         + 3 * n_replicas * n_padded)  # spins/best/uniforms
    est = int(max(1, cfg.memory_fraction * free / max(per_problem, 1)))
    return min(est, cfg.max_batch_size)


def _anneal_stacked(stacked: IsingProblem, sa_cfg: SAConfig,
                    key: jax.Array) -> dict:
    """Jitted multi-problem anneal: vmap of the colored-free blocked sweep
    over the problem axis, replicas inside."""
    n_problems = stacked.j.shape[0]
    r = sa_cfg.n_replicas
    n_pad = stacked.j.shape[-1]

    def single(problem_j, problem_h, problem_mask, key):
        problem = IsingProblem(j=problem_j, h=problem_h,
                               active_mask=problem_mask,
                               n_spins=stacked.n_spins)
        key, sub = jax.random.split(key)
        spins = random_spins(sub, (r, n_pad), problem_mask)
        e = energy_ops.energy(problem, spins)

        def body(carry, t):
            spins, e, best_e, best_s, key = carry
            key, ku = jax.random.split(key)
            u = jax.random.uniform(ku, (r, n_pad), jnp.float32)
            temp = schedules.temperature_at(sa_cfg.schedule, t)
            beta = 1.0 / jnp.maximum(temp, 1e-10)
            spins, de, _ = sweep_kernels.blocked_sweep(
                problem, spins, beta, u, block_size=sa_cfg.block_size,
                rule=sa_cfg.update_rule)
            e = e + de
            improved = e < best_e
            best_e = jnp.where(improved, e, best_e)
            best_s = jnp.where(improved[:, None], spins, best_s)
            return (spins, e, best_e, best_s, key), None

        (spins, e, best_e, best_s, _), _ = lax.scan(
            body, (spins, e, e, spins, key), jnp.arange(sa_cfg.n_sweeps))
        b = jnp.argmin(best_e)
        return {"best_energy": best_e[b], "best_spins": best_s[b],
                "replica_best": best_e}

    keys = jax.random.split(key, n_problems)
    return jax.jit(jax.vmap(single))(stacked.j, stacked.h,
                                     stacked.active_mask, keys)


class BatchProcessor:
    """Solve many instances: bucket by size, stack, vmap-anneal per batch."""

    def __init__(self, sa_config: Optional[SAConfig] = None,
                 batch_config: Optional[BatchConfig] = None):
        self.sa_config = sa_config or SAConfig(n_sweeps=200, n_replicas=16)
        self.batch_config = batch_config or BatchConfig()
        self.n_processed = 0
        self.failures: List[int] = []

    def process(self, problems: Sequence[IsingProblem],
                seed: int = 0) -> List[AnnealResult]:
        """Batched solve preserving input order."""
        results: List[Optional[AnnealResult]] = [None] * len(problems)
        # bucket by padded size for uniform shapes per compile
        buckets: dict[int, List[int]] = {}
        for i, p in enumerate(problems):
            buckets.setdefault(p.n_padded, []).append(i)
        key = jax.random.key(seed)
        batch_no = 0
        for n_pad, idxs in sorted(buckets.items()):
            bs = estimate_batch_size(n_pad, self.sa_config.n_replicas,
                                     self.batch_config)
            for lo in range(0, len(idxs), bs):
                chunk = idxs[lo: lo + bs]
                key, sub = jax.random.split(key)
                t0 = time.perf_counter()
                try:
                    stacked = stack_problems([problems[i] for i in chunk])
                    out = _anneal_stacked(stacked, self.sa_config, sub)
                    dt = time.perf_counter() - t0
                    for k, i in enumerate(chunk):
                        p = problems[i]
                        flips = (self.sa_config.n_sweeps
                                 * self.sa_config.n_replicas * p.n_spins)
                        results[i] = AnnealResult(
                            best_spins=np.asarray(
                                out["best_spins"][k])[: p.n_spins],
                            best_energy=float(out["best_energy"][k]),
                            replica_best_energy=np.asarray(
                                out["replica_best"][k]),
                            energy_history=np.asarray(
                                [float(out["best_energy"][k])]),
                            mean_energy_history=np.zeros(1),
                            temperature_history=np.zeros(1),
                            acceptance_history=np.zeros(1),
                            n_sweeps=self.sa_config.n_sweeps,
                            n_replicas=self.sa_config.n_replicas,
                            total_time=dt / len(chunk),
                            sweeps_per_second=(
                                self.sa_config.n_sweeps * len(chunk) / dt),
                            spin_flips_per_second=flips * len(chunk) / dt,
                            algorithm="sa/batched",
                            device=jax.default_backend(),
                            seed=seed,
                        )
                        self.n_processed += 1
                except Exception:
                    # per-batch failure isolation (reference substitutes
                    # inf-energy dummies, batch_processor.py:436-452) —
                    # fall back to per-problem solves
                    from spinglass_tpu.anneal.sa import anneal

                    for i in chunk:
                        try:
                            results[i] = anneal(problems[i], self.sa_config)
                            self.n_processed += 1
                        except Exception:
                            self.failures.append(i)
                            results[i] = None
                batch_no += 1
                self._maybe_checkpoint(batch_no, results)
        return results  # type: ignore[return-value]

    def process_stream(self, problem_iter: Iterable[IsingProblem],
                       batch_size: Optional[int] = None,
                       seed: int = 0):
        """Streaming mode (reference batch_processor.py:290-345): yield
        results batch by batch without holding the whole dataset."""
        batch: List[IsingProblem] = []
        bs = batch_size or self.batch_config.max_batch_size
        for p in problem_iter:
            batch.append(p)
            if len(batch) >= bs:
                yield from self.process(batch, seed=seed)
                batch = []
                seed += 1
        if batch:
            yield from self.process(batch, seed=seed)

    def _maybe_checkpoint(self, batch_no: int, results) -> None:
        cfg = self.batch_config
        if not cfg.checkpoint_interval or not cfg.checkpoint_dir:
            return
        if batch_no % cfg.checkpoint_interval:
            return
        import json
        import os

        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        done = [i for i, r in enumerate(results) if r is not None]
        with open(os.path.join(cfg.checkpoint_dir,
                               f"batch_progress_{batch_no}.json"), "w") as f:
            json.dump({"batch": batch_no, "completed": done,
                       "n_failures": len(self.failures)}, f)


class AdaptiveBatchProcessor(BatchProcessor):
    """Throughput-adaptive batch sizing (reference batch_processor.py:557-652):
    grows the batch while throughput improves, shrinks on regression."""

    def __init__(self, *args, growth: float = 1.5, **kwargs):
        super().__init__(*args, **kwargs)
        self.growth = growth
        self._current_bs = 2
        self._last_throughput = 0.0

    def process(self, problems: Sequence[IsingProblem],
                seed: int = 0) -> List[AnnealResult]:
        results: List[Optional[AnnealResult]] = [None] * len(problems)
        i = 0
        key_seed = seed
        while i < len(problems):
            chunk = list(range(i, min(i + self._current_bs, len(problems))))
            t0 = time.perf_counter()
            sub = super().process([problems[c] for c in chunk],
                                  seed=key_seed)
            dt = max(time.perf_counter() - t0, 1e-9)
            for k, c in enumerate(chunk):
                results[c] = sub[k]
            throughput = len(chunk) / dt
            if throughput >= self._last_throughput:
                self._current_bs = min(
                    int(self._current_bs * self.growth) + 1,
                    self.batch_config.max_batch_size)
            else:
                self._current_bs = max(2, self._current_bs // 2)
            self._last_throughput = throughput
            i += len(chunk)
            key_seed += 1
        return results  # type: ignore[return-value]
