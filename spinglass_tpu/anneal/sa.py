"""Simulated-annealing driver: jit-compiled lax.scan over sweeps, replicas vmapped.

Replaces the reference's GPUAnnealer (annealing/gpu_annealer.py:62-391). The
reference loops sweeps in Python and records history into Python lists; here the
whole run is one (or a few) jitted scans with fixed-size history buffers, and the
replica axis is a batched leading dimension instead of independent runs.

Annealing state lives in the sweep engine's preferred layout ([R, N] for the
dense engines, [N, R] for the transposed sparse engine) for the whole scan;
layout conversions happen only at chunk boundaries.

Early stopping keeps the reference's semantics (relative std of the last 20
recorded energies < tolerance, gpu_annealer.py:254-269) via host-side chunking:
each chunk of ``record_interval`` sweeps is one device-side scan; convergence is
checked between chunks.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field as dfield
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from spinglass_tpu.anneal import schedules
from spinglass_tpu.anneal.engines import SweepEngine, make_engine
from spinglass_tpu.anneal.result import AnnealResult
from spinglass_tpu.anneal.schedules import ScheduleConfig, ScheduleState
from spinglass_tpu.core import energy as energy_ops
from spinglass_tpu.core import pytree
from spinglass_tpu.core.problem import IsingProblem, random_spins


@dataclass(frozen=True)
class SAConfig:
    """Static annealer configuration (reference GPUAnnealerConfig,
    gpu_annealer.py:30-59)."""

    n_sweeps: int = 1000
    n_replicas: int = 32
    schedule: ScheduleConfig = dfield(default_factory=ScheduleConfig)
    update_rule: str = "metropolis"          # metropolis | glauber
    sweep_method: str = "auto"               # auto | colored | blocked
    block_size: int = 128
    max_colors_for_colored: int = 8          # auto: colored if coloring is this small
    record_interval: int = 50
    convergence_tolerance: float = 1e-6
    enable_early_stop: bool = True
    use_pallas: str = "auto"                 # auto | never | always
    seed: int = 42

    def __post_init__(self):
        # keep the cooling horizon in sync with the sweep budget — otherwise
        # short runs with the default schedule never cool (the schedule's own
        # total_sweeps default is independent of n_sweeps)
        import dataclasses as _dc

        if self.schedule.total_sweeps != self.n_sweeps and self.n_sweeps > 0:
            object.__setattr__(
                self, "schedule",
                _dc.replace(self.schedule, total_sweeps=self.n_sweeps))


@pytree.dataclass
class SAState:
    """Carried annealing state. ``spins``/``best_spins`` are stored in the
    active engine's layout (see engines.SweepEngine.layout)."""

    spins: jax.Array
    energy: jax.Array         # [R] f32 (incrementally tracked)
    best_energy: jax.Array    # [R]
    best_spins: jax.Array
    sched: ScheduleState
    key: jax.Array
    sweep: jax.Array          # i32 scalar
    acc_rate: jax.Array       # [R] last sweep's acceptance rate


def make_sweep_engine(problem: IsingProblem, config: SAConfig) -> SweepEngine:
    return make_engine(
        problem,
        sweep_method=config.sweep_method,
        update_rule=config.update_rule,
        block_size=config.block_size,
        use_pallas=config.use_pallas,
        max_colors=config.max_colors_for_colored,
        r_hint=config.n_replicas,
    )


def _energy_in_layout(problem: IsingProblem, engine: SweepEngine,
                      spins: jax.Array) -> jax.Array:
    return engine.energy(spins)


def init_state(problem: IsingProblem, config: SAConfig, engine: SweepEngine,
               key: Optional[jax.Array] = None,
               init_spins: Optional[jax.Array] = None) -> SAState:
    """init_spins, when given, is [R, N] regardless of engine layout."""
    if key is None:
        key = jax.random.key(config.seed)
    key, sub = jax.random.split(key)
    if init_spins is None:
        spins_rn = random_spins(sub, (config.n_replicas, problem.n_padded),
                                problem.active_mask)
    else:
        spins_rn = init_spins
    spins = engine.to_layout(spins_rn)
    e = _energy_in_layout(problem, engine, spins)
    return SAState(
        spins=spins,
        energy=e,
        best_energy=e,
        best_spins=spins,
        sched=schedules.init_state(config.schedule),
        key=key,
        sweep=jnp.asarray(0, jnp.int32),
        acc_rate=jnp.zeros((config.n_replicas,), jnp.float32),
    )


def jit_init(config: SAConfig, engine: SweepEngine):
    """``init_state`` compiled as one program, taking (problem, engine
    operands, key, init_spins). Run op by op instead, the initial energy of
    a sparse engine compiles one small program per degree bucket."""
    return jax.jit(lambda prob, ops, key, init_spins: init_state(
        prob, config, engine.bind(ops), key, init_spins))


def _one_sweep(problem: IsingProblem, config: SAConfig, engine: SweepEngine,
               state: SAState) -> SAState:
    key, sub = jax.random.split(state.key)
    temp = state.sched.temp
    beta = 1.0 / jnp.maximum(temp, 1e-10)
    spins, de, cnt = engine.sweep(state.spins, beta, sub)
    energy = state.energy + de
    improved = energy < state.best_energy
    imp_b = improved[None, :] if engine.layout == "nr" else improved[:, None]
    best_energy = jnp.where(improved, energy, state.best_energy)
    best_spins = jnp.where(imp_b, spins, state.best_spins)
    acc_rate = cnt.astype(jnp.float32) / problem.n_spins
    sched = schedules.update(config.schedule, state.sched, state.sweep,
                             jnp.mean(acc_rate))
    return SAState(spins=spins, energy=energy, best_energy=best_energy,
                   best_spins=best_spins, sched=sched, key=key,
                   sweep=state.sweep + 1, acc_rate=acc_rate)


def run_chunk(problem: IsingProblem, config: SAConfig, engine: SweepEngine,
              state: SAState, n_sweeps: int) -> Tuple[SAState, dict]:
    """n_sweeps of annealing as one device-side scan; returns summary stats."""

    def body(st, _):
        return _one_sweep(problem, config, engine, st), None

    state, _ = lax.scan(body, state, None, length=n_sweeps)
    # periodic exact-energy resync kills f32 incremental drift
    state = state.replace(energy=_energy_in_layout(problem, engine, state.spins))
    stats = {
        "best_energy": jnp.min(state.best_energy),
        "mean_energy": jnp.mean(state.energy),
        "temperature": state.sched.temp,
        "acceptance": jnp.mean(state.acc_rate),
    }
    return state, stats


def _ckpt_tree(state: SAState, hists: dict, sweeps_done: int) -> dict:
    return {"state": state,
            "hist": {k: np.asarray(v, np.float32) for k, v in hists.items()},
            "sweeps_done": np.int64(sweeps_done)}


def anneal(problem: IsingProblem, config: Optional[SAConfig] = None,
           key: Optional[jax.Array] = None,
           init_spins: Optional[jax.Array] = None,
           checkpoint_dir: Optional[str] = None,
           checkpoint_every: int = 10,
           resume: bool = False) -> AnnealResult:
    """Full annealing run with history recording + optional early stop.

    The device boundary is per-chunk (record_interval sweeps per jitted scan);
    histories live on host like the reference's record lists but cost one small
    transfer per chunk instead of per-sweep .item() syncs.

    Checkpoint/resume (reference batch_processor.py:521-531 +
    training_pipeline.py:437-507 save AND load):
    ``checkpoint_dir`` saves (SAState, histories, sweep counter) every
    ``checkpoint_every`` chunks; ``resume=True`` restores the latest
    checkpoint from that directory and continues — under a fixed seed the
    resumed run reproduces the uninterrupted run exactly (all RNG state
    lives in SAState.key).
    """
    config = config or SAConfig()

    # Signature sharing (r5): dense problems with equal trace_signature
    # AND an engine whose program is shape-only (SIGNATURE_SHARED_ENGINES)
    # share the compiled chunk; the engine is built up front so its
    # IDENTITY is part of the key (auto dispatch is content-dependent —
    # same-shape problems can pick colored vs blocked, whose operand
    # pytrees differ; see engines.SIGNATURE_SHARED_ENGINES).
    from spinglass_tpu.anneal.engines import SIGNATURE_SHARED_ENGINES
    from spinglass_tpu.anneal.jit_cache import sa_cache

    pre_engine, sig = None, None
    if hasattr(problem, "trace_signature"):
        pre_engine = make_sweep_engine(problem, config)
        if pre_engine.name in SIGNATURE_SHARED_ENGINES:
            sig = (problem.trace_signature(), pre_engine.name)

    def _build():
        engine = (pre_engine if pre_engine is not None
                  else make_sweep_engine(problem, config))

        # prob/eng_ops as TRACED args: closure-embedding the problem and
        # engine arrays bakes J into the HLO as constants (see
        # engines.SweepEngine docstring)
        def chunk(state, prob, eng_ops, n_sweeps):
            return run_chunk(prob, config, engine.bind(eng_ops), state,
                             n_sweeps)

        return (engine, jax.jit(chunk, static_argnames=("n_sweeps",)),
                jit_init(config, engine))

    engine, chunk_jit, init_jit = sa_cache().get_or_build(
        problem, ("anneal", config), _build, signature=sig)
    if engine.problem is not problem:  # cross-object signature hit
        engine = pre_engine

    eng_ops = engine.operands()
    state = init_jit(problem, eng_ops, key, init_spins)
    n_chunks = max(1, -(-config.n_sweeps // config.record_interval))
    e_hist, me_hist, t_hist, a_hist = [], [], [], []
    converged, conv_sweep = False, None
    sweeps_done = 0

    ckpt_mgr = None
    if checkpoint_dir is not None:
        from spinglass_tpu.utils.checkpoint import CheckpointManager

        ckpt_mgr = CheckpointManager(checkpoint_dir, every=checkpoint_every,
                                     use_orbax=False)
        if resume:
            template = _ckpt_tree(
                state, {"e": np.zeros(0), "me": np.zeros(0),
                        "t": np.zeros(0), "a": np.zeros(0)}, 0)
            restored = ckpt_mgr.restore_latest(template)
            if restored is not None:
                state = restored["state"]
                e_hist = list(np.asarray(restored["hist"]["e"]))
                me_hist = list(np.asarray(restored["hist"]["me"]))
                t_hist = list(np.asarray(restored["hist"]["t"]))
                a_hist = list(np.asarray(restored["hist"]["a"]))
                sweeps_done = int(restored["sweeps_done"])

    t0 = time.perf_counter()
    for c in range(len(e_hist), n_chunks):
        n = min(config.record_interval, config.n_sweeps - sweeps_done)
        if n <= 0:
            break
        state, stats = chunk_jit(state, problem, eng_ops, n_sweeps=n)
        sweeps_done += n
        e_hist.append(float(stats["best_energy"]))
        me_hist.append(float(stats["mean_energy"]))
        t_hist.append(float(stats["temperature"]))
        a_hist.append(float(stats["acceptance"]))
        if ckpt_mgr is not None:
            ckpt_mgr.maybe_save(len(e_hist), _ckpt_tree(
                state, {"e": e_hist, "me": me_hist, "t": t_hist,
                        "a": a_hist}, sweeps_done))
        if config.enable_early_stop and len(e_hist) >= 20:
            tail = np.asarray(e_hist[-20:])
            denom = max(abs(float(np.mean(tail))), 1e-10)
            if float(np.std(tail)) / denom < config.convergence_tolerance:
                converged, conv_sweep = True, sweeps_done
                break
    jax.block_until_ready(state.spins)
    total = time.perf_counter() - t0

    # select the best replica ON DEVICE and transfer one [N] row, not the
    # full [R, N] spin population
    best_r = int(jnp.argmin(state.best_energy))
    best_spins = np.asarray(
        engine.from_layout(state.best_spins)[best_r])[: problem.n_spins]
    flips = sweeps_done * config.n_replicas * problem.n_spins
    result = AnnealResult(
        best_spins=best_spins,
        best_energy=float(jnp.min(state.best_energy)),
        replica_best_energy=np.asarray(state.best_energy),
        energy_history=np.asarray(e_hist),
        mean_energy_history=np.asarray(me_hist),
        temperature_history=np.asarray(t_hist),
        acceptance_history=np.asarray(a_hist),
        n_sweeps=sweeps_done,
        n_replicas=config.n_replicas,
        total_time=total,
        sweeps_per_second=sweeps_done / total if total > 0 else 0.0,
        spin_flips_per_second=flips / total if total > 0 else 0.0,
        algorithm=f"sa/{engine.name}/{config.update_rule}",
        device=jax.default_backend(),
        seed=config.seed,
        converged=converged,
        convergence_sweep=conv_sweep,
        metadata={"schedule": config.schedule.schedule_type.value},
    )
    try:  # prometheus gauges (no-op cost when nothing scrapes them)
        from spinglass_tpu.utils.metrics_exporter import publish_anneal_result

        publish_anneal_result(result, solver="sa")
    except Exception:  # pragma: no cover - metrics must never break a solve
        pass
    return result


def anneal_scan(problem: IsingProblem, config: Optional[SAConfig] = None,
                key: Optional[jax.Array] = None) -> Tuple[SAState, dict]:
    """Fully-jitted single-scan anneal (no early stop, no host sync) — the
    benchmark / RL-inner-loop entry point. Returned state is in the engine's
    layout; hist entries are stacked per record chunk."""
    config = config or SAConfig()
    n_rec = max(1, config.n_sweeps // config.record_interval)

    def _build():
        engine = make_sweep_engine(problem, config)

        @jax.jit
        def run(state):
            def rec_body(st, _):
                st, stats = run_chunk(problem, config, engine, st,
                                      config.record_interval)
                return st, stats

            state, hist = lax.scan(rec_body, state, None, length=n_rec)
            return state, hist

        return engine, run, jit_init(config, engine)

    from spinglass_tpu.anneal.jit_cache import sa_cache

    engine, run, init_jit = sa_cache().get_or_build(problem, ("scan", config),
                                                    _build)
    return run(init_jit(problem, engine.operands(), key, None))
