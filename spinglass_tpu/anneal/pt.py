"""Parallel tempering: lockstep replica-exchange Monte Carlo under jit.

Replaces the reference's thread-based ParallelTempering
(annealing/parallel_tempering.py:39-436) and its CUDA exchange kernel
(cuda_kernels.py:80-124). Design decisions:

* Replicas are a batched leading axis swept in lockstep (one jitted sweep for
  all R replicas) instead of a ThreadPoolExecutor per replica
  (parallel_tempering.py:191-203, GIL-bound).
* Exchanges swap **temperatures, not states**: each replica r carries a ladder
  slot; an accepted exchange permutes slots. Mathematically identical to the
  reference's O(N) spin-row swap (parallel_tempering.py:252-258) but moves only
  an int per replica — essential when replicas are sharded across devices
  (the sharded version only exchanges the [R] slot/energy vectors, see
  spinglass_tpu/distributed/pt_sharded.py).
* Even/odd alternating nearest-neighbor pairing with the standard acceptance
  p = min(1, exp((beta_i - beta_j) (E_i - E_j))) (parallel_tempering.py:234-258).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field as dfield
from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from spinglass_tpu.anneal.engines import SweepEngine, make_engine
from spinglass_tpu.anneal.result import AnnealResult
from spinglass_tpu.core import energy as energy_ops
from spinglass_tpu.core import pytree
from spinglass_tpu.core.problem import IsingProblem, random_spins


@dataclass(frozen=True)
class PTConfig:
    """Static PT parameters (reference ParallelTemperingConfig,
    parallel_tempering.py:16-36)."""

    n_replicas: int = 8
    n_chains: int = 1          # independent PT chains swept together in
    # one replica axis: extra chains multiply the independent samples for
    # time-to-target at the cost of a wider sweep
    n_sweeps: int = 1000
    min_temp: float = 0.1
    max_temp: float = 10.0
    ladder: str = "geometric"          # geometric | linear | exponential
    exchange_interval: int = 10
    exchange_method: str = "nearest_neighbor"  # | "all_pairs" (a random
    # perfect matching over ALL pair distances, adjacent included, each pass
    # — the vectorized equivalent of the reference's all-pairs sweep,
    # parallel_tempering.py:222-232)
    cluster_moves: int = 0             # Swendsen-Wang sweeps mixed in per
    # super-step (reference spin_dynamics.py:193-323 cluster capability;
    # helps decorrelation near criticality)
    update_rule: str = "metropolis"
    sweep_method: str = "auto"
    block_size: int = 128
    use_pallas: str = "auto"
    record_interval: int = 50
    seed: int = 42


@pytree.dataclass
class PTState:
    spins: jax.Array        # [R, Np]
    slot: jax.Array         # [R] i32 — ladder slot held by each replica
    energy: jax.Array       # [R] f32
    best_energy: jax.Array  # [R]
    best_spins: jax.Array   # [R, Np]
    key: jax.Array
    sweep: jax.Array        # i32
    exch_attempts: jax.Array  # [R-1] per-ladder-pair attempt counts
    exch_accepts: jax.Array   # [R-1]
    acc_rate: jax.Array     # [R]


def temperature_ladder(cfg: PTConfig) -> np.ndarray:
    """Sorted hot→cold temperature ladder (reference
    parallel_tempering.py:146-173). Slot 0 is the COLDEST."""
    r = cfg.n_replicas
    if cfg.ladder == "geometric":
        temps = np.geomspace(cfg.min_temp, cfg.max_temp, r)
    elif cfg.ladder == "linear":
        temps = np.linspace(cfg.min_temp, cfg.max_temp, r)
    elif cfg.ladder == "exponential":
        temps = cfg.min_temp * np.expm1(
            np.linspace(0, np.log(cfg.max_temp / cfg.min_temp + 1), r))
        temps = np.clip(temps + cfg.min_temp, cfg.min_temp, cfg.max_temp)
        temps[0], temps[-1] = cfg.min_temp, cfg.max_temp
    else:
        raise ValueError(cfg.ladder)
    return temps.astype(np.float32)


def _energy_in_layout(problem, engine, spins):
    if engine is not None:
        return engine.energy(spins)
    return energy_ops.energy(problem, spins)


def init_state(problem: IsingProblem, cfg: PTConfig,
               key: Optional[jax.Array] = None,
               engine: Optional[SweepEngine] = None) -> PTState:
    """State with spins stored in the engine's layout (rn when engine=None)."""
    if key is None:
        key = jax.random.key(cfg.seed)
    key, sub = jax.random.split(key)
    r_total = cfg.n_replicas * cfg.n_chains
    spins = random_spins(sub, (r_total, problem.n_padded),
                         problem.active_mask)
    if engine is not None:
        spins = engine.to_layout(spins)
    e = _energy_in_layout(problem, engine, spins)
    return PTState(
        spins=spins,
        slot=jnp.tile(jnp.arange(cfg.n_replicas, dtype=jnp.int32),
                      cfg.n_chains),
        energy=e,
        best_energy=e,
        best_spins=spins,
        key=key,
        sweep=jnp.asarray(0, jnp.int32),
        exch_attempts=jnp.zeros((cfg.n_replicas - 1,), jnp.int32),
        exch_accepts=jnp.zeros((cfg.n_replicas - 1,), jnp.int32),
        acc_rate=jnp.zeros((r_total,), jnp.float32),
    )


def exchange_step(state: PTState, betas_ladder: jax.Array, parity: jax.Array,
                  key: jax.Array, n_chains: int = 1) -> PTState:
    """One even/odd nearest-neighbor exchange pass, fully vectorized.

    Works on ladder-sorted views: inv[k] = replica currently holding slot k.
    Acceptance p = min(1, exp((beta_k - beta_{k+1})(E_k - E_{k+1}))).

    With ``n_chains`` > 1 the replica axis holds C independent PT chains
    (replicas [c*R:(c+1)*R] form chain c, all sharing one ladder); exchanges
    happen within each chain with independent uniforms, and the per-pair
    exchange counters aggregate over chains."""
    nr = betas_ladder.shape[0]
    c = n_chains
    slot_c = state.slot.reshape(c, nr)              # [C, R]
    e_c = state.energy.reshape(c, nr)
    inv = jnp.argsort(slot_c, axis=1)               # [C, R] replica at slot k
    e_sorted = jnp.take_along_axis(e_c, inv, axis=1)
    k_idx = jnp.arange(nr - 1)
    delta_beta = (betas_ladder[:-1] - betas_ladder[1:])[None, :]
    delta_e = e_sorted[:, :-1] - e_sorted[:, 1:]
    log_p = delta_beta * delta_e                    # [C, R-1]
    u = jax.random.uniform(key, (c, nr - 1))
    eligible = ((k_idx % 2) == parity)[None, :]
    accept = eligible & (jnp.log(jnp.maximum(u, 1e-38)) < log_p)

    # Build slot permutation: slot k moves to k+1 if pair (k,k+1) accepted, etc.
    zpad = jnp.zeros((c, 1), bool)
    accept_pad = jnp.concatenate([accept, zpad], axis=1)       # [C, R]
    accept_prev = jnp.concatenate([zpad, accept], axis=1)      # [C, R]
    pos = jnp.arange(nr)[None, :]
    new_pos = jnp.where(accept_pad, pos + 1,
                        jnp.where(accept_prev, pos - 1, pos))
    slot_c = jnp.zeros_like(slot_c).at[
        jnp.arange(c)[:, None], inv].set(new_pos.astype(jnp.int32))

    return state.replace(
        slot=slot_c.reshape(-1),
        exch_attempts=state.exch_attempts
        + jnp.sum(jnp.broadcast_to(eligible, accept.shape), axis=0,
                  dtype=jnp.int32),
        exch_accepts=state.exch_accepts + jnp.sum(accept, axis=0,
                                                  dtype=jnp.int32),
    )


def exchange_step_all_pairs(state: PTState, betas_ladder: jax.Array,
                            key: jax.Array, n_chains: int = 1) -> PTState:
    """Random-matching exchange pass: every pass draws a random perfect
    matching over the ladder slots (any distance), and all matched pairs
    attempt simultaneously — the vectorized, conflict-free equivalent of the
    reference's sequential all-pairs loop (parallel_tempering.py:222-232,
    which attempts each of the R(R-1)/2 pairs with probability 0.1).

    Statistics are keyed by the lower slot of each attempted pair, matching
    the reference's ``pair_idx = min(i, j)`` convention (:249)."""
    nr = betas_ladder.shape[0]
    c = n_chains
    k_perm, k_u = jax.random.split(key)
    slot_c = state.slot.reshape(c, nr)
    e_c = state.energy.reshape(c, nr)
    inv = jnp.argsort(slot_c, axis=1)                  # [C, R] replica at slot
    e_sorted = jnp.take_along_axis(e_c, inv, axis=1)

    # one random matching shared across chains (independent uniforms below)
    perm = jax.random.permutation(k_perm, nr)
    a_slots = perm[: nr // 2]                          # [P]
    b_slots = perm[nr // 2: 2 * (nr // 2)]
    lo = jnp.minimum(a_slots, b_slots)
    delta_beta = betas_ladder[a_slots] - betas_ladder[b_slots]
    delta_e = (jnp.take_along_axis(e_sorted, a_slots[None, :]
                                   .repeat(c, 0), axis=1)
               - jnp.take_along_axis(e_sorted, b_slots[None, :]
                                     .repeat(c, 0), axis=1))
    log_p = delta_beta[None, :] * delta_e              # [C, P]
    u = jax.random.uniform(k_u, (c, nr // 2))
    accept = jnp.log(jnp.maximum(u, 1e-38)) < log_p

    # apply: replica holding a_slot gets b_slot where accepted (and v.v.)
    rep_a = jnp.take_along_axis(inv, a_slots[None, :].repeat(c, 0), axis=1)
    rep_b = jnp.take_along_axis(inv, b_slots[None, :].repeat(c, 0), axis=1)
    new_a = jnp.where(accept, b_slots[None, :], a_slots[None, :])
    new_b = jnp.where(accept, a_slots[None, :], b_slots[None, :])
    chain_idx = jnp.arange(c)[:, None]
    slot_c = slot_c.at[chain_idx, rep_a].set(new_a.astype(jnp.int32))
    slot_c = slot_c.at[chain_idx, rep_b].set(new_b.astype(jnp.int32))

    # per-lower-slot statistics (clip to the [R-1] counter length)
    lo_idx = jnp.clip(lo, 0, nr - 2)
    att = jnp.zeros((nr - 1,), jnp.int32).at[lo_idx].add(c)
    acc = jnp.zeros((nr - 1,), jnp.int32).at[lo_idx].add(
        jnp.sum(accept, axis=0).astype(jnp.int32))
    return state.replace(
        slot=slot_c.reshape(-1),
        exch_attempts=state.exch_attempts + att,
        exch_accepts=state.exch_accepts + acc,
    )


def make_pt_step(problem: IsingProblem, cfg: PTConfig,
                 ladder_override: Optional[np.ndarray] = None,
                 engine: Optional[SweepEngine] = None
                 ) -> Tuple[Callable, jax.Array, SweepEngine]:
    """Build the jittable PT super-step: `exchange_interval` sweeps + one
    exchange pass. Returns (step_fn, betas_ladder, engine).

    ``engine``: pre-built sweep engine override — the sharded driver
    (distributed/pt_sharded.py) passes a shard_map-wrapped kernel engine so
    the kernel runs per-device on its local replica rows."""
    if engine is None:
        engine = make_engine(problem, sweep_method=cfg.sweep_method,
                             update_rule=cfg.update_rule,
                             block_size=cfg.block_size,
                             use_pallas=cfg.use_pallas,
                             r_hint=cfg.n_replicas * cfg.n_chains)
    temps = (np.asarray(ladder_override, np.float32)
             if ladder_override is not None else temperature_ladder(cfg))
    betas_ladder = jnp.asarray(1.0 / temps)
    sw = None
    if cfg.cluster_moves > 0:
        from spinglass_tpu.core.cluster import SwendsenWang

        sw = SwendsenWang(problem)

    def super_step(state: PTState, _, betas=betas_ladder, eng_ops=None,
                   prob=None):
        # `betas` may be passed at call time (a traced runtime value), so one
        # compiled executable serves every ladder — ladder tuning iterates
        # without re-compiles. `eng_ops`/`prob`: the engine's array pytree
        # and the problem passed as TRACED arguments — closure-embedding
        # them bakes J into the HLO (see engines.SweepEngine docstring).
        # Callers that
        # jit the super-step should pass engine.operands() and the problem
        # pytree through their jit boundary.
        eng = engine.bind(eng_ops) if eng_ops is not None else engine
        prb = prob if prob is not None else problem
        # cluster-move sampler binds through the same ops dict (key
        # "__sw__", attached by operands_for_step below)
        sw_b = (sw.bind(eng_ops["__sw__"])
                if sw is not None and eng_ops is not None
                and "__sw__" in eng_ops else sw)

        def one_sweep(st: PTState, _):
            key, ku = jax.random.split(st.key)
            beta = betas[st.slot]
            spins, de, cnt = eng.sweep(st.spins, beta, ku)
            energy = st.energy + de
            improved = energy < st.best_energy
            imp_b = (improved[None, :] if eng.layout == "nr"
                     else improved[:, None])
            return st.replace(
                spins=spins,
                energy=energy,
                best_energy=jnp.where(improved, energy, st.best_energy),
                best_spins=jnp.where(imp_b, spins, st.best_spins),
                key=key,
                sweep=st.sweep + 1,
                acc_rate=cnt.astype(jnp.float32) / problem.n_spins,
            ), None

        state, _ = lax.scan(one_sweep, state, None, length=cfg.exchange_interval)
        if sw_b is not None:
            # cluster-move mix: Swendsen-Wang sweeps at each replica's
            # current temperature (detailed balance preserved per replica)
            s_rn = eng.from_layout(state.spins)
            de_cl = jnp.zeros((s_rn.shape[0],), jnp.float32)
            for _ in range(cfg.cluster_moves):
                key, kc = jax.random.split(state.key)
                state = state.replace(key=key)
                s_rn, de_i, _ = sw_b.sweep(s_rn, betas[state.slot], kc)
                de_cl = de_cl + de_i
            new_spins = eng.to_layout(s_rn)
            energy = state.energy + de_cl
            improved = energy < state.best_energy
            imp_b = (improved[None, :] if eng.layout == "nr"
                     else improved[:, None])
            state = state.replace(
                spins=new_spins, energy=energy,
                best_energy=jnp.where(improved, energy, state.best_energy),
                best_spins=jnp.where(imp_b, new_spins, state.best_spins))
        key, kx = jax.random.split(state.key)
        state = state.replace(key=key)
        if cfg.exchange_method == "all_pairs":
            state = exchange_step_all_pairs(state, betas, kx,
                                            n_chains=cfg.n_chains)
        else:
            parity = (state.sweep // cfg.exchange_interval) % 2
            state = exchange_step(state, betas, parity, kx,
                                  n_chains=cfg.n_chains)
        # resync exact energies once per super-step (f32 drift hygiene)
        state = state.replace(
            energy=_energy_in_layout(prb, eng, state.spins))
        e_c = state.energy.reshape(cfg.n_chains, cfg.n_replicas)
        inv_c = jnp.argsort(state.slot.reshape(cfg.n_chains,
                                               cfg.n_replicas), axis=1)
        e_by_slot = jnp.take_along_axis(e_c, inv_c, axis=1)  # [C, R]
        stats = {
            "best_energy": jnp.min(state.best_energy),
            "cold_energy": jnp.mean(e_by_slot[:, 0]),
            "mean_acceptance": jnp.mean(state.acc_rate),
            # per-SLOT energies (cold→hot, chain-averaged) each super-step;
            # time-averaged by run() for feedback ladder tuning (single-
            # sample estimates are far too noisy to respace on)
            "slot_energy": jnp.mean(e_by_slot, axis=0),
            # which ladder slot each replica holds — the replica-trajectory
            # record (reference parallel_tempering.py:323-410 plots these)
            "slot_of_replica": state.slot,
        }
        return state, stats

    def operands_for_step():
        """Engine operands plus (when cluster_moves > 0) the SW sampler's
        arrays under "__sw__" — pass this as super_step's eng_ops."""
        ops = engine.operands()
        if sw is not None:
            ops = dict(ops)
            ops["__sw__"] = sw.operands()
        return ops

    super_step.operands_for_step = operands_for_step
    # init_state compiled as one program, taking (key, problem, engine
    # operands): run op by op, the initial energy of a sparse engine
    # compiles one small program per degree bucket
    super_step.init = jax.jit(lambda key, prob, ops: init_state(
        prob, cfg, key, engine.bind(ops)))
    return super_step, betas_ladder, engine


def run(problem: IsingProblem, cfg: Optional[PTConfig] = None,
        key: Optional[jax.Array] = None,
        ladder_override: Optional[np.ndarray] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 10,
        resume: bool = False) -> AnnealResult:
    """Full PT run (reference parallel_tempering.py:82-143).
    ``ladder_override``: explicit temperature ladder (e.g. from
    tune_ladder) instead of the config's geometric/linear spacing.

    Checkpoint/resume (reference
    batch_processor.py:521-531): with ``checkpoint_dir`` the run executes in
    segments of ``checkpoint_every`` super-steps, saving (PTState, history)
    after each segment; ``resume=True`` restores the latest checkpoint and
    continues. All RNG state lives in PTState.key, so a killed-and-resumed
    run reproduces the uninterrupted run exactly under a fixed seed. Without
    ``checkpoint_dir`` the whole run stays ONE device dispatch (fast path)."""
    cfg = cfg or PTConfig()
    n_super = max(1, cfg.n_sweeps // cfg.exchange_interval)
    if checkpoint_dir is not None or resume:
        if checkpoint_dir is None:
            raise ValueError("resume=True requires checkpoint_dir")
        return _run_segmented(problem, cfg, key, ladder_override,
                              checkpoint_dir, checkpoint_every, resume,
                              n_super)

    # engine identity must be part of any signature key (auto dispatch is
    # content-dependent; engines.SIGNATURE_SHARED_ENGINES) — build the
    # step up front in signature mode, reuse it inside _build on a miss
    from spinglass_tpu.anneal.engines import SIGNATURE_SHARED_ENGINES

    pre_built, sig = None, None
    if hasattr(problem, "trace_signature"):
        pre_built = make_pt_step(problem, cfg)
        if pre_built[2].name in SIGNATURE_SHARED_ENGINES:
            sig = (problem.trace_signature(), pre_built[2].name)

    def _build():
        super_step, _, engine = (pre_built if pre_built is not None
                                 else make_pt_step(problem, cfg))

        # ONE jitted dispatch for the whole run: replica init, the full
        # super-step scan, and best-replica selection all happen on device.
        # prob/eng_ops are TRACED arguments so J and the engine's arrays
        # are runtime operands, not HLO constants
        @jax.jit
        def run_all(key, betas, prob, eng_ops):
            eng = engine.bind(eng_ops)
            state = init_state(prob, cfg, key, eng)

            def step(st, x):
                return super_step(st, x, betas=betas, eng_ops=eng_ops,
                                  prob=prob)

            state, hist = lax.scan(step, state, None, length=n_super)
            best_r = jnp.argmin(state.best_energy)
            best_spins = eng.from_layout(state.best_spins)[best_r]
            return {
                "best_spins": best_spins,
                "best_energy": jnp.min(state.best_energy),
                "replica_best": state.best_energy,
                "exch_attempts": state.exch_attempts,
                "exch_accepts": state.exch_accepts,
                "hist": hist,
            }

        run_all.operands = super_step.operands_for_step
        return run_all, engine

    # reuse the compiled executable across run() calls — same problem
    # object + config, or (dense problems) any same-trace-signature problem:
    # run_all's trace is content-independent (prob/eng_ops are arguments),
    # so a cross-object hit only needs operands from a fresh engine. The
    # ladder is a RUNTIME argument, so ladder tuning / overrides also reuse it.
    from spinglass_tpu.anneal.jit_cache import pt_cache

    run_all, engine = pt_cache().get_or_build(problem, cfg, _build,
                                              signature=sig)
    operands = run_all.operands
    if engine.problem is not problem:  # cross-object signature hit
        operands = pre_built[0].operands_for_step
        engine = pre_built[2]
    temps = (np.asarray(ladder_override, np.float32)
             if ladder_override is not None else temperature_ladder(cfg))
    betas_ladder = jnp.asarray(1.0 / temps)
    if key is None:
        key = jax.random.key(cfg.seed)

    t0 = time.perf_counter()
    out = jax.device_get(run_all(key, betas_ladder, problem,
                                 operands()))  # one dispatch, one read
    total = time.perf_counter() - t0
    res = _assemble_result(problem, cfg, out, betas_ladder, n_super, total)
    try:  # prometheus gauges (no-op cost when nothing scrapes them)
        from spinglass_tpu.utils.metrics_exporter import publish_anneal_result

        publish_anneal_result(res, solver="pt")
    except Exception:  # pragma: no cover - metrics must never break a solve
        pass
    return res


def _assemble_result(problem, cfg: PTConfig, out: dict, betas_ladder,
                     n_super: int, total: float) -> AnnealResult:
    hist = out["hist"]
    sweeps_done = n_super * cfg.exchange_interval
    attempts = np.maximum(out["exch_attempts"], 1)
    exchange_rates = out["exch_accepts"] / attempts
    flips = sweeps_done * cfg.n_replicas * cfg.n_chains * problem.n_spins
    return AnnealResult(
        best_spins=out["best_spins"][: problem.n_spins],
        best_energy=float(out["best_energy"]),
        replica_best_energy=out["replica_best"],
        energy_history=hist["best_energy"],
        mean_energy_history=hist["cold_energy"],
        temperature_history=np.broadcast_to(
            1.0 / np.asarray(betas_ladder)[0], (n_super,)).copy(),
        acceptance_history=hist["mean_acceptance"],
        n_sweeps=sweeps_done,
        n_replicas=cfg.n_replicas,
        total_time=total,
        sweeps_per_second=sweeps_done / total if total > 0 else 0.0,
        spin_flips_per_second=flips / total if total > 0 else 0.0,
        algorithm=f"pt/{cfg.update_rule}",
        device=jax.default_backend(),
        seed=cfg.seed,
        metadata={
            "ladder": np.asarray(1.0 / betas_ladder).tolist(),
            "exchange_rates": exchange_rates.tolist(),
            "exchange_interval": cfg.exchange_interval,
            # per-SLOT energies (cold→hot) time-averaged over the second half
            # of the run (equilibrated) — the tune_ladder input
            "slot_energy": hist["slot_energy"][n_super // 2:].mean(
                axis=0).tolist(),
            # per-super-step replica→slot record [n_super, R_total]
            # (reference parallel_tempering.py:323-410 trajectories)
            "slot_trajectory": np.asarray(hist["slot_of_replica"]),
            # full per-super-step slot-energy record [n_super, R] —
            # tune_ladder's equilibration check reads this
            "slot_energy_history": np.asarray(hist["slot_energy"]),
            "exchange_method": cfg.exchange_method,
        },
    )


def _run_segmented(problem, cfg: PTConfig, key, ladder_override,
                   checkpoint_dir: str, checkpoint_every: int, resume: bool,
                   n_super: int) -> AnnealResult:
    """Checkpointed PT: jitted segments of ``checkpoint_every`` super-steps
    with a (PTState, stacked history) save after each. RNG is carried in
    PTState.key, so segmentation does not change the sweep/exchange stream —
    bitwise-identical to the single-dispatch path under a fixed seed."""
    from spinglass_tpu.utils.checkpoint import CheckpointManager

    from spinglass_tpu.anneal.engines import SIGNATURE_SHARED_ENGINES

    pre_built, sig = None, None
    if hasattr(problem, "trace_signature"):
        pre_built = make_pt_step(problem, cfg)
        if pre_built[2].name in SIGNATURE_SHARED_ENGINES:
            sig = (problem.trace_signature(), pre_built[2].name)

    def _build():
        super_step, _, engine = (pre_built if pre_built is not None
                                 else make_pt_step(problem, cfg))

        @partial(jax.jit, static_argnames=("n_steps",))
        def segment(state, betas, prob, eng_ops, n_steps):
            def step(st, x):
                return super_step(st, x, betas=betas, eng_ops=eng_ops,
                                  prob=prob)

            return lax.scan(step, state, None, length=n_steps)

        segment.operands = super_step.operands_for_step
        return (engine, super_step.init, segment)

    from spinglass_tpu.anneal.jit_cache import pt_cache

    engine, init_jit, segment = pt_cache().get_or_build(
        problem, ("seg", cfg), _build, signature=sig)
    operands = segment.operands
    if engine.problem is not problem:  # cross-object signature hit
        operands = pre_built[0].operands_for_step
        engine = pre_built[2]
    temps = (np.asarray(ladder_override, np.float32)
             if ladder_override is not None else temperature_ladder(cfg))
    betas_ladder = jnp.asarray(1.0 / temps)
    if key is None:
        key = jax.random.key(cfg.seed)

    eng_ops = operands()
    state = init_jit(key, problem, eng_ops)
    hists: list = []
    done_super = 0
    mgr = CheckpointManager(checkpoint_dir, every=1, use_orbax=False)
    # Engine/layout sidecar: auto-dispatch can change the state carrier
    # (e.g. a wider replica hint switches spins to the int8 [NS, R]
    # sorted-transposed layout), making older checkpoints unloadable. Record
    # which engine wrote the checkpoint and fail with pinning advice on
    # mismatch rather than a cryptic shape error.
    meta_path = os.path.join(checkpoint_dir, "engine_meta.json")
    # resume keeps an existing (matching) sidecar; a LEGACY dir without
    # one still gets the sidecar written on the first save of this run
    wrote_meta = resume and os.path.exists(
        os.path.join(checkpoint_dir, "engine_meta.json"))
    if os.path.exists(meta_path):
        import json as _json

        with open(meta_path) as f:
            meta = _json.load(f)
        saved_engine = meta.get("engine")
        # spin dtype matters too: the same engine NAME with another spin
        # carrier dtype writes incompatible checkpoint arrays
        cur_dtype = str(getattr(engine, "spin_dtype", ""))
        saved_dtype = meta.get("spin_dtype", cur_dtype)
        if resume and (saved_engine != engine.name
                       or saved_dtype != cur_dtype):
            from spinglass_tpu.utils.checkpoint import CheckpointError

            raise CheckpointError(
                f"checkpoint in {checkpoint_dir} was written by engine "
                f"'{saved_engine}' (spin dtype {saved_dtype!r}) but the "
                f"current dispatch picked '{engine.name}' (spin dtype "
                f"{cur_dtype!r}) — different state layout. Pin "
                f"PTConfig(sweep_method=...) to the original "
                f"configuration to resume, or point checkpoint_dir at a "
                f"fresh directory.")
    if resume:
        template = {"state": state, "done_super": np.int64(0)}
        restored = mgr.restore_latest(template)
        if restored is not None:
            state = restored["state"]
            done_super = int(restored["done_super"])
            # reload the already-recorded history segments, truncated to the
            # restored checkpoint's step count — the on-disk history can be
            # AHEAD of the restored state (crash between the history write
            # and the state save, or checkpoint GC), and appending re-run
            # segments after stale rows would break the bitwise-identical-
            # to-uninterrupted guarantee
            hp = os.path.join(checkpoint_dir, "history.npz")
            if os.path.exists(hp):
                with np.load(hp) as z:
                    hists = [{k: z[k][:done_super] for k in z.files}]

    t0 = time.perf_counter()
    while done_super < n_super:
        n_steps = min(checkpoint_every, n_super - done_super)
        state, hist = segment(state, betas_ladder, problem, eng_ops,
                              n_steps=n_steps)
        hists.append(jax.device_get(hist))
        done_super += n_steps
        merged = {k: np.concatenate([h[k] for h in hists])
                  for k in hists[0]}
        hists = [merged]
        np.savez_compressed(os.path.join(checkpoint_dir, "history.npz"),
                            **merged)
        mgr.maybe_save(done_super, {"state": jax.device_get(state),
                                    "done_super": np.int64(done_super)})
        if not wrote_meta:
            # (re)write on the first save of THIS run unless resuming: a
            # fresh run reusing the directory overwrites the checkpoints,
            # so a kept-if-exists sidecar would go stale and misdescribe
            # them (found in r4 review)
            import json as _json

            with open(meta_path, "w") as f:
                _json.dump({"engine": engine.name,
                            "sweep_method": cfg.sweep_method,
                            "update_rule": cfg.update_rule,
                            "spin_dtype": str(getattr(engine, "spin_dtype",
                                                      ""))}, f)
            wrote_meta = True
    total = time.perf_counter() - t0

    hist = hists[0]
    best_r = int(jnp.argmin(state.best_energy))
    # device-side row select: one [N] row to the host, not [R, N]
    best_spins = np.asarray(engine.from_layout(state.best_spins)[best_r])
    out = {
        "best_spins": best_spins,
        "best_energy": float(jnp.min(state.best_energy)),
        "replica_best": np.asarray(state.best_energy),
        "exch_attempts": np.asarray(state.exch_attempts),
        "exch_accepts": np.asarray(state.exch_accepts),
        "hist": hist,
    }
    return _assemble_result(problem, cfg, out, betas_ladder, n_super, total)


def tune_ladder(problem: IsingProblem, cfg: PTConfig,
                n_pilot_sweeps: int = 200, n_iters: int = 2,
                key: Optional[jax.Array] = None) -> Tuple[np.ndarray, dict]:
    """Feedback-optimized temperature ladder (PAPERS.md: 'Speeding up
    parallel tempering simulations' arXiv:1006.4247; 'Acceleration of
    Parallel Tempering' arXiv:2512.03825).

    A geometric ladder gives very uneven exchange rates on frustrated
    instances (cold pairs exchange rarely, hot pairs always). This runs
    short pilot PT runs, measures the mean energy per ladder slot, and
    re-spaces the inverse temperatures so the predicted pairwise acceptance
    log p ≈ -Δβ_k · |E(β_{k+1}) - E(β_k)| is EQUAL across pairs — the
    constant-entropy-increment criterion. Each iteration re-measures on the
    improved ladder.

    Returns (temperatures hot→cold sorted ascending like temperature_ladder,
    diagnostics dict). Use via ``PTConfig`` → ``run(problem, cfg,
    ladder_override=...)`` or by replacing the config's ladder bounds.
    """
    import dataclasses as _dc

    cfg_pilot = _dc.replace(cfg, n_sweeps=n_pilot_sweeps)
    temps = temperature_ladder(cfg)                      # ascending (cold→hot)
    diag = {"iterations": []}
    if key is None:
        key = jax.random.key(cfg.seed + 1)
    for it in range(n_iters):
        betas = 1.0 / temps
        # equilibration-gated pilot: respacing on
        # unequilibrated slot energies chases transients exactly where
        # ladder tuning matters most (frustrated instances). Extend the
        # pilot (2x, up to 3 tries) until the coldest slot's energy series
        # passes the two-window test, then average only the second half.
        from spinglass_tpu.core import dynamics_analysis as dyn

        pilot = cfg_pilot
        for attempt in range(3):
            used_sweeps = pilot.n_sweeps
            res = run(problem, pilot, key=key, ladder_override=temps)
            e_hist = np.asarray(res.metadata["slot_energy_history"])
            cold_tail = e_hist[e_hist.shape[0] // 2:, 0]
            if len(cold_tail) >= 8 and dyn.is_equilibrated(cold_tail):
                break
            pilot = _dc.replace(pilot, n_sweeps=pilot.n_sweeps * 2)
        diag.setdefault("pilot_sweeps", []).append(used_sweeps)
        key, _ = jax.random.split(key)
        e_slot = np.asarray(res.metadata["slot_energy"])  # [R] cold→hot
        rates = np.asarray(res.metadata["exchange_rates"])
        # energy is monotone in T; enforce for stability
        e_slot = np.maximum.accumulate(e_slot)
        # first-order constant-acceptance spacing: for adjacent pair with
        # gap Δβ, log p ≈ -Δβ·|ΔE| ≈ -(Δβ)²·|E'(β)| — equal acceptance ⟺
        # equal increments of M(β) = ∫ sqrt(|E'(β)|) dβ. Interpolate E(β)
        # on a fine grid, integrate the measure, place new betas at equal M.
        b_nodes = betas[::-1]                # ascending (hot → cold β)
        e_nodes = e_slot[::-1]               # descending in β
        b_fine = np.linspace(b_nodes[0], b_nodes[-1], 1024)
        e_fine = np.interp(b_fine, b_nodes, e_nodes)
        e_prime = np.abs(np.gradient(e_fine, b_fine)) + 1e-12
        mu = np.sqrt(e_prime)
        m_cum = np.concatenate(
            [[0.0], np.cumsum(0.5 * (mu[1:] + mu[:-1]) * np.diff(b_fine))])
        m_targets = np.linspace(0.0, m_cum[-1], len(temps))
        new_betas = np.interp(m_targets, m_cum, b_fine)
        new_betas[0], new_betas[-1] = b_nodes[0], b_nodes[-1]
        temps = np.sort(1.0 / new_betas).astype(np.float32)
        diag["iterations"].append({
            "exchange_rates": rates.tolist(),
            "rate_spread": float(rates.max() - rates.min()) if rates.size
            else 0.0,
            "temps": temps.tolist(),
        })
    return temps, diag


def exchange_rate_summary(result: AnnealResult) -> dict:
    """Exchange statistics (reference parallel_tempering.py:315-321, 412-428)."""
    rates = np.asarray(result.metadata.get("exchange_rates", []))
    return {
        "mean_exchange_rate": float(rates.mean()) if rates.size else 0.0,
        "min_exchange_rate": float(rates.min()) if rates.size else 0.0,
        "per_pair": rates.tolist(),
    }
