"""Multi-device parallel tempering: replicas sharded over a device mesh.

Replacement for the reference's MultiGPUAnnealer
(annealing/multi_gpu.py:46-551), whose "replica_exchange" strategy was one
thread per GPU with in-memory swaps and whose communication_backend setting
was never used (SURVEY §2.6). Here:

* replicas are a sharded axis over a 1-D ``Mesh(("replica",))``;
* the lockstep sweep partitions automatically (batched matmuls and gathers
  over the replica axis need no communication);
* the exchange step swaps *ladder slots, not spin states* (anneal/pt.py), so
  the only cross-device traffic is the tiny [R] (energy, slot) vectors,
  which XLA moves with collectives it inserts under GSPMD. Spins never move.

Two entry points:
  make_sharded_pt_step(...)  — jitted super-step with explicit NamedShardings
                               (GSPMD partitioning; the idiomatic path).
  run(...)                   — full sharded PT run mirroring pt.run.

Multi-host scale-out uses the same code: call jax.distributed.initialize()
first and build the mesh over all devices.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spinglass_tpu.anneal import pt as pt_mod
from spinglass_tpu.anneal.engines import BlockedEngine, make_engine
from spinglass_tpu.anneal.pt import PTConfig, PTState
from spinglass_tpu.anneal.result import AnnealResult
from spinglass_tpu.core.problem import IsingProblem


def make_mesh(devices=None, axis: str = "replica") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


class ShardedPallasEngine:
    """shard_map wrapper around the dense engine's GPU block kernel.

    GSPMD cannot partition a ``pallas_call``, so under a replica-sharded mesh
    the blocked sweep runs per device on its local [R/D, Np] replica rows.
    The problem (J, fields) is replicated; spins and beta shard on the
    replica axis. Each device folds its mesh position into the RNG key so
    replica shards draw independent uniform streams."""

    layout = "rn"

    def __init__(self, engine: BlockedEngine, mesh: Mesh,
                 axis: str = "replica"):
        from functools import partial

        from jax import shard_map

        self.problem = engine.problem
        self.inner = engine
        self.mesh = mesh
        self.axis = axis
        self.name = f"{engine.name}_shmap{mesh.devices.size}"

        @partial(shard_map, mesh=mesh,
                 in_specs=(P(axis, None), P(axis), P()),
                 out_specs=(P(axis, None), P(axis), P(axis)),
                 check_vma=False)
        def _sweep(spins, beta, key):
            return engine.sweep(spins, beta,
                                jax.random.fold_in(key, lax.axis_index(axis)))

        @partial(shard_map, mesh=mesh,
                 in_specs=(P(axis, None), P(axis), P(axis, None)),
                 out_specs=(P(axis, None), P(axis), P(axis)),
                 check_vma=False)
        def _sweep_u(spins, beta, uniforms):
            return engine.sweep_with_uniforms(spins, beta, uniforms)

        self._sweep_shmap = _sweep
        self._sweep_u_shmap = _sweep_u

    def to_layout(self, spins_rn):
        return spins_rn

    def from_layout(self, spins):
        return spins

    def energy(self, spins):
        return self.inner.energy(spins)

    def sweep(self, spins, beta, key):
        return self._sweep_shmap(spins, beta, key)

    def sweep_with_uniforms(self, spins, beta, uniforms):
        """Host-uniform sweep (sharded-vs-single decision-identity tests)."""
        return self._sweep_u_shmap(spins, beta, uniforms)

    # jit-boundary contract (anneal.engines.SweepEngine docstring): the
    # wrapper's operands are the inner engine's; bind rebuilds the
    # shard_map closures around the bound inner engine (cheap)
    def operands(self):
        return self.inner.operands()

    def bind(self, ops):
        return type(self)(self.inner.bind(ops), self.mesh, self.axis)


def make_sharded_engine(problem: IsingProblem, cfg: PTConfig, mesh: Mesh,
                        axis: str = "replica"):
    """Engine for the sharded PT step: XLA engines partition under GSPMD
    as-is; the dense GPU kernel gets the shard_map wrapper."""
    engine = make_engine(problem, sweep_method=cfg.sweep_method,
                         update_rule=cfg.update_rule,
                         block_size=cfg.block_size,
                         use_pallas=cfg.use_pallas,
                         r_hint=cfg.n_replicas * cfg.n_chains)
    if engine.name == "blocked_gpu":
        return ShardedPallasEngine(engine, mesh, axis)
    return engine


def state_shardings(mesh: Mesh, engine_layout: str = "rn",
                    axis: str = "replica") -> PTState:
    """A PTState-shaped pytree of NamedShardings: replica axis sharded, ladder
    bookkeeping replicated (it is O(R) scalars)."""
    def ns(*spec):
        return NamedSharding(mesh, P(*spec))

    spin_spec = ns(None, axis) if engine_layout == "nr" else ns(axis, None)
    return PTState(
        spins=spin_spec,
        slot=ns(axis),
        energy=ns(axis),
        best_energy=ns(axis),
        best_spins=spin_spec,
        key=ns(),
        sweep=ns(),
        exch_attempts=ns(),
        exch_accepts=ns(),
        acc_rate=ns(axis),
    )


def make_sharded_pt_step(problem: IsingProblem, cfg: PTConfig, mesh: Mesh,
                         axis: str = "replica"):
    """Returns (jitted_step, betas_ladder, engine, shardings). The step runs
    one exchange_interval of sweeps + one exchange, with replicas sharded."""
    if cfg.n_replicas % mesh.devices.size != 0:
        raise ValueError(
            f"n_replicas={cfg.n_replicas} must divide over "
            f"{mesh.devices.size} devices")
    engine = make_sharded_engine(problem, cfg, mesh, axis)
    super_step, betas_ladder, engine = pt_mod.make_pt_step(problem, cfg,
                                                           engine=engine)
    shardings = state_shardings(mesh, engine.layout, axis)
    # problem + engine arrays ride as TRACED args so they are runtime
    # operands, not HLO constants (engines.SweepEngine jit-boundary
    # contract)
    eng_ops = super_step.operands_for_step()

    def _raw(state: PTState, prob, ops) -> Tuple[PTState, dict]:
        return super_step(state, None, eng_ops=ops, prob=prob)

    _step_jit = jax.jit(_raw)

    def step(state: PTState) -> Tuple[PTState, dict]:
        return _step_jit(state, problem, eng_ops)

    # expose the unjitted body + operands so callers (run) can scan over
    # the super-step inside their own jit without re-closing over arrays
    step.raw = _raw
    step.eng_ops = eng_ops

    def init(key: Optional[jax.Array] = None) -> PTState:
        key = key if key is not None else jax.random.key(cfg.seed)
        # jit with out_shardings builds the state directly as global sharded
        # arrays — required under multi-process (a host-local array cannot be
        # device_put onto non-addressable devices), and avoids a host
        # round-trip on single host too
        init_jit = jax.jit(
            lambda k, prob, ops: pt_mod.init_state(prob, cfg, k,
                                                   engine.bind(ops)),
            out_shardings=shardings)
        return init_jit(key, problem, eng_ops)

    return step, init, betas_ladder, engine, shardings


def run(problem: IsingProblem, cfg: Optional[PTConfig] = None,
        mesh: Optional[Mesh] = None,
        key: Optional[jax.Array] = None) -> AnnealResult:
    """Full sharded PT run (the multi-chip analog of anneal.pt.run)."""
    cfg = cfg or PTConfig()
    mesh = mesh or make_mesh()
    step, init, betas_ladder, engine, shardings = make_sharded_pt_step(
        problem, cfg, mesh)
    n_super = max(1, cfg.n_sweeps // cfg.exchange_interval)

    @jax.jit
    def run_all(state, prob, ops):
        return lax.scan(lambda s, _: step.raw(s, prob, ops), state, None,
                        length=n_super)

    state = init(key)
    t0 = time.perf_counter()
    state, hist = run_all(state, problem, step.eng_ops)
    jax.block_until_ready(state.spins)
    total = time.perf_counter() - t0

    spins_rn = engine.from_layout(state.best_spins)
    sweeps_done = n_super * cfg.exchange_interval
    best_r = int(jnp.argmin(state.best_energy))
    flips = sweeps_done * cfg.n_replicas * problem.n_spins
    attempts = np.maximum(np.asarray(state.exch_attempts), 1)
    return AnnealResult(
        best_spins=np.asarray(spins_rn[best_r])[: problem.n_spins],
        best_energy=float(jnp.min(state.best_energy)),
        replica_best_energy=np.asarray(state.best_energy),
        energy_history=np.asarray(hist["best_energy"]),
        mean_energy_history=np.asarray(hist["cold_energy"]),
        temperature_history=np.asarray(
            jnp.broadcast_to(1.0 / betas_ladder[0], (n_super,))),
        acceptance_history=np.asarray(hist["mean_acceptance"]),
        n_sweeps=sweeps_done,
        n_replicas=cfg.n_replicas,
        total_time=total,
        sweeps_per_second=sweeps_done / total if total > 0 else 0.0,
        spin_flips_per_second=flips / total if total > 0 else 0.0,
        algorithm=f"pt_sharded/{engine.name}x{mesh.devices.size}",
        device=jax.default_backend(),
        seed=cfg.seed,
        metadata={
            "n_devices": int(mesh.devices.size),
            "exchange_rates": (np.asarray(state.exch_accepts) / attempts).tolist(),
        },
    )
