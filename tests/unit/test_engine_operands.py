"""Jit-boundary contract guard (anneal.engines.SweepEngine docstring).

Every engine must expose operands()/bind() covering ALL device arrays its
traced paths read: a missed attribute silently reverts to an HLO closure
constant: J rides along with every compile and serializes into every
executable. The guard is
structural: lower a bound program and sum the bytes of large dense<...>
literals in the StableHLO text — an embedded 512-spin J alone contributes
~2 MB (measured); clean programs carry ~0 (program CODE can legitimately
be megabytes in Pallas interpret mode, so raw text length is not used).
This caught two real holes when first written: a kernel engine missing
problem.active_mask, and SwendsenWang.bind copying a _sweep_jit bound to
the original (unbound) instance.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spinglass_tpu.anneal.engines import BlockedEngine, make_engine
from spinglass_tpu.core import topology
from spinglass_tpu.core.problem import IsingProblem, random_spins
from spinglass_tpu.kernels.sparse import EllProblem

N = 512
MAX_CONST_BYTES = 64_000   # total text bytes of dense<> literals > 1 KB


def _large_const_bytes(txt: str) -> int:
    tot = 0
    for m in re.finditer(r"dense<", txt):
        end = txt.find(">", m.end())
        if end - m.end() > 1024:
            tot += end - m.end()
    return tot


def _dense_problem(n=N):
    j = topology.fully_connected(n, dist="gaussian", scale=0.05, seed=0)
    return IsingProblem.from_dense(j)


def _ell_problem():
    coo = topology.sparse_random_graph_coo(N, avg_degree=6.0,
                                           dist="gaussian", seed=0)
    return EllProblem.from_coo(N, *coo)


def _colored():
    j = topology.grid_2d(16, 32, dist="binary", seed=1)
    p = IsingProblem.from_dense(j)
    return p, make_engine(p, sweep_method="colored")


ENGINES = {
    "blocked": lambda: (lambda p: (p, make_engine(
        p, sweep_method="blocked")))(_dense_problem()),
    "colored": _colored,
    # the GPU block kernel in Pallas interpret mode; an embedded 192-spin
    # J (~150 KB of dense text) would trip the 64 KB constant threshold
    "pallas_interpret": lambda: (lambda p: (p, BlockedEngine(
        p, kernel=True, interpret=True)))(_dense_problem(192)),
    "sparse_compact": lambda: (lambda e: (e, make_engine(
        e, sweep_method="sparse_compact")))(_ell_problem()),
    "sparse_sorted": lambda: (lambda e: (e, make_engine(
        e, sweep_method="sparse")))(_ell_problem()),
    "sparse_sorted_t": lambda: (lambda e: (e, make_engine(
        e, sweep_method="sparse_t")))(_ell_problem()),
}


@pytest.mark.parametrize(
    "maker", ENGINES.values(), ids=list(ENGINES))
def test_bound_sweep_embeds_no_large_constants(maker):
    problem, engine = maker()
    s0 = engine.to_layout(random_spins(jax.random.key(0),
                                       (4, problem.n_padded),
                                       problem.active_mask))

    def run(s, key, ops):
        eng = engine.bind(ops)
        s2, de, cnt = eng.sweep(s, jnp.float32(1.0), key)
        return s2, de, cnt

    txt = jax.jit(run).lower(s0, jax.random.key(1),
                             engine.operands()).as_text()
    cb = _large_const_bytes(txt)
    assert cb < MAX_CONST_BYTES, (
        f"{cb/1e6:.1f} MB of large dense constants in the lowered "
        f"program — an engine array is being closure-embedded; add it to "
        f"operands()/bind()")


@pytest.mark.parametrize(
    "maker", ENGINES.values(), ids=list(ENGINES))
def test_bound_sweep_matches_unbound(maker):
    """bind(operands()) must be behavior-identical to the original engine
    (same RNG stream, same flips)."""
    problem, engine = maker()
    s0 = engine.to_layout(random_spins(jax.random.key(0),
                                       (4, problem.n_padded),
                                       problem.active_mask))
    key = jax.random.key(7)
    a = engine.sweep(s0, jnp.float32(0.9), key)
    b = engine.bind(engine.operands()).sweep(s0, jnp.float32(0.9), key)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_pt_super_step_program_is_small():
    """The full PT super-step (the flagship jit boundary) stays free of
    embedded arrays when fed operands_for_step() — including the
    Swendsen-Wang cluster-move sampler's ELL tables (r4 review #1)."""
    from spinglass_tpu.anneal import pt as pt_mod

    p = _dense_problem()
    cfg = pt_mod.PTConfig(n_replicas=4, exchange_interval=2,
                          cluster_moves=1, use_pallas="never", seed=0)
    super_step, betas, engine = pt_mod.make_pt_step(p, cfg)
    state = pt_mod.init_state(p, cfg, jax.random.key(0), engine)
    ops = super_step.operands_for_step()
    assert "__sw__" in ops

    def step(st, prob, o):
        return super_step(st, None, eng_ops=o, prob=prob)

    txt = jax.jit(step).lower(state, p, ops).as_text()
    cb = _large_const_bytes(txt)
    assert cb < MAX_CONST_BYTES, (
        f"super-step: {cb/1e6:.1f} MB of large dense constants — an array "
        f"(engine, problem, or SW sampler) is closure-embedded")


def test_ppo_update_program_is_clean():
    """The jitted PPO update for a SPARSE RL problem must not embed the
    ELL/bucket tables — 'RL over 10k+-spin sparse instances' is an
    advertised path and its compile would otherwise carry the instance."""
    from spinglass_tpu.rl import ppo as ppo_mod
    from spinglass_tpu.rl.env import EnvConfig

    coo = topology.sparse_random_graph_coo(1000, avg_degree=5.0,
                                           dist="gaussian", seed=2)
    ell = EllProblem.from_coo(1000, *coo)
    env_cfg = EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=4)
    cfg = ppo_mod.PPOConfig(rollout_len=2, n_epochs=1, n_minibatches=1,
                            hidden_sizes=(16,))
    init_fn, update_fn, model = ppo_mod.make_ppo(ell, env_cfg, cfg)
    state = init_fn()
    txt = jax.jit(update_fn.raw).lower(state,
                                       *update_fn.call_args).as_text()
    cb = _large_const_bytes(txt)
    assert cb < MAX_CONST_BYTES, (
        f"PPO update: {cb/1e6:.1f} MB of large dense constants — the env "
        f"engine or problem is closure-embedded")


def test_dqn_update_program_is_clean():
    """Same guard for the DQN act-and-learn boundary (ADR-0004: enforced
    by canary, not convention)."""
    from spinglass_tpu.rl import dqn as dqn_mod
    from spinglass_tpu.rl.env import EnvConfig

    coo = topology.sparse_random_graph_coo(1000, avg_degree=5.0,
                                           dist="gaussian", seed=3)
    ell = EllProblem.from_coo(1000, *coo)
    env_cfg = EnvConfig(n_envs=4, sweeps_per_step=2, max_steps=4)
    init_fn, aal, model = dqn_mod.make_dqn(
        ell, env_cfg, dqn_mod.DQNConfig(batch_size=8, buffer_size=64))
    state = init_fn()
    txt = jax.jit(aal.raw).lower(state, *aal.call_args).as_text()
    cb = _large_const_bytes(txt)
    assert cb < MAX_CONST_BYTES, (
        f"DQN act_and_learn: {cb/1e6:.1f} MB of large dense constants — "
        f"the env engine or problem is closure-embedded")
