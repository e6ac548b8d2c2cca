"""Seeded cross-engine fuzz: random instances with deliberately awkward
shapes (non-lane-multiple sizes, isolated vertices, dangling chains, zero
couplings) must satisfy the exact energy identity E0 + dE == E1 through
every applicable engine, and padding rows must never flip. The per-engine
unit tests pin behavior on friendly shapes; this sweeps the corners."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow   # ~43 s of corner-shape compiles

from spinglass_tpu.anneal.engines import make_engine
from spinglass_tpu.core import topology
from spinglass_tpu.core.problem import IsingProblem, random_spins
from spinglass_tpu.kernels.sparse import EllProblem

CASES = [
    # (kind, n, extra, rule, seed)
    ("dense", 37, "gaussian", "metropolis", 0),
    ("dense", 130, "binary", "glauber", 1),       # just over one lane tile
    ("dense", 255, "gaussian", "metropolis", 2),  # one short of alignment
    ("sparse", 97, 2.0, "metropolis", 3),         # very sparse, odd n
    ("sparse", 300, 9.5, "glauber", 4),           # heavier degree
    ("sparse", 513, 1.2, "metropolis", 5),        # near-tree + isolated-ish
    ("ring", 48, None, "glauber", 6),
    ("grid", 45, None, "metropolis", 7),          # 9x5 grid
]


def _build(kind, n, extra, seed):
    if kind == "dense":
        j = topology.fully_connected(n, dist=extra, scale=0.1, seed=seed)
        # sprinkle exact zeros so some couplings vanish
        rng = np.random.default_rng(seed)
        j = np.asarray(j)
        mask = rng.random(j.shape) < 0.3
        j = np.where(mask | mask.T, 0.0, j)
        np.fill_diagonal(j, 0.0)
        return IsingProblem.from_dense(j)
    if kind == "sparse":
        coo = topology.sparse_random_graph_coo(n, avg_degree=extra,
                                               dist="gaussian", seed=seed)
        return EllProblem.from_coo(n, *coo)
    if kind == "ring":
        return IsingProblem.from_dense(
            topology.chain(n, periodic=True, dist="binary", seed=seed))
    if kind == "grid":
        return IsingProblem.from_dense(
            topology.grid_2d(9, n // 9, dist="gaussian", seed=seed))
    raise ValueError(kind)


def _methods(kind):
    if kind == "sparse":
        return ["sparse", "sparse_t", "sparse_compact"]
    return ["blocked", "colored"]


@pytest.mark.parametrize("kind,n,extra,rule,seed", CASES)
def test_energy_identity_and_padding(kind, n, extra, rule, seed):
    problem = _build(kind, n, extra, seed)
    r = 3
    for method in _methods(kind):
        try:
            eng = make_engine(problem, sweep_method=method,
                              update_rule=rule)
        except ValueError:
            continue                    # method inapplicable to this shape
        key = jax.random.key(seed)
        s_rn = random_spins(key, (r, problem.n_padded), problem.active_mask)
        s = eng.to_layout(s_rn)
        e0 = eng.energy(s)
        s1, de, cnt = eng.sweep(s, jnp.float32(0.8), jax.random.key(seed + 1))
        e1 = eng.energy(s1)
        np.testing.assert_allclose(
            np.asarray(e0 + de), np.asarray(e1), rtol=1e-4, atol=5e-2,
            err_msg=f"{kind} n={n} {method}/{rule}: E0+dE != E1")
        # padding must stay exactly +1 in the [R, N] view
        back = np.asarray(eng.from_layout(s1))
        pad = np.asarray(problem.active_mask) == 0
        if pad.any():
            np.testing.assert_array_equal(
                back[:, pad], 1.0,
                err_msg=f"{kind} n={n} {method}: padding flipped")
        # bind(operands()) parity holds on awkward shapes too
        s1b, deb, cntb = eng.bind(eng.operands()).sweep(
            s, jnp.float32(0.8), jax.random.key(seed + 1))
        np.testing.assert_array_equal(np.asarray(s1), np.asarray(s1b))
