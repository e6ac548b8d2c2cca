"""Card-only tier: compiled GPU kernels and the engines that use them.

Run on a machine with a GPU:  python -m pytest tests/gpu -m gpu -q
Elsewhere every test here skips (the ``gpu`` fixture in tests/conftest.py).
The CPU suite covers the same kernel in Pallas interpret mode.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def _dense_problem(n=256, seed=0):
    from spinglass_tpu.core import topology
    from spinglass_tpu.core.problem import IsingProblem

    j = topology.fully_connected(n, dist="gaussian", scale=1.0 / np.sqrt(n),
                                 seed=seed)
    return IsingProblem.from_dense(j)


@pytest.mark.parametrize("rule", ["metropolis", "glauber"])
def test_compiled_block_kernel_matches_xla(gpu, rule):
    """The Triton-compiled block kernel makes the plain XLA loop's
    decisions under the same thresholds (per-replica beta, ragged R)."""
    import jax
    import jax.numpy as jnp

    from spinglass_tpu.kernels import sweeps as K
    from spinglass_tpu.kernels.block_gpu import block_inner_pallas

    r, b = 37, 128
    k = jax.random.split(jax.random.key(0), 4)
    s = jnp.where(jax.random.bernoulli(k[0], 0.5, (r, b)), 1.0, -1.0)
    h = jax.random.normal(k[1], (r, b))
    u = jax.random.uniform(k[2], (r, b))
    jbb = jax.random.normal(k[3], (b, b)) * 0.1
    jbb = (jbb + jbb.T) * (1.0 - jnp.eye(b))
    beta = jnp.linspace(0.2, 3.0, r)
    th = K.accept_threshold(u, beta[:, None], rule)
    want = jax.jit(K._block_inner_xla)(s, h, jbb, th)
    got = block_inner_pallas(s, h, jbb, th)
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want[2]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-4)


def test_make_engine_picks_the_kernel(gpu):
    from spinglass_tpu.anneal.engines import make_engine

    p = _dense_problem()
    assert make_engine(p, sweep_method="blocked").name == "blocked_gpu"
    assert make_engine(p, sweep_method="blocked",
                       use_pallas="never").name == "blocked"


def test_sharded_kernel_pt_step(gpu):
    """The kernel under shard_map on a 1-device mesh: finite energies, the
    slot permutation kept, carried energies equal a recompute."""
    import jax
    import jax.numpy as jnp

    from spinglass_tpu.anneal.pt import PTConfig
    from spinglass_tpu.core.energy import energy as batched_energy
    from spinglass_tpu.distributed import pt_sharded
    from spinglass_tpu.distributed.pt_sharded import ShardedPallasEngine

    problem = _dense_problem()
    mesh = pt_sharded.make_mesh(jax.devices()[:1])
    cfg = PTConfig(n_replicas=8, exchange_interval=2, n_sweeps=4,
                   sweep_method="blocked", min_temp=0.2, max_temp=5.0,
                   seed=0)
    step, init, _, engine, _ = pt_sharded.make_sharded_pt_step(
        problem, cfg, mesh)
    assert isinstance(engine, ShardedPallasEngine), engine
    state = init(jax.random.key(0))
    state, _ = step(state)
    state, _ = step(state)
    assert bool(jnp.all(jnp.isfinite(state.energy)))
    assert (np.sort(np.asarray(state.slot)) == np.arange(8)).all()
    e_direct = batched_energy(problem, engine.from_layout(state.spins),
                              precision=jax.lax.Precision.HIGHEST)
    np.testing.assert_allclose(np.asarray(state.energy),
                               np.asarray(e_direct), rtol=2e-4, atol=2e-2)


def test_sparse_t_engine_energy_identity(gpu):
    """The [N, R] sparse engine on the card: E0 + sum dE == E1."""
    import jax
    import jax.numpy as jnp

    from spinglass_tpu.anneal.engines import make_engine
    from spinglass_tpu.core import topology
    from spinglass_tpu.core.problem import random_spins
    from spinglass_tpu.kernels.sparse import EllProblem

    n, r = 1024, 256
    coo = topology.sparse_random_graph_coo(n, avg_degree=6.0,
                                           dist="gaussian", seed=1)
    ell = EllProblem.from_coo(n, *coo)
    engine = make_engine(ell, r_hint=r)
    assert engine.name == "sparse_sorted_t"
    s = engine.to_layout(random_spins(jax.random.key(0),
                                      (r, ell.n_padded), ell.active_mask))

    @jax.jit
    def run(s, key):
        def body(s, k):
            s, de, _ = engine.sweep(s, jnp.float32(1.0), k)
            return s, de
        return jax.lax.scan(body, s, jax.random.split(key, 5))

    s1, des = run(s, jax.random.key(7))
    energy = jax.jit(engine.energy)
    np.testing.assert_allclose(
        np.asarray(energy(s) + des.sum(0)),
        np.asarray(energy(s1)), rtol=1e-4, atol=5e-2)
