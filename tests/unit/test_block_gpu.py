"""The dense sweep's GPU block kernel (kernels/block_gpu.py), run here in
Pallas interpret mode, and the engine choice around it.

The kernel must make the plain XLA loop's decisions exactly under the same
uniforms (same f32 arithmetic, same order), and both must follow the float64
sequential oracle."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spinglass_tpu.anneal.engines import BlockedEngine, make_engine
from spinglass_tpu.core import energy as E
from spinglass_tpu.core import topology
from spinglass_tpu.core.problem import IsingProblem, random_spins
from spinglass_tpu.kernels import sweeps as K
from spinglass_tpu.kernels.block_gpu import block_inner_pallas

INTERPRET = functools.partial(block_inner_pallas, interpret=True)


def _problem(n, seed):
    j = topology.fully_connected(n, dist="gaussian", scale=0.5, seed=seed)
    h = np.random.default_rng(seed).normal(0, 0.3, n)
    return IsingProblem.from_dense(j, h)


@pytest.mark.parametrize("block_size", [32, 64, 128])
@pytest.mark.parametrize("rule", ["metropolis", "glauber", "heat_bath"])
def test_kernel_matches_xla_and_oracle(block_size, rule):
    """Per-replica beta and padded spins (40 logical of 128)."""
    p = _problem(40, seed=block_size)
    r = 5
    k1, k2 = jax.random.split(jax.random.key(block_size))
    spins = random_spins(k1, (r, p.n_padded), p.active_mask)
    u = jax.random.uniform(k2, (r, p.n_padded))
    beta = jnp.asarray([0.2, 0.5, 0.9, 2.0, 6.0], jnp.float32)
    s_x, de_x, c_x = K.blocked_sweep(p, spins, beta, u,
                                     block_size=block_size, rule=rule)
    s_k, de_k, c_k = K.blocked_sweep(p, spins, beta, u,
                                     block_size=block_size, rule=rule,
                                     inner=INTERPRET)
    np.testing.assert_array_equal(np.asarray(s_k), np.asarray(s_x))
    np.testing.assert_array_equal(np.asarray(c_k), np.asarray(c_x))
    np.testing.assert_allclose(np.asarray(de_k), np.asarray(de_x),
                               rtol=1e-5, atol=1e-5)
    assert np.all(np.asarray(s_k)[:, 40:] == 1.0)      # padding inert
    jn = np.asarray(p.j, np.float64)
    hn = np.asarray(p.h, np.float64)
    for ri in range(r):
        s_or, de_or, c_or = K.sequential_sweep_oracle(
            jn[:40, :40], hn[:40], np.asarray(spins[ri])[:40],
            float(beta[ri]), np.asarray(u[ri])[:40],
            rule=K.canonical_rule(rule))
        np.testing.assert_array_equal(np.asarray(s_k[ri])[:40], s_or)
        assert int(c_k[ri]) == c_or
        np.testing.assert_allclose(float(de_k[ri]), de_or, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("r", [1, 6, 16])
def test_block_call_shapes(r):
    """block_inner_pallas alone, one program per replica, against the XLA
    loop: output shapes and values for odd replica counts."""
    b = 32
    k = jax.random.split(jax.random.key(r), 4)
    s = jnp.where(jax.random.bernoulli(k[0], 0.5, (r, b)), 1.0, -1.0)
    h = jax.random.normal(k[1], (r, b))
    jbb = jax.random.normal(k[2], (b, b)) * 0.2
    jbb = (jbb + jbb.T) * (1.0 - jnp.eye(b))
    th = K.accept_threshold(jax.random.uniform(k[3], (r, b)),
                            jnp.full((r, 1), 0.8), "metropolis")
    want = K._block_inner_xla(s, h, jbb, th)
    got = block_inner_pallas(s, h, jbb, th, interpret=True)
    assert got[0].shape == (r, b) and got[1].shape == got[2].shape == (r,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   rtol=1e-6, atol=1e-6)


def test_kernel_engine_energy_identity():
    p = _problem(100, seed=3)
    eng = BlockedEngine(p, kernel=True, interpret=True)
    assert eng.name == "blocked_gpu"
    s = random_spins(jax.random.key(0), (4, p.n_padded), p.active_mask)
    s1, de, cnt = eng.sweep(s, jnp.float32(0.6), jax.random.key(1))
    np.testing.assert_allclose(np.asarray(E.energy(p, s) + de),
                               np.asarray(E.energy(p, s1)),
                               rtol=1e-4, atol=1e-3)
    assert int(jnp.sum(cnt)) > 0


class TestEngineChoice:
    def test_cpu_auto_is_plain_xla(self):
        """Off a GPU make_engine never picks the kernel, so nothing runs in
        interpret mode unless a caller asks for it."""
        eng = make_engine(_problem(64, 0), sweep_method="blocked")
        assert eng.name == "blocked"
        assert eng.inner is K._block_inner_xla

    def test_always_raises_off_gpu(self):
        with pytest.raises(ValueError, match="needs a GPU"):
            make_engine(_problem(64, 0), sweep_method="blocked",
                        use_pallas="always")

    def test_unknown_use_pallas_raises(self):
        with pytest.raises(ValueError, match="use_pallas"):
            make_engine(_problem(64, 0), use_pallas="interpret")

    def test_gpu_auto_picks_kernel(self, monkeypatch):
        """On a GPU the same call picks the compiled kernel (no interpret
        mode); the backend is faked, nothing is compiled."""
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        eng = make_engine(_problem(64, 0), sweep_method="blocked")
        assert eng.name == "blocked_gpu"
        assert eng.inner is block_inner_pallas
        assert make_engine(_problem(64, 0), sweep_method="blocked",
                           use_pallas="never").name == "blocked"


def test_kernel_lowers_for_cuda():
    """The kernel lowers to Triton for the CUDA platform (the GPU
    compiler's own checks run only on a card)."""
    s = jnp.ones((8, 128))
    jbb = jnp.zeros((128, 128))
    txt = jax.jit(block_inner_pallas).trace(s, s, jbb, s).lower(
        lowering_platforms=("cuda",)).as_text()
    assert "triton" in txt.lower()
