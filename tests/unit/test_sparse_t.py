"""SortedSparseTEngine (transposed aligned sorted sliced-ELL) tests:
layout round trip, energy identity, exact decision parity with the compact
colored sweep, alignment invariants, SA/PT driver integration, and engine
selection via r_hint."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spinglass_tpu.anneal.engines import make_engine
from spinglass_tpu.core import topology
from spinglass_tpu.kernels import sparse as S


@pytest.fixture
def key():
    return jax.random.key(7)


def _ell(n=128, seed=3, with_h=False):
    coo = topology.sparse_random_graph_coo(n, avg_degree=4.0,
                                           dist="gaussian", seed=seed)
    h = (np.random.default_rng(seed).normal(0, 0.3, n) if with_h else None)
    return S.EllProblem.from_coo(n, *coo, h=h)


class TestSortedSparseTEngine:
    def test_layout_roundtrip_and_energy(self, key):
        ell = _ell(with_h=True)
        eng = S.SortedSparseTEngine(ell)
        spins = jnp.where(jax.random.uniform(key, (4, ell.n_padded)) < 0.5,
                          -1.0, 1.0)
        spins = jnp.where(ell.active_mask[None, :] > 0, spins, 1.0)
        s_t = eng.to_layout(spins)
        assert s_t.dtype == jnp.int8
        assert s_t.shape == (eng.n_sorted, 4)
        np.testing.assert_array_equal(np.asarray(eng.from_layout(s_t)),
                                      np.asarray(spins))
        np.testing.assert_allclose(np.asarray(eng.energy(s_t)),
                                   np.asarray(S.sparse_energy(ell, spins)),
                                   rtol=1e-5, atol=1e-3)

    def test_energy_identity_after_sweep(self, key):
        ell = _ell(with_h=True)
        eng = S.SortedSparseTEngine(ell)
        k1, k2 = jax.random.split(key)
        s_t = eng.to_layout(jnp.where(
            jax.random.uniform(k1, (4, ell.n_padded)) < 0.5, -1.0, 1.0))
        e0 = eng.energy(s_t)
        s1, de, cnt = eng.sweep(s_t, jnp.float32(0.8), k2)
        np.testing.assert_allclose(np.asarray(e0 + de),
                                   np.asarray(eng.energy(s1)),
                                   rtol=1e-4, atol=1e-2)
        assert int(jnp.sum(cnt)) > 0

    @pytest.mark.parametrize("rule", ["metropolis", "glauber"])
    def test_decision_parity_with_compact(self, key, rule):
        """Same coloring + same per-spin uniforms -> identical flips,
        counts, and dE as the compact colored sweep (both rules)."""
        ell = _ell()
        eng = S.SortedSparseTEngine(ell, rule=rule)
        ceng = S.SparseEngine(ell, compact=True, rule=rule)
        k1, k2 = jax.random.split(key)
        spins = jnp.where(jax.random.uniform(k1, (4, ell.n_padded)) < 0.5,
                          -1.0, 1.0)
        u_orig = jax.random.uniform(k2, (4, ell.n_padded))
        u_t = u_orig[:, eng._perm_gather].T
        s_t, de_t, cnt_t = eng.sweep_with_uniforms(
            eng.to_layout(spins), jnp.float32(0.7), u_t)
        s_c, de_c, cnt_c = S.sparse_colored_sweep_compact(
            ell, ceng.groups, spins, jnp.float32(0.7), u_orig, rule=rule)
        np.testing.assert_array_equal(np.asarray(cnt_t), np.asarray(cnt_c))
        n = ell.n_spins
        np.testing.assert_array_equal(
            np.asarray(eng.from_layout(s_t))[:, :n],
            np.asarray(s_c)[:, :n])
        np.testing.assert_allclose(np.asarray(de_t), np.asarray(de_c),
                                   rtol=1e-4, atol=1e-3)

    def test_f32_spin_dtype_same_decisions(self, key):
        ell = _ell()
        eng8 = S.SortedSparseTEngine(ell, spin_dtype=jnp.int8)
        eng32 = S.SortedSparseTEngine(ell, spin_dtype=jnp.float32)
        k1, k2 = jax.random.split(key)
        spins = jnp.where(jax.random.uniform(k1, (3, ell.n_padded)) < 0.5,
                          -1.0, 1.0)
        u_t = jax.random.uniform(k2, (3, ell.n_padded))[
            :, eng8._perm_gather].T
        s8, _, c8 = eng8.sweep_with_uniforms(eng8.to_layout(spins), 0.9, u_t)
        s32, _, c32 = eng32.sweep_with_uniforms(eng32.to_layout(spins), 0.9,
                                                u_t)
        assert s32.dtype == jnp.float32
        np.testing.assert_array_equal(np.asarray(c8), np.asarray(c32))
        np.testing.assert_array_equal(np.asarray(s8.astype(jnp.float32)),
                                      np.asarray(s32))

    def test_alignment_invariants(self):
        ell = _ell()
        eng = S.SortedSparseTEngine(ell)
        assert eng.n_sorted % 256 == 0
        covered = []
        for off, mc, bs in eng.groups:
            assert off % 32 == 0 and mc % 32 == 0
            pos = off
            for b in bs:
                assert b.off == pos and b.m % 8 == 0
                pos += b.m
                covered.append((b.off, b.m))
        # every real spin appears exactly once across bucket rows
        real = np.concatenate([eng.perm[o:o + m] for o, m in covered])
        real = real[real >= 0]
        assert len(real) == ell.n_spins
        assert len(np.unique(real)) == ell.n_spins
        # padding rows never accept: mask is -inf exactly off the real rows
        mask = np.asarray(eng.mask_col)[:, 0]
        assert np.all(np.isneginf(mask[np.asarray(eng.perm) < 0]))
        assert np.all(mask[np.asarray(eng.perm) >= 0] == 0.0)

    def test_padding_rows_never_flip(self, key):
        ell = _ell()
        eng = S.SortedSparseTEngine(ell)
        s_t = eng.to_layout(jnp.ones((2, ell.n_padded)))
        pad = np.asarray(eng.perm) < 0
        s1 = s_t
        for i in range(3):
            s1, _, _ = eng.sweep(s1, jnp.float32(0.1),
                                 jax.random.fold_in(key, i))
        np.testing.assert_array_equal(np.asarray(s1)[pad],
                                      np.asarray(s_t)[pad])

    def test_make_engine_selection(self):
        ell = _ell()
        # explicit override always yields the transposed engine
        eng = make_engine(ell, sweep_method="sparse_t")
        assert eng.name == "sparse_sorted_t"
        # below SPARSE_T_MIN_REPLICAS the [R, N] engine stays
        for r in (8, 16, 31):
            assert make_engine(ell, r_hint=r).name == "sparse_sorted"
        # from it up the transposed engine, on every backend
        for r in (32, 128, 1024):
            assert make_engine(ell, r_hint=r).name == "sparse_sorted_t"

    def test_sa_driver_end_to_end(self, key):
        """The SA driver runs with the transposed engine (layout 'nr',
        int8 state) and improves energy."""
        from spinglass_tpu.anneal import sa

        ell = _ell(n=128, seed=5)
        cfg = sa.SAConfig(n_sweeps=200, n_replicas=8,
                          sweep_method="sparse_t", enable_early_stop=False,
                          seed=1)
        engine = sa.make_sweep_engine(ell, cfg)
        assert engine.name == "sparse_sorted_t"
        res = sa.anneal(ell, cfg)
        e_rand = float(np.mean(np.asarray(
            S.sparse_energy(ell, jnp.ones((1, ell.n_padded))))))
        assert res.best_energy < e_rand

    def test_pt_driver_end_to_end(self):
        from spinglass_tpu.anneal import pt as pt_mod

        ell = _ell(n=128, seed=5)
        cfg = pt_mod.PTConfig(n_replicas=4, n_sweeps=80,
                              exchange_interval=10, sweep_method="sparse_t",
                              seed=1)
        res = pt_mod.run(ell, cfg)
        assert np.isfinite(res.best_energy)
        assert res.best_energy <= float(np.mean(res.energy_history[0]))


@pytest.mark.parametrize("engine_cls", [S.SortedSparseTEngine,
                                        S.SortedSparseEngine,
                                        S.SparseEngine])
def test_sparse_fields_lower_without_dots(engine_cls, key):
    """Neighbor fields are a multiply and a reduction, not a dot: a dot per
    degree bucket is a separate GEMM the GPU compiler autotunes, which made
    compiles of the [N, R] engine's programs take minutes."""
    ell = _ell(with_h=True)
    eng = engine_cls(ell)
    s = eng.to_layout(jnp.ones((8, ell.n_padded), jnp.float32))
    sweep = jax.jit(eng.sweep).lower(s, jnp.float32(1.0), key).as_text()
    energy = jax.jit(eng.energy).lower(s).as_text()
    for text in (sweep, energy):
        assert "dot_general" not in text and "stablehlo.dot" not in text


def test_neighbor_sum_is_exact_f32(key):
    """neighbor_sum equals the float64 sum rounded once per partial sum:
    +-1 spins make every product exact."""
    g = jnp.where(jax.random.uniform(key, (5, 7, 3)) < 0.5, -1, 1
                  ).astype(jnp.int8)
    val = jax.random.normal(jax.random.key(1), (5, 7, 1))
    got = np.asarray(S.neighbor_sum(g, val, axis=1))
    want = (np.asarray(g, np.float64) * np.asarray(val, np.float64)).sum(1)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
