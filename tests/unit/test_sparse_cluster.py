"""Sparse ELL engine + Wolff cluster tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spinglass_tpu.anneal.engines import make_engine
from spinglass_tpu.core import cluster as W
from spinglass_tpu.core import energy as E
from spinglass_tpu.core import topology
from spinglass_tpu.core.problem import IsingProblem, random_spins
from spinglass_tpu.kernels import sparse as S
from spinglass_tpu.kernels import sweeps as K


class TestSparse:
    def _sparse_problem(self, n=200, density=0.02, seed=0):
        j = topology.random_graph(n, density=density, seed=seed)
        h = np.random.default_rng(seed).normal(0, 0.2, n)
        return IsingProblem.from_dense(j, h)

    def test_ell_fields_match_dense(self, key):
        p = self._sparse_problem()
        ell = S.EllProblem.from_problem(p)
        s = random_spins(key, (4, p.n_padded), p.active_mask)
        np.testing.assert_allclose(
            np.asarray(S.sparse_local_fields(ell, s)),
            np.asarray(E.local_fields(p, s)), rtol=1e-4, atol=1e-4)

    def test_ell_energy_matches_dense(self, key):
        p = self._sparse_problem()
        ell = S.EllProblem.from_problem(p)
        s = random_spins(key, (4, p.n_padded), p.active_mask)
        np.testing.assert_allclose(np.asarray(S.sparse_energy(ell, s)),
                                   np.asarray(E.energy(p, s)),
                                   rtol=1e-4, atol=1e-3)

    def test_sparse_sweep_matches_dense_colored(self, key):
        """Sparse colored sweep must make identical flip decisions to the
        dense colored sweep (same uniforms, same coloring)."""
        p = self._sparse_problem(150, 0.03, seed=2)
        n = p.n_spins
        colors = topology.greedy_coloring(np.asarray(p.j)[:n, :n])
        masks = K.color_masks_from_colors(colors, p.n_padded)
        ell = S.EllProblem.from_problem(p)
        k1, k2 = jax.random.split(key)
        spins = random_spins(k1, (4, p.n_padded), p.active_mask)
        u = jax.random.uniform(k2, (4, p.n_padded))
        beta = jnp.float32(0.7)
        s_d, de_d, cnt_d = K.colored_sweep(p, masks, spins, beta, u)
        s_s, de_s, cnt_s = S.sparse_colored_sweep(ell, masks, spins, beta, u)
        np.testing.assert_array_equal(np.asarray(s_d), np.asarray(s_s))
        np.testing.assert_array_equal(np.asarray(cnt_d), np.asarray(cnt_s))
        np.testing.assert_allclose(np.asarray(de_d), np.asarray(de_s),
                                   rtol=1e-3, atol=1e-2)

    def test_engine_autoselects_sparse(self):
        j = topology.random_graph(2100, density=0.004, seed=1)
        p = IsingProblem.from_dense(j)
        eng = make_engine(p)
        assert eng.name == "sparse_sorted"
        # and a dense problem of the same size stays dense
        jd = topology.fully_connected(256, dist="binary", seed=0)
        eng2 = make_engine(IsingProblem.from_dense(jd))
        assert eng2.name != "sparse_colored"

    def test_sparse_anneal_end_to_end(self):
        """2048-spin ring ferromagnet: SA with the sparse engine reaches the
        exact ground state -N."""
        from spinglass_tpu.anneal.sa import SAConfig, anneal
        from spinglass_tpu.anneal.schedules import ScheduleConfig

        n = 2048
        j = topology.chain(n, periodic=True, dist="ferromagnetic", scale=1.0)
        p = IsingProblem.from_dense(j)
        res = anneal(p, SAConfig(
            n_sweeps=300, n_replicas=8, sweep_method="sparse",
            schedule=ScheduleConfig(initial_temp=2.0, final_temp=0.01),
            use_pallas="never", seed=0))
        assert "sparse" in res.algorithm
        # 1D FM coarsening leaves a few domain walls in finite sweeps;
        # demand >=97% of the exact ground state -N
        assert res.best_energy <= -0.97 * n


class TestDenseFreeSparse:
    def test_from_coo_matches_dense_conversion(self, key):
        """EllProblem.from_coo must equal the via-dense conversion."""
        n = 60
        j = topology.random_graph(n, density=0.08, seed=4)
        p = IsingProblem.from_dense(j)
        rows, cols = np.nonzero(j)
        ell_coo = S.EllProblem.from_coo(n, rows, cols, j[rows, cols])
        s = random_spins(key, (3, p.n_padded), p.active_mask)
        np.testing.assert_allclose(
            np.asarray(S.sparse_energy(ell_coo, s)),
            np.asarray(E.energy(p, s)), rtol=1e-4, atol=1e-3)

    def test_anneal_accepts_ell_problem(self):
        """anneal() on an EllProblem directly — no dense matrix anywhere."""
        from spinglass_tpu.anneal.sa import SAConfig, anneal

        n = 3000
        rows, cols, vals = topology.sparse_random_graph_coo(
            n, avg_degree=4, dist="ferromagnetic", seed=2)
        from spinglass_tpu.anneal.schedules import ScheduleConfig

        ell = S.EllProblem.from_coo(n, rows, cols, vals)
        res = anneal(ell, SAConfig(
            n_sweeps=200, n_replicas=4, use_pallas="never",
            schedule=ScheduleConfig(initial_temp=2.0, final_temp=0.02,
                                    alpha=0.97),
            enable_early_stop=False))
        assert "sparse" in res.algorithm
        # FM sparse graph: best energy ~ -n_edges (most edges satisfied)
        n_edges = len(rows) // 2
        assert res.best_energy < -0.8 * n_edges

    def test_sparse_random_graph_coo_shape(self):
        rows, cols, vals = topology.sparse_random_graph_coo(
            1000, avg_degree=6, seed=0)
        assert len(rows) == len(cols) == len(vals)
        assert np.all(rows != cols)
        # symmetric: every (r, c) has its (c, r)
        fwd = set(zip(rows.tolist(), cols.tolist()))
        assert all((c, r) in fwd for r, c in list(fwd)[:100])

    def test_coloring_coo_valid(self):
        rows, cols, _ = topology.sparse_random_graph_coo(500, avg_degree=5,
                                                         seed=1)
        colors = topology.greedy_coloring_coo(rows, cols, 500)
        assert np.all(colors[rows] != colors[cols])

    def test_ell_from_terms_matches_dense(self, key):
        """Constraint Terms → ELL must give the same energies as the dense
        scatter-add path (the encode route for huge scheduling QUBOs)."""
        from spinglass_tpu.core import constraints as C

        n = 60
        comp = C.ConstraintCompiler()
        for t in range(6):
            comp.add(C.CardinalityConstraint(
                indices=np.arange(t * 10, (t + 1) * 10), k=2, weight=3.0))
        rng = np.random.default_rng(0)
        obj = C.binary_quadratic_terms(
            lin_i=np.arange(n), lin_v=rng.normal(size=n))
        terms = C.Terms.concat([obj, comp.compile()])
        dense = IsingProblem.from_terms(n, terms.quad_i, terms.quad_j,
                                        terms.quad_v, terms.lin_i,
                                        terms.lin_v)
        ell = S.ell_from_terms(n, terms)
        s = random_spins(key, (4, dense.n_padded), dense.active_mask)
        np.testing.assert_allclose(np.asarray(S.sparse_energy(ell, s)),
                                   np.asarray(E.energy(dense, s)),
                                   rtol=1e-4, atol=1e-2)

    def test_scheduling_encode_sparse_scale(self):
        """A scheduling QUBO too structured for small coloring still encodes
        to ELL and anneals (50 tasks x 8 agents x 4 slots = 1600 spins)."""
        from spinglass_tpu.anneal.sa import SAConfig, anneal
        from spinglass_tpu.problems import SchedulingProblem

        prob = SchedulingProblem()
        prob.generate_random_instance(n_tasks=50, n_agents=8, horizon=4,
                                      seed=1, precedence_prob=0.0)
        prob.encode_to_ising()
        assert prob.problem.n_spins == 50 * 8 * 4
        res = anneal(prob.problem, SAConfig(n_sweeps=60, n_replicas=4,
                                            use_pallas="never"))
        sol = prob.decode_solution(res.best_spins)
        assert len(sol.variables["assignments"]) == 50


class TestWolff:
    def test_cluster_flip_preserves_spin_validity(self, key):
        j = topology.grid_2d(6, 6, dist="ferromagnetic")
        p = IsingProblem.from_dense(j)
        s = random_spins(key, (4, p.n_padded), p.active_mask)
        s2, size = W.wolff_update(p, s, jnp.float32(0.8), jax.random.key(1))
        assert np.all(np.abs(np.asarray(s2)) == 1.0)
        assert np.all(np.asarray(size) >= 1)

    def test_aligned_ferromagnet_cold_flips_everything(self):
        """At low T on a fully aligned FM, the cluster is the whole system
        (energy invariant under global flip)."""
        n = 16
        j = topology.fully_connected(n, dist="ferromagnetic", scale=1.0)
        p = IsingProblem.from_dense(j)
        s = jnp.ones((2, p.n_padded))
        e0 = E.energy(p, s)
        s2, size = W.wolff_update(p, s, jnp.float32(20.0), jax.random.key(0))
        assert np.all(np.asarray(size) == n)
        np.testing.assert_allclose(np.asarray(E.energy(p, s2)),
                                   np.asarray(e0), rtol=1e-5)
        assert np.all(np.asarray(s2[:, :n]) == -1.0)

    def test_hot_cluster_is_single_spin(self, key):
        j = topology.grid_2d(8, 8, dist="ferromagnetic")
        p = IsingProblem.from_dense(j)
        s = random_spins(key, (8, p.n_padded), p.active_mask)
        _, size = W.wolff_update(p, s, jnp.float32(1e-4), jax.random.key(2))
        assert np.all(np.asarray(size) <= 2)

    def test_wolff_sweep_energy_bookkeeping(self, key):
        j = topology.grid_2d(6, 6, dist="binary", seed=3)
        p = IsingProblem.from_dense(j)
        s = random_spins(key, (3, p.n_padded), p.active_mask)
        e0 = E.energy(p, s)
        s2, de, flipped = W.wolff_sweep(p, s, jnp.float32(0.5),
                                        jax.random.key(4), n_clusters=3)
        np.testing.assert_allclose(np.asarray(e0 + de),
                                   np.asarray(E.energy(p, s2)), atol=1e-3)
        assert np.all(np.asarray(flipped) >= 3)

    @pytest.mark.slow
    def test_wolff_samples_boltzmann(self):
        """Wolff on a small FM chain must reproduce the exact Boltzmann
        distribution (detailed-balance check for cluster moves)."""
        import itertools

        n = 5
        j = topology.chain(n, dist="ferromagnetic", scale=1.0)
        p = IsingProblem.from_dense(j)
        beta = 0.5
        states = np.array(list(itertools.product([-1.0, 1.0], repeat=n)))
        energies = np.array([-0.5 * s @ j @ s for s in states])
        logw = -beta * energies
        probs = np.exp(logw - logw.max()); probs /= probs.sum()

        r = 256
        s = random_spins(jax.random.key(0), (r, p.n_padded), p.active_mask)

        @jax.jit
        def step(s, k):
            s2, _ = W.wolff_update(p, s, jnp.float32(beta), k)
            return s2

        samples = []
        for i in range(400):
            s = step(s, jax.random.key(i + 1))
            if i >= 100:
                samples.append(np.asarray(s[:, :n]))
        samples = np.concatenate(samples)
        codes = ((samples > 0) * 2 ** np.arange(n)).sum(axis=1).astype(int)
        emp = np.bincount(codes, minlength=2 ** n) / len(codes)
        state_codes = ((states > 0) * 2 ** np.arange(n)).sum(axis=1).astype(int)
        tv = 0.5 * np.abs(emp[state_codes] - probs).sum()
        assert tv < 0.05, f"TV={tv}"


class TestCompactSweep:
    def test_compact_matches_masked(self, key):
        """Compacted colored sweep must make identical decisions to the
        mask-based sweep under the same uniforms + coloring."""
        import jax

        j = topology.random_graph(120, density=0.04, seed=5)
        p = IsingProblem.from_dense(j)
        n = p.n_spins
        rows, cols = (a.astype(np.int64)
                      for a in np.nonzero(np.asarray(p.j)[:n, :n]))
        colors = topology.greedy_coloring_coo(rows, cols, n, balanced=True)
        ell = S.EllProblem.from_problem(p)
        groups = S.build_color_groups(ell, colors)
        masks = K.color_masks_from_colors(colors, p.n_padded)
        k1, k2 = jax.random.split(key)
        spins = random_spins(k1, (4, p.n_padded), p.active_mask)
        u = jax.random.uniform(k2, (4, p.n_padded))
        beta = jnp.float32(0.8)
        s_m, de_m, cnt_m = S.sparse_colored_sweep(ell, masks, spins, beta, u)
        s_c, de_c, cnt_c = S.sparse_colored_sweep_compact(
            ell, groups, spins, beta, u)
        np.testing.assert_array_equal(np.asarray(s_m), np.asarray(s_c))
        np.testing.assert_array_equal(np.asarray(cnt_m), np.asarray(cnt_c))
        np.testing.assert_allclose(np.asarray(de_m), np.asarray(de_c),
                                   rtol=1e-4, atol=1e-3)

    def test_balanced_coloring_valid_and_balanced(self):
        rows, cols, vals = topology.sparse_random_graph_coo(
            500, avg_degree=6.0, seed=3)
        colors = topology.greedy_coloring_coo(
            np.asarray(rows), np.asarray(cols), 500, balanced=True)
        # proper coloring: no edge joins same-color endpoints
        assert (colors[np.asarray(rows)] != colors[np.asarray(cols)]).all()
        sizes = np.bincount(colors)
        # balanced: largest class within 2.5x of the mean
        assert sizes.max() <= 2.5 * sizes.mean()

    def test_solver_cache_hits_on_repeat(self):
        from spinglass_tpu.anneal import pt as pt_mod
        from spinglass_tpu.anneal.jit_cache import pt_cache

        rows, cols, vals = topology.sparse_random_graph_coo(
            256, avg_degree=4.0, seed=1)
        ell = S.EllProblem.from_coo(256, rows, cols, vals)
        cfg = pt_mod.PTConfig(n_replicas=4, n_sweeps=40, exchange_interval=10,
                              use_pallas="never", seed=0)
        h0, m0 = pt_cache().hits, pt_cache().misses
        r1 = pt_mod.run(ell, cfg)
        r2 = pt_mod.run(ell, cfg)
        assert pt_cache().misses == m0 + 1 and pt_cache().hits >= h0 + 1
        assert r1.best_energy == r2.best_energy  # same seed, same executable


class TestSwendsenWang:
    def test_fm_ring_zero_temp_single_cluster(self, key):
        """beta -> inf on an aligned FM ring: every satisfied bond activates,
        the whole ring is ONE cluster, so it flips rigidly (|m| stays 1)."""
        from spinglass_tpu.core.cluster import SwendsenWang

        n = 32
        j = topology.chain(n, periodic=True, dist="ferromagnetic")
        p = IsingProblem.from_dense(np.asarray(j))
        sw = SwendsenWang(p)
        spins = jnp.ones((4, p.n_padded)) * p.active_mask[None, :]
        s2, de, n_clusters = sw.sweep(spins, jnp.float32(50.0), key)
        m = np.asarray(jnp.sum(s2 * p.active_mask[None, :], axis=-1)) / n
        np.testing.assert_allclose(np.abs(m), 1.0)
        assert (np.asarray(n_clusters) == 1).all()

    def test_fm_grid_equilibrates_fast(self, key):
        """4x SW sweeps order a 2D FM grid at low T from random init."""
        from spinglass_tpu.core.cluster import SwendsenWang
        from spinglass_tpu.core.problem import random_spins

        j = topology.grid_2d(8, 8, dist="ferromagnetic")
        p = IsingProblem.from_dense(np.asarray(j))
        sw = SwendsenWang(p)
        spins = random_spins(key, (4, p.n_padded), p.active_mask)
        k = key
        for _ in range(6):
            k, sub = jax.random.split(k)
            spins, de, _ = sw.sweep(spins, jnp.float32(2.0), sub)
        from spinglass_tpu.kernels.sparse import EllProblem, sparse_energy

        e = np.asarray(sparse_energy(EllProblem.from_problem(p), spins))
        # ground state energy = -n_edges = -(2*8*8 - 2*8) = -112
        assert e.min() <= -0.9 * 112

    def test_ghost_field_pins_cluster(self, key):
        """Strong +h with beta large: ghost bonds lock the aligned cluster —
        it must NOT flip (label -1 clusters are excluded)."""
        from spinglass_tpu.core.cluster import SwendsenWang

        n = 16
        j = topology.chain(n, periodic=True, dist="ferromagnetic")
        p = IsingProblem.from_dense(np.asarray(j), np.full(n, 5.0))
        sw = SwendsenWang(p)
        spins = jnp.ones((8, p.n_padded)) * p.active_mask[None, :]
        s2, _, _ = sw.sweep(spins, jnp.float32(20.0), key)
        m = np.asarray(jnp.sum(s2 * p.active_mask[None, :], axis=-1)) / n
        np.testing.assert_allclose(m, 1.0)  # all 8 replicas stay pinned

    def test_energy_delta_exact(self, key):
        from spinglass_tpu.core.cluster import SwendsenWang
        from spinglass_tpu.core.problem import random_spins
        from spinglass_tpu.kernels.sparse import EllProblem, sparse_energy

        j = topology.random_graph(40, density=0.1, seed=3)
        p = IsingProblem.from_dense(j, np.random.default_rng(0).normal(
            0, 0.3, 40))
        sw = SwendsenWang(p)
        spins = random_spins(key, (4, p.n_padded), p.active_mask)
        ell = EllProblem.from_problem(p)
        e0 = np.asarray(sparse_energy(ell, spins))
        s2, de, _ = sw.sweep(spins, jnp.float32(0.8), key)
        e1 = np.asarray(sparse_energy(ell, s2))
        np.testing.assert_allclose(e0 + np.asarray(de), e1, rtol=1e-4,
                                   atol=1e-3)

    def test_labels_respect_active_bonds(self, key):
        """Statistical sanity: at beta=0 no bonds activate -> every active
        spin is its own cluster; flips are iid coin flips."""
        from spinglass_tpu.core.cluster import SwendsenWang

        n = 30
        j = topology.random_graph(n, density=0.2, seed=1)
        p = IsingProblem.from_dense(j)
        sw = SwendsenWang(p)
        spins = jnp.ones((16, p.n_padded)) * p.active_mask[None, :]
        s2, _, n_clusters = sw.sweep(spins, jnp.float32(0.0), key)
        assert (np.asarray(n_clusters) == n).all()
        frac_flipped = float(jnp.mean(
            (s2 != spins)[:, :n].astype(jnp.float32)))
        assert 0.3 < frac_flipped < 0.7


class TestSortedSparseEngine:
    """Sorted sliced-ELL engine (kernels/sparse.py SortedSparseEngine):
    layout permutation correctness, energy identity, and exact decision
    parity with the compact colored sweep."""

    def _ell(self, n=300, seed=3):
        from spinglass_tpu.kernels.sparse import EllProblem

        coo = topology.sparse_random_graph_coo(n, avg_degree=6.0,
                                               dist="gaussian", seed=seed)
        return EllProblem.from_coo(n, *coo)

    def test_layout_roundtrip_and_energy(self, key):
        from spinglass_tpu.kernels.sparse import (SortedSparseEngine,
                                                  sparse_energy)

        ell = self._ell()
        eng = SortedSparseEngine(ell)
        spins = jnp.where(jax.random.uniform(key, (3, ell.n_padded)) < 0.5,
                          -1.0, 1.0)
        s_sorted = eng.to_layout(spins)
        assert bool(jnp.all(eng.from_layout(s_sorted) == spins))
        np.testing.assert_allclose(np.asarray(eng.energy(s_sorted)),
                                   np.asarray(sparse_energy(ell, spins)),
                                   rtol=1e-5, atol=1e-3)

    def test_energy_identity_after_sweep(self, key):
        from spinglass_tpu.kernels.sparse import SortedSparseEngine

        ell = self._ell()
        eng = SortedSparseEngine(ell)
        k1, k2 = jax.random.split(key)
        spins = eng.to_layout(jnp.where(
            jax.random.uniform(k1, (4, ell.n_padded)) < 0.5, -1.0, 1.0))
        e0 = eng.energy(spins)
        s1, de, cnt = eng.sweep(spins, jnp.float32(0.8), k2)
        e1 = eng.energy(s1)
        np.testing.assert_allclose(np.asarray(e0 + de), np.asarray(e1),
                                   rtol=1e-4, atol=1e-2)
        assert int(jnp.sum(cnt)) > 0

    def test_decision_parity_with_compact(self, key):
        """Same coloring + same per-spin uniforms -> identical flips."""
        from spinglass_tpu.kernels.sparse import (
            SortedSparseEngine, SparseEngine, sparse_colored_sweep_compact)

        ell = self._ell()
        eng = SortedSparseEngine(ell)
        ceng = SparseEngine(ell, compact=True)
        k1, k2 = jax.random.split(key)
        spins = jnp.where(jax.random.uniform(k1, (4, ell.n_padded)) < 0.5,
                          -1.0, 1.0)
        u_orig = jax.random.uniform(k2, (4, ell.n_padded))
        u_sorted = u_orig[:, jnp.asarray(eng.perm)]
        s_sorted, _, cnt_s = eng.sweep_with_uniforms(
            eng.to_layout(spins), jnp.float32(0.7), u_sorted)
        s_compact, _, cnt_c = sparse_colored_sweep_compact(
            ell, ceng.groups, spins, jnp.float32(0.7), u_orig)
        np.testing.assert_array_equal(np.asarray(cnt_s), np.asarray(cnt_c))
        np.testing.assert_array_equal(
            np.asarray(eng.from_layout(s_sorted)), np.asarray(s_compact))

    def test_buckets_cover_all_spins_once(self):
        from spinglass_tpu.kernels.sparse import SortedSparseEngine

        ell = self._ell()
        eng = SortedSparseEngine(ell)
        covered = np.concatenate(
            [eng.perm[b.off:b.off + b.m] for b in eng.buckets])
        assert len(covered) == ell.n_spins
        assert len(np.unique(covered)) == ell.n_spins

    def test_sliced_k_smaller_than_global(self):
        from spinglass_tpu.kernels.sparse import SortedSparseEngine

        ell = self._ell()
        eng = SortedSparseEngine(ell)
        ks = [b.k for b in eng.buckets]
        assert min(ks) < ell.max_degree  # slicing actually reduced K


class TestSparseWolff:
    """ELL-based Wolff (reference spin_dynamics.py:259-323 sparse Wolff):
    no dense [R, N, N] materialization."""

    def test_matches_dense_wolff_same_key(self, key):
        """Dense and ELL Wolff consume the same RNG stream and compute the
        same bond sums, so the grown clusters are identical."""
        from spinglass_tpu.core.cluster import wolff_update, wolff_update_ell
        from spinglass_tpu.kernels.sparse import EllProblem

        n = 64
        j = topology.random_graph(n, density=0.1, dist="gaussian", seed=2)
        p = IsingProblem.from_dense(j)
        ell = EllProblem.from_problem(p)
        k1, k2 = jax.random.split(key)
        spins = jnp.where(jax.random.uniform(k1, (4, p.n_padded)) < 0.5,
                          -1.0, 1.0) * p.active_mask[None, :]
        s_dense, sz_dense = wolff_update(p, spins, jnp.float32(0.8), k2)
        s_ell, sz_ell = wolff_update_ell(ell, spins, jnp.float32(0.8), k2)
        np.testing.assert_array_equal(np.asarray(sz_dense),
                                      np.asarray(sz_ell))
        np.testing.assert_array_equal(np.asarray(s_dense),
                                      np.asarray(s_ell))

    def test_wolff_at_10k_spins(self, key):
        """Cluster moves work at the 10k+ scale the framework targets."""
        from spinglass_tpu.core.cluster import wolff_sweep_ell
        from spinglass_tpu.kernels.sparse import EllProblem, sparse_energy

        n = 10_000
        coo = topology.sparse_random_graph_coo(n, avg_degree=6.0,
                                               dist="ferromagnetic", seed=4)
        ell = EllProblem.from_coo(n, *coo)
        k1, k2 = jax.random.split(key)
        spins = jnp.where(jax.random.uniform(k1, (2, ell.n_padded)) < 0.5,
                          -1.0, 1.0) * ell.active_mask[None, :]
        e0 = np.asarray(sparse_energy(ell, spins))
        s2, de, flipped = wolff_sweep_ell(ell, spins, jnp.float32(0.6), k2,
                                          n_clusters=3)
        e1 = np.asarray(sparse_energy(ell, s2))
        np.testing.assert_allclose(e0 + np.asarray(de), e1, rtol=1e-4,
                                   atol=1.0)
        assert int(flipped.min()) >= 3          # every update flips >= seed
        assert np.all(np.abs(np.asarray(s2))[:, :n] == 1.0)

    def test_sw_beats_metropolis_at_2d_critical_point(self, key):
        """Cluster updates decorrelate where single-spin sweeps stall
        (critical slowing down): starting all-up
        at the 2D Ising critical temperature, a handful of SW updates
        already tunnels replicas between +m/-m sectors (replica-magnetization
        spread ~0.7) while the same number of Metropolis sweeps leaves every
        replica trapped near m = +0.8 (spread < 0.1). Measured margins at
        L=32: SW std 0.70/min -0.82 vs Met std 0.08/min +0.68 after 10
        updates."""
        from spinglass_tpu.core.cluster import SwendsenWang
        from spinglass_tpu.kernels.sweeps import blocked_sweep

        side = 32
        j = topology.grid_2d(side, side, dist="ferromagnetic", periodic=True)
        p = IsingProblem.from_dense(j)
        t_c = 2.0 / np.log(1.0 + np.sqrt(2.0))
        beta = jnp.float32(1.0 / t_c)
        r = 8
        spins0 = jnp.ones((r, p.n_padded)) * p.active_mask[None, :]
        n = p.n_spins

        sw = SwendsenWang(p)
        s_sw = spins0
        k = key
        for _ in range(10):
            k, sub = jax.random.split(k)
            s_sw, _, _ = sw.sweep(s_sw, beta, sub)

        s_met = spins0
        k = key
        for _ in range(10):
            k, sub = jax.random.split(k)
            u = jax.random.uniform(sub, s_met.shape)
            s_met, _, _ = blocked_sweep(p, s_met, beta, u)

        m_sw = np.asarray(jnp.sum(s_sw[:, :n], axis=1) / n)
        m_met = np.asarray(jnp.sum(s_met[:, :n], axis=1) / n)
        assert m_sw.std() > 0.3, m_sw          # SW mixes across sectors
        assert m_met.std() < 0.2, m_met        # Metropolis is still trapped
        assert m_sw.min() < 0.0
        assert m_met.min() > 0.3


@pytest.mark.slow
class TestLargeScaleBuild:
    def test_200k_spin_engine_builds_and_sweeps(self):
        """Scale path: engine construction must stay vectorized (the
        per-row nonzero loop took ~8 s at 1M rows; the native balanced
        coloring replaced a ~70 s Python loop). 200k spins here keeps the
        slow tier fast while exercising the same code path."""
        import time

        from spinglass_tpu.anneal.engines import make_engine
        from spinglass_tpu.core.problem import random_spins

        n = 200_000
        coo = topology.sparse_random_graph_coo(n, avg_degree=6.0,
                                               dist="gaussian", seed=11)
        ell = S.EllProblem.from_coo(n, *coo)
        t0 = time.time()
        eng = make_engine(ell, r_hint=8)
        assert time.time() - t0 < 30, "engine build regressed to O(n) python"
        s = eng.to_layout(random_spins(jax.random.key(0), (8, ell.n_padded),
                                       ell.active_mask))
        s2, de, cnt = eng.sweep(s, jnp.float32(1.0), jax.random.key(1))
        e0 = eng.energy(s)
        e1 = eng.energy(s2)
        np.testing.assert_allclose(np.asarray(e0 + de), np.asarray(e1),
                                   rtol=1e-4, atol=2.0)
        assert int(jnp.sum(cnt)) > 0
