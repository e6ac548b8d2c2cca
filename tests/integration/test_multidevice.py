"""Multi-device tests on the 8-virtual-CPU-device mesh (replacing the
reference's thread-simulation 'distributed tests', SURVEY §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spinglass_tpu.anneal.pt import PTConfig
from spinglass_tpu.core import topology
from spinglass_tpu.core.problem import IsingProblem
from spinglass_tpu.distributed import pt_sharded

pytestmark = pytest.mark.multidevice


def _problem(n=32, seed=0):
    j = topology.fully_connected(n, dist="binary", seed=seed)
    return IsingProblem.from_dense(j)


@pytest.fixture
def mesh():
    if jax.device_count() < 2:
        pytest.skip("needs >=2 devices")
    return pt_sharded.make_mesh(jax.devices())


@pytest.fixture
def mesh2():
    """2-device mesh for the bitwise decision-identity tests: the property
    (shard_map tiles == single-device sweep) is device-count-independent,
    and GSPMD compile cost over 8 virtual devices dominated the suite
    (same assertions at a fraction of the compile cost)."""
    if jax.device_count() < 2:
        pytest.skip("needs >=2 devices")
    return pt_sharded.make_mesh(jax.devices()[:2])


class TestShardedPT:
    def test_step_preserves_slot_permutation(self, mesh):
        p = _problem()
        n_dev = mesh.devices.size
        cfg = PTConfig(n_replicas=2 * n_dev, exchange_interval=3,
                       use_pallas="never")
        step, init, betas, engine, sh = pt_sharded.make_sharded_pt_step(
            p, cfg, mesh)
        state = init(jax.random.key(0))
        for _ in range(3):
            state, stats = step(state)
        slots = np.sort(np.asarray(state.slot))
        np.testing.assert_array_equal(slots, np.arange(cfg.n_replicas))
        assert np.isfinite(float(stats["best_energy"]))

    def test_sharded_run_finds_ferromagnetic_ground_state(self, mesh):
        n = 16
        j = topology.fully_connected(n, dist="ferromagnetic", scale=1.0)
        p = IsingProblem.from_dense(j)
        n_dev = mesh.devices.size
        cfg = PTConfig(n_replicas=2 * n_dev, n_sweeps=200, min_temp=0.05,
                       max_temp=5.0, exchange_interval=5, use_pallas="never")
        res = pt_sharded.run(p, cfg, mesh)
        assert res.best_energy == pytest.approx(-0.5 * n * (n - 1), rel=1e-5)
        assert res.metadata["n_devices"] == n_dev

    def test_sharded_matches_single_device_energies(self, mesh):
        """Same seed: sharded PT and single-device PT must produce identical
        results (GSPMD partitioning must not change semantics)."""
        from spinglass_tpu.anneal import pt as pt_single

        p = _problem(24, seed=3)
        cfg = PTConfig(n_replicas=8, n_sweeps=60, exchange_interval=5,
                       use_pallas="never", seed=11)
        r1 = pt_single.run(p, cfg)
        r2 = pt_sharded.run(p, cfg, mesh)
        assert r1.best_energy == pytest.approx(r2.best_energy, abs=1e-3)
        np.testing.assert_allclose(np.asarray(r1.replica_best_energy),
                                   np.asarray(r2.replica_best_energy),
                                   atol=1e-2)

    def test_spins_actually_sharded(self, mesh):
        p = _problem()
        cfg = PTConfig(n_replicas=2 * mesh.devices.size, use_pallas="never")
        step, init, betas, engine, sh = pt_sharded.make_sharded_pt_step(
            p, cfg, mesh)
        state = init(jax.random.key(0))
        assert len(state.spins.sharding.device_set) == mesh.devices.size


class TestModelSharded:
    """Spin-sharded (model-parallel) sweeps must match the single-device
    reference exactly — the property the reference's model_parallel mode
    lacked (it dropped cross-block couplings, multi_gpu.py:169-232)."""

    def test_blocked_sharded_exact(self, mesh):
        from spinglass_tpu.core.problem import random_spins
        from spinglass_tpu.distributed import model_sharded as MS
        from spinglass_tpu.kernels import sweeps as K

        mesh = MS.make_mesh(mesh.devices.ravel())
        n = 1024 - 50  # exercise padding
        j = topology.fully_connected(n, dist="gaussian", scale=0.05, seed=0)
        p = IsingProblem.from_dense(j)
        k1, k2 = jax.random.split(jax.random.key(0))
        spins = random_spins(k1, (3, p.n_padded), p.active_mask)
        u = jax.random.uniform(k2, (3, p.n_padded))
        beta = jnp.float32(0.8)
        s_ref, de_ref, cnt_ref = K.blocked_sweep(p, spins, beta, u,
                                                 block_size=128)
        p_sh = MS.shard_problem_rows(p, mesh)
        s_sh, de_sh, cnt_sh = MS.blocked_sweep_sharded(
            p_sh, mesh, spins, beta, u, block_size=128)
        np.testing.assert_array_equal(np.asarray(s_ref), np.asarray(s_sh))
        np.testing.assert_array_equal(np.asarray(cnt_ref), np.asarray(cnt_sh))
        np.testing.assert_allclose(np.asarray(de_ref), np.asarray(de_sh),
                                   atol=1e-2)

    def test_colored_sharded_exact(self, mesh):
        from spinglass_tpu.core.problem import random_spins
        from spinglass_tpu.distributed import model_sharded as MS
        from spinglass_tpu.kernels import sweeps as K

        mesh = MS.make_mesh(mesh.devices.ravel())
        j = topology.grid_2d(32, 32, dist="binary", seed=1)
        p = IsingProblem.from_dense(j)
        colors = topology.greedy_coloring(j)
        masks = K.color_masks_from_colors(colors, p.n_padded)
        k1, k2 = jax.random.split(jax.random.key(5))
        spins = random_spins(k1, (3, p.n_padded), p.active_mask)
        u = jax.random.uniform(k2, (3, p.n_padded))
        beta = jnp.float32(0.8)
        s_ref, _, cnt_ref = K.colored_sweep(p, masks, spins, beta, u)
        s_sh, _, cnt_sh = MS.colored_sweep_sharded(p, mesh, masks, spins,
                                                   beta, u)
        np.testing.assert_array_equal(np.asarray(s_ref), np.asarray(s_sh))
        np.testing.assert_array_equal(np.asarray(cnt_ref), np.asarray(cnt_sh))

    def test_invalid_division_rejected(self, mesh):
        from spinglass_tpu.distributed import model_sharded as MS

        mesh = MS.make_mesh(mesh.devices.ravel())
        p = _problem(32)  # padded 128; 128/8 = 16 rows < block 128
        with pytest.raises(ValueError):
            MS.blocked_sweep_sharded(
                MS.shard_problem_rows(p, mesh), mesh,
                jnp.ones((2, p.n_padded)), jnp.float32(1.0),
                jnp.zeros((2, p.n_padded)), block_size=128)


class TestGraftEntry:
    def test_entry_compiles(self):
        import __graft_entry__ as ge

        fn, args = ge.entry()
        out = jax.jit(fn)(*args)
        jax.block_until_ready(out)
        assert np.all(np.isfinite(np.asarray(out[0])))

    @pytest.mark.slow
    def test_dryrun_multichip(self):
        import __graft_entry__ as ge

        ge.dryrun_multichip(min(8, jax.device_count()))


class TestMultihost:
    """multihost helpers on the 8-virtual-device CPU platform (one process)."""

    def test_initialize_single_host_noop(self):
        from spinglass_tpu.distributed import multihost

        info = multihost.initialize()
        assert info["process_count"] == 1
        assert info["global_devices"] >= 1

    def test_replica_mesh_host_major(self):
        from spinglass_tpu.distributed import multihost

        mesh = multihost.replica_mesh()
        assert mesh.axis_names == ("replica",)
        assert mesh.devices.size == len(jax.devices())

    def test_hybrid_mesh_shape(self):
        from spinglass_tpu.distributed import multihost

        mesh = multihost.hybrid_mesh()
        assert mesh.axis_names == ("host", "replica")
        assert mesh.devices.shape[0] == 1  # one process in tests

    def test_local_replica_slice(self):
        from spinglass_tpu.distributed import multihost

        sl = multihost.local_replica_slice(64)
        assert sl == slice(0, 64)

    def test_scaling_report(self):
        from spinglass_tpu.distributed import multihost

        rep = multihost.scaling_report([1.0e9, 0.9e9])
        assert rep["n_hosts"] == 2
        assert 0.9 < rep["efficiency"] <= 1.0

    def test_sharded_pt_on_replica_mesh(self):
        """pt_sharded over the multihost-constructed mesh end-to-end."""
        from spinglass_tpu.anneal.pt import PTConfig
        from spinglass_tpu.distributed import multihost, pt_sharded
        from spinglass_tpu.core import topology
        from spinglass_tpu.core.problem import IsingProblem

        mesh = multihost.replica_mesh()
        n_dev = mesh.devices.size
        j = topology.fully_connected(24, dist="ferromagnetic", seed=0)
        p = IsingProblem.from_dense(np.asarray(j))
        cfg = PTConfig(n_replicas=2 * n_dev, n_sweeps=40, exchange_interval=10,
                       use_pallas="never", min_temp=0.2, max_temp=4.0, seed=0)
        res = pt_sharded.run(p, cfg, mesh=mesh)
        assert res.best_energy <= -0.9 * (24 * 23 / 2)


class TestShardedSparse:
    """pt_sharded over EllProblem (the sharded path beyond dense)."""

    def test_sharded_pt_over_ellproblem(self, mesh):
        from spinglass_tpu.kernels.sparse import EllProblem

        n = 300
        coo = topology.sparse_random_graph_coo(n, avg_degree=6.0,
                                               dist="gaussian", seed=5)
        ell = EllProblem.from_coo(n, *coo)
        n_dev = mesh.devices.size
        cfg = PTConfig(n_replicas=2 * n_dev, n_sweeps=60,
                       exchange_interval=10, seed=4)
        res = pt_sharded.run(ell, cfg, mesh)
        assert np.isfinite(res.best_energy)
        assert res.best_energy < 0
        assert res.metadata["n_devices"] == n_dev
        # matches the single-device run under the same seed
        from spinglass_tpu.anneal import pt as pt_single

        ref = pt_single.run(ell, cfg)
        np.testing.assert_allclose(res.best_energy, ref.best_energy,
                                   rtol=1e-4)


class TestShardedSparseT:
    """The transposed sparse engine under replica sharding: plain XLA, so
    GSPMD partitions it as it is (spins [NS, R] sharded on the replica
    axis, gathers stay device-local)."""

    def _ell(self, n=128, seed=5):
        from spinglass_tpu.kernels.sparse import EllProblem

        coo = topology.sparse_random_graph_coo(n, avg_degree=4.0,
                                               dist="gaussian", seed=seed)
        return EllProblem.from_coo(n, *coo)

    def test_sharded_t_step_runs(self, mesh):
        ell = self._ell()
        n_dev = mesh.devices.size
        cfg = PTConfig(n_replicas=2 * n_dev, exchange_interval=2,
                       sweep_method="sparse_t", seed=1)
        step, init, betas, engine, sh = pt_sharded.make_sharded_pt_step(
            ell, cfg, mesh)
        assert engine.name == "sparse_sorted_t"
        state = init(jax.random.key(0))
        assert len(state.spins.sharding.device_set) == n_dev
        for _ in range(2):
            state, stats = step(state)
        slots = np.sort(np.asarray(state.slot))
        np.testing.assert_array_equal(slots, np.arange(cfg.n_replicas))
        assert np.isfinite(float(stats["best_energy"]))
        # device tiles must hold different replicas (no repeated streams)
        spins = np.asarray(engine.from_layout(state.spins))
        tiles = spins.reshape(n_dev, 2, -1)
        assert not all(
            np.array_equal(tiles[0], tiles[d]) for d in range(1, n_dev))

    @pytest.mark.slow
    def test_sharded_t_decision_identity(self, mesh2):
        """Same sorted-layout uniforms -> bitwise-identical decisions
        between the replica-sharded and single-device transposed sweep."""
        from jax.sharding import NamedSharding, PartitionSpec as P

        from spinglass_tpu.kernels.sparse import SortedSparseTEngine

        mesh = mesh2
        ell = self._ell(seed=6)
        r = 2 * mesh.devices.size
        eng = SortedSparseTEngine(ell)
        k1, k2 = jax.random.split(jax.random.key(3))
        spins = jnp.where(jax.random.uniform(k1, (r, ell.n_padded)) < 0.5,
                          -1.0, 1.0)
        s_t = eng.to_layout(spins)
        u_t = jax.random.uniform(k2, (eng.n_sorted, r), jnp.float32)
        beta = jnp.full((r,), 0.7, jnp.float32)
        s_ref, de_ref, cnt_ref = eng.sweep_with_uniforms(s_t, beta, u_t)
        cols = NamedSharding(mesh, P(None, "replica"))
        s_sh, de_sh, cnt_sh = jax.jit(eng.sweep_with_uniforms)(
            jax.device_put(s_t, cols),
            jax.device_put(beta, NamedSharding(mesh, P("replica"))),
            jax.device_put(u_t, cols))
        np.testing.assert_array_equal(np.asarray(s_ref), np.asarray(s_sh))
        np.testing.assert_array_equal(np.asarray(cnt_ref),
                                      np.asarray(cnt_sh))
        np.testing.assert_allclose(np.asarray(de_ref), np.asarray(de_sh),
                                   atol=1e-4)

    def test_sharded_t_run_deterministic(self, mesh):
        """Full sharded run works end-to-end, is seed-deterministic and
        matches the single-device run (GSPMD partitions the same
        program, random streams included)."""
        from spinglass_tpu.anneal import pt as pt_single

        ell = self._ell(seed=7)
        n_dev = mesh.devices.size
        cfg = PTConfig(n_replicas=2 * n_dev, n_sweeps=40,
                       exchange_interval=10, sweep_method="sparse_t", seed=4)
        res1 = pt_sharded.run(ell, cfg, mesh)
        res2 = pt_sharded.run(ell, cfg, mesh)
        assert np.isfinite(res1.best_energy)
        assert res1.best_energy < 0
        assert res1.best_energy == res2.best_energy
        np.testing.assert_array_equal(res1.best_spins, res2.best_spins)
        ref = pt_single.run(ell, cfg)
        np.testing.assert_allclose(res1.best_energy, ref.best_energy,
                                   rtol=1e-4)


def _sharded_kernel_engine(p, mesh, block_size=64):
    """The dense GPU kernel (Pallas interpret mode on CPU) in the shard_map
    wrapper that pt_sharded builds for it on a GPU."""
    from spinglass_tpu.anneal.engines import BlockedEngine
    from spinglass_tpu.distributed.pt_sharded import ShardedPallasEngine

    inner = BlockedEngine(p, block_size=block_size, kernel=True,
                          interpret=True)
    return inner, ShardedPallasEngine(inner, mesh)


class TestShardedPallas:
    """The dense block kernel under replica sharding. GSPMD cannot
    partition a pallas_call, so each device runs the blocked sweep on its
    local [R/D, Np] replica rows inside shard_map."""

    def test_sharded_pallas_step_runs(self, mesh):
        from spinglass_tpu.anneal import pt as pt_mod

        p = _problem(64, seed=9)
        n_dev = mesh.devices.size
        cfg = PTConfig(n_replicas=2 * n_dev, exchange_interval=2, seed=1)
        _, engine = _sharded_kernel_engine(p, mesh)
        super_step, _, engine = pt_mod.make_pt_step(p, cfg, engine=engine)
        shardings = pt_sharded.state_shardings(mesh, engine.layout)
        state = jax.jit(lambda k: pt_mod.init_state(p, cfg, k, engine),
                        out_shardings=shardings)(jax.random.key(0))
        step = jax.jit(lambda st: super_step(st, None))
        for _ in range(2):
            state, stats = step(state)
        slots = np.sort(np.asarray(state.slot))
        np.testing.assert_array_equal(slots, np.arange(cfg.n_replicas))
        assert np.isfinite(float(stats["best_energy"]))
        # replica shards must draw DIFFERENT uniform streams (device index
        # folded into the key): identical streams at equal beta would leave
        # device tiles bit-identical
        tiles = np.asarray(state.spins).reshape(n_dev, 2, -1)
        assert not all(
            np.array_equal(tiles[0], tiles[d]) for d in range(1, n_dev))

    def test_sharded_pallas_decision_identity(self, mesh2):
        """Under the same host uniforms the shard_map-wrapped kernel makes
        bitwise-identical flip decisions to the single-device plain sweep."""
        from spinglass_tpu.anneal.engines import BlockedEngine
        from spinglass_tpu.core.problem import random_spins

        mesh = mesh2
        p = _problem(64, seed=10)
        r = 4 * mesh.devices.size
        _, sharded = _sharded_kernel_engine(p, mesh)
        plain = BlockedEngine(p, block_size=64)
        k1, k2 = jax.random.split(jax.random.key(3))
        spins = random_spins(k1, (r, p.n_padded), p.active_mask)
        u = jax.random.uniform(k2, (r, p.n_padded), jnp.float32)
        beta = jnp.linspace(0.3, 2.0, r).astype(jnp.float32)
        s_ref, de_ref, cnt_ref = plain.sweep_with_uniforms(spins, beta, u)
        s_sh, de_sh, cnt_sh = sharded.sweep_with_uniforms(spins, beta, u)
        np.testing.assert_array_equal(np.asarray(s_ref), np.asarray(s_sh))
        np.testing.assert_array_equal(np.asarray(cnt_ref), np.asarray(cnt_sh))
        np.testing.assert_allclose(np.asarray(de_ref), np.asarray(de_sh),
                                   atol=1e-4)

    def test_sharded_pallas_energy_identity(self, mesh):
        """E_before + dE == E_after across a sharded kernel sweep on all 8
        virtual devices."""
        from spinglass_tpu.core import energy as energy_ops
        from spinglass_tpu.core.problem import random_spins

        p = _problem(64, seed=11)
        r = 2 * mesh.devices.size
        _, engine = _sharded_kernel_engine(p, mesh)
        spins = random_spins(jax.random.key(4), (r, p.n_padded),
                             p.active_mask)
        e0 = energy_ops.energy(p, spins)
        s1, de, cnt = engine.sweep(spins, jnp.full((r,), 0.9, jnp.float32),
                                   jax.random.key(5))
        e1 = energy_ops.energy(p, s1)
        np.testing.assert_allclose(np.asarray(e0 + de), np.asarray(e1),
                                   rtol=1e-4, atol=1e-3)
        assert int(np.sum(np.asarray(cnt))) > 0

    def test_make_sharded_engine_keeps_xla_off_gpu(self, mesh2):
        """Off a GPU the dense engine is plain XLA and GSPMD partitions it;
        no shard_map wrapper is built."""
        from spinglass_tpu.distributed.pt_sharded import make_sharded_engine

        p = _problem(64, seed=12)
        cfg = PTConfig(n_replicas=4, sweep_method="blocked")
        assert make_sharded_engine(p, cfg, mesh2).name == "blocked"


class TestCommunicationBudget:
    """Assertion-style resharding guard: one sharded PT
    super-step must move only O(R) ladder bookkeeping between devices —
    never spin-sized [R, Np] payloads (the design contract of slot-swap
    exchanges, anneal/pt.py module docstring)."""

    def test_superstep_collectives_are_small(self, mesh):
        import re

        p = _problem(64, seed=6)
        n_dev = mesh.devices.size
        cfg = PTConfig(n_replicas=2 * n_dev, exchange_interval=5,
                       use_pallas="never", seed=7)
        step, init, betas, engine, sh = pt_sharded.make_sharded_pt_step(
            p, cfg, mesh)
        state = init(jax.random.key(0))
        txt = jax.jit(step).lower(state).compile().as_text()
        # every collective's payload must stay below spin size:
        # R * Np would be 2*n_dev*128 >= 2048 elements; the slot/energy
        # vectors are O(R) = O(16)
        limit = cfg.n_replicas * 64  # generous: 64 f32 per replica
        offenders = []
        for m in re.finditer(
                r"(all-gather|all-reduce|collective-permute|all-to-all)"
                r"[^\n]*?\b[a-z0-9]+\[([0-9,]*)\]", txt):
            dims = [int(d) for d in m.group(2).split(",") if d]
            size = int(np.prod(dims)) if dims else 1
            if size > limit:
                offenders.append(m.group(0)[:120])
        assert not offenders, offenders
