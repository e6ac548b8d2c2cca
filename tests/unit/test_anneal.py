"""SA driver, schedules, PT, and result tests (reference assertion ideas from
tests/unit/test_annealing_gpu_annealer.py and test_annealing_components.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spinglass_tpu.anneal import pt as PT
from spinglass_tpu.anneal import sa as SA
from spinglass_tpu.anneal import schedules as S
from spinglass_tpu.anneal.result import AnnealResult
from spinglass_tpu.core import energy as E
from spinglass_tpu.core import topology
from spinglass_tpu.core.problem import IsingProblem


def _problem(n=32, seed=0):
    j = topology.fully_connected(n, dist="binary", seed=seed)
    return IsingProblem.from_dense(j, np.zeros(n))


class TestSchedules:
    @pytest.mark.parametrize("stype", [
        S.ScheduleType.LINEAR, S.ScheduleType.EXPONENTIAL,
        S.ScheduleType.GEOMETRIC, S.ScheduleType.LOGARITHMIC,
        S.ScheduleType.POWER_LAW, S.ScheduleType.FAST, S.ScheduleType.BOLTZMANN,
    ])
    def test_monotone_decreasing_and_bounded(self, stype):
        cfg = S.ScheduleConfig(schedule_type=stype, initial_temp=10.0,
                               final_temp=0.01, total_sweeps=200)
        traj = np.asarray(S.schedule_trajectory(cfg))
        assert traj[0] == pytest.approx(10.0, rel=1e-5)
        assert np.all(np.diff(traj) <= 1e-6)
        assert np.all(traj >= 0.01 - 1e-6)

    def test_exponential_hits_endpoints(self):
        cfg = S.ScheduleConfig(S.ScheduleType.EXPONENTIAL, initial_temp=5.0,
                               final_temp=0.05, total_sweeps=100)
        traj = np.asarray(S.schedule_trajectory(cfg))
        assert traj[-1] == pytest.approx(0.05, rel=1e-3)

    def test_adaptive_reacts_to_acceptance(self):
        cfg = S.ScheduleConfig(S.ScheduleType.ADAPTIVE, initial_temp=1.0,
                               final_temp=0.001, alpha=1.0, adaptation_rate=0.1,
                               ema_decay=0.0)
        st = S.init_state(cfg)
        hot = S.update(cfg, st, jnp.asarray(0), jnp.asarray(0.9))
        cold = S.update(cfg, st, jnp.asarray(0), jnp.asarray(0.1))
        assert float(hot.temp) > float(st.temp)
        assert float(cold.temp) < float(st.temp)

    def test_custom_schedule(self):
        cfg = S.ScheduleConfig(S.ScheduleType.CUSTOM, final_temp=0.0,
                               custom_fn=lambda t: 5.0 / (1.0 + t))
        assert float(S.temperature_at(cfg, 4)) == pytest.approx(1.0)

    def test_constant(self):
        cfg = S.ScheduleConfig(S.ScheduleType.CONSTANT, initial_temp=2.5,
                               final_temp=0.0)
        traj = np.asarray(S.schedule_trajectory(cfg, 10))
        assert np.all(traj == 2.5)


class TestSA:
    def test_finds_ferromagnetic_ground_state(self):
        """All-up/all-down ground state of a ferromagnet must be found."""
        n = 16
        j = topology.fully_connected(n, dist="ferromagnetic", scale=1.0)
        p = IsingProblem.from_dense(j)
        cfg = SA.SAConfig(n_sweeps=300, n_replicas=16,
                          schedule=S.ScheduleConfig(initial_temp=5.0,
                                                    final_temp=0.01,
                                                    alpha=0.98),
                          use_pallas="never", seed=1)
        res = SA.anneal(p, cfg)
        ground = -0.5 * n * (n - 1) * 1.0
        assert res.best_energy == pytest.approx(ground, rel=1e-5)
        assert abs(np.sum(res.best_spins)) == n  # fully aligned

    def test_reproducible_under_seed(self):
        """Fixed seed → identical result (reference
        test_annealing_gpu_annealer.py:222)."""
        p = _problem(24, seed=3)
        cfg = SA.SAConfig(n_sweeps=100, n_replicas=8, use_pallas="never", seed=7)
        r1 = SA.anneal(p, cfg)
        r2 = SA.anneal(p, cfg)
        assert r1.best_energy == r2.best_energy
        np.testing.assert_array_equal(r1.best_spins, r2.best_spins)
        np.testing.assert_allclose(r1.energy_history, r2.energy_history)

    def test_energy_decreases(self):
        p = _problem(32, seed=4)
        cfg = SA.SAConfig(n_sweeps=400, n_replicas=8, use_pallas="never", seed=2)
        res = SA.anneal(p, cfg)
        assert res.energy_history[-1] <= res.energy_history[0]
        assert res.best_energy <= res.energy_history[0]

    def test_best_energy_consistent_with_spins(self):
        p = _problem(20, seed=5)
        cfg = SA.SAConfig(n_sweeps=100, n_replicas=4, use_pallas="never")
        res = SA.anneal(p, cfg)
        s = np.zeros(p.n_padded)
        s[:p.n_spins] = res.best_spins
        s[p.n_spins:] = 1.0
        e = float(E.energy(p, jnp.asarray(s)))
        assert e == pytest.approx(res.best_energy, rel=1e-4, abs=1e-3)

    def test_zero_sweeps(self):
        p = _problem(16)
        cfg = SA.SAConfig(n_sweeps=0, n_replicas=2, use_pallas="never")
        res = SA.anneal(p, cfg)
        assert res.n_sweeps == 0

    def test_colored_method_on_grid(self, grid_problem):
        cfg = SA.SAConfig(n_sweeps=200, n_replicas=8, sweep_method="colored",
                          use_pallas="never", seed=0,
                          schedule=S.ScheduleConfig(initial_temp=3.0,
                                                    final_temp=0.05))
        res = SA.anneal(grid_problem, cfg)
        # 8x8 FM grid ground state energy = -n_edges = -112
        assert res.best_energy == pytest.approx(-112.0, rel=1e-5)
        assert "colored" in res.algorithm

    def test_anneal_scan_fully_jitted(self):
        p = _problem(16)
        cfg = SA.SAConfig(n_sweeps=100, n_replicas=4, record_interval=25,
                          use_pallas="never")
        state, hist = SA.anneal_scan(p, cfg)
        assert hist["best_energy"].shape == (4,)
        assert np.all(np.isfinite(np.asarray(hist["best_energy"])))


class TestPT:
    def test_ladder_shapes(self):
        for kind in ("geometric", "linear", "exponential"):
            cfg = PT.PTConfig(n_replicas=8, ladder=kind, min_temp=0.1,
                              max_temp=5.0)
            t = PT.temperature_ladder(cfg)
            assert t.shape == (8,)
            assert t[0] == pytest.approx(0.1, rel=1e-5)
            assert t[-1] == pytest.approx(5.0, rel=1e-5)
            assert np.all(np.diff(t) > 0)

    def test_exchange_probability_math(self, key):
        """An exchange where the hot replica has LOWER energy is always
        accepted (log_p > 0); slot permutation stays a valid permutation."""
        p = _problem(16)
        cfg = PT.PTConfig(n_replicas=4, use_pallas="never")
        state = PT.init_state(p, cfg)
        betas = jnp.asarray([2.0, 1.0, 0.5, 0.25])
        # rig energies: slot1 (hotter) lower energy than slot0 → always swap
        state = state.replace(energy=jnp.asarray([10.0, -10.0, 0.0, 0.0]))
        new = PT.exchange_step(state, betas, jnp.asarray(0), key)
        slot = np.asarray(new.slot)
        assert sorted(slot.tolist()) == [0, 1, 2, 3]
        assert slot[0] == 1 and slot[1] == 0  # pair (0,1) swapped

    def test_rejected_exchange_keeps_slots(self, key):
        p = _problem(16)
        cfg = PT.PTConfig(n_replicas=4, use_pallas="never")
        state = PT.init_state(p, cfg)
        betas = jnp.asarray([2.0, 1.0, 0.5, 0.25])
        # hot replica much HIGHER energy: log_p = (2-1)*(E0-E1) = -2000 → reject
        state = state.replace(energy=jnp.asarray([-1000.0, 1000.0, -1000.0, 1000.0]))
        new = PT.exchange_step(state, betas, jnp.asarray(0), key)
        np.testing.assert_array_equal(np.asarray(new.slot), np.arange(4))
        assert np.asarray(new.exch_attempts)[0] == 1
        assert np.asarray(new.exch_accepts)[0] == 0

    def test_pt_run_finds_ground_state(self):
        n = 16
        j = topology.fully_connected(n, dist="ferromagnetic", scale=1.0)
        p = IsingProblem.from_dense(j)
        cfg = PT.PTConfig(n_replicas=8, n_sweeps=300, min_temp=0.05,
                          max_temp=5.0, exchange_interval=5,
                          use_pallas="never", seed=0)
        res = PT.run(p, cfg)
        assert res.best_energy == pytest.approx(-0.5 * n * (n - 1), rel=1e-5)
        rates = PT.exchange_rate_summary(res)
        assert 0.0 <= rates["mean_exchange_rate"] <= 1.0

    def test_pt_reproducible(self):
        p = _problem(20, seed=9)
        cfg = PT.PTConfig(n_replicas=4, n_sweeps=100, use_pallas="never", seed=5)
        r1, r2 = PT.run(p, cfg), PT.run(p, cfg)
        assert r1.best_energy == r2.best_energy
        np.testing.assert_array_equal(r1.best_spins, r2.best_spins)


class TestResult:
    def test_save_load_roundtrip(self, tmp_path):
        res = AnnealResult(
            best_spins=np.array([1.0, -1.0]), best_energy=-1.5,
            replica_best_energy=np.array([-1.5, -1.0]),
            energy_history=np.array([-1.0, -1.5]),
            mean_energy_history=np.array([-0.5, -1.2]),
            temperature_history=np.array([1.0, 0.5]),
            acceptance_history=np.array([0.5, 0.3]),
            n_sweeps=100, n_replicas=2, total_time=0.1, algorithm="sa",
            seed=42)
        path = str(tmp_path / "res.npz")
        res.save(path)
        r2 = AnnealResult.load(path)
        assert r2.best_energy == res.best_energy
        assert r2.seed == 42
        np.testing.assert_array_equal(r2.best_spins, res.best_spins)

    def test_rejects_nonfinite(self):
        with pytest.raises(ValueError):
            AnnealResult(
                best_spins=np.array([1.0]), best_energy=float("nan"),
                replica_best_energy=np.array([1.0]),
                energy_history=np.array([]), mean_energy_history=np.array([]),
                temperature_history=np.array([]),
                acceptance_history=np.array([]))


class TestLadderTuning:
    def test_tuned_ladder_reduces_rate_spread(self):
        """Feedback-optimized ladder (arXiv:1006.4247) should equalize
        pairwise exchange rates vs the geometric default on an SK glass."""
        import numpy as np

        from spinglass_tpu.anneal import pt as pt_mod
        from spinglass_tpu.core import topology
        from spinglass_tpu.core.problem import IsingProblem

        n = 48
        j = topology.fully_connected(n, dist="gaussian",
                                     scale=1.0 / np.sqrt(n), seed=9)
        p = IsingProblem.from_dense(j)
        cfg = pt_mod.PTConfig(n_replicas=8, n_sweeps=400,
                              exchange_interval=5, min_temp=0.2,
                              max_temp=8.0, use_pallas="never", seed=0)
        base = pt_mod.run(p, cfg)
        base_rates = np.asarray(base.metadata["exchange_rates"])
        temps, diag = pt_mod.tune_ladder(p, cfg, n_pilot_sweeps=200,
                                         n_iters=2)
        tuned = pt_mod.run(p, cfg, ladder_override=temps)
        tuned_rates = np.asarray(tuned.metadata["exchange_rates"])
        assert temps.shape == (8,)
        assert np.all(np.diff(temps) > 0)  # strictly increasing ladder
        # spread (max-min) should not get worse; usually shrinks a lot
        assert tuned_rates.max() - tuned_rates.min() <= (
            base_rates.max() - base_rates.min()) + 0.05
        # endpoints preserved
        np.testing.assert_allclose([temps[0], temps[-1]], [0.2, 8.0],
                                   rtol=1e-5)

    def test_ladder_override_plumbs_through(self):
        import numpy as np

        from spinglass_tpu.anneal import pt as pt_mod
        from spinglass_tpu.core import topology
        from spinglass_tpu.core.problem import IsingProblem

        j = topology.fully_connected(16, dist="binary", seed=2)
        p = IsingProblem.from_dense(j)
        custom = np.geomspace(0.5, 3.0, 4).astype(np.float32)
        cfg = pt_mod.PTConfig(n_replicas=4, n_sweeps=40, exchange_interval=10,
                              use_pallas="never", seed=0)
        res = pt_mod.run(p, cfg, ladder_override=custom)
        np.testing.assert_allclose(res.metadata["ladder"], custom, rtol=1e-6)
        assert "slot_energy" in res.metadata


class TestCheckpointResume:
    """Driver-level checkpoint/resume (reference
    batch_processor.py:521-531 + training_pipeline.py:437-507 save AND
    load). Kill-and-resume must reproduce the uninterrupted run under a
    fixed seed."""

    def test_sa_resume_reproduces_uninterrupted(self, tmp_path):
        import os

        p = _problem(24, seed=5)
        cfg = SA.SAConfig(n_sweeps=200, n_replicas=4, record_interval=20,
                          enable_early_stop=False, seed=11)
        ref = SA.anneal(p, cfg)

        d = str(tmp_path / "sa_ckpt")
        full = SA.anneal(p, cfg, checkpoint_dir=d, checkpoint_every=2)
        np.testing.assert_allclose(full.best_energy, ref.best_energy,
                                   rtol=1e-5)
        # simulate a crash: drop the last checkpoints, resume from an
        # intermediate one
        ckpts = sorted(f for f in os.listdir(d) if f.startswith("ckpt_"))
        assert len(ckpts) >= 2
        for f in ckpts[1:]:
            os.remove(os.path.join(d, f))
        res = SA.anneal(p, cfg, checkpoint_dir=d, resume=True)
        np.testing.assert_allclose(res.best_energy, ref.best_energy,
                                   rtol=1e-5)
        np.testing.assert_array_equal(res.best_spins, ref.best_spins)
        np.testing.assert_allclose(np.asarray(res.energy_history),
                                   np.asarray(ref.energy_history), rtol=1e-5)

    def test_pt_segmented_matches_single_dispatch(self, tmp_path):
        p = _problem(24, seed=6)
        cfg = PT.PTConfig(n_replicas=4, n_sweeps=80, exchange_interval=10,
                          seed=3)
        ref = PT.run(p, cfg)
        seg = PT.run(p, cfg, checkpoint_dir=str(tmp_path / "pt_ckpt"),
                     checkpoint_every=3)
        np.testing.assert_allclose(seg.best_energy, ref.best_energy,
                                   rtol=1e-4)
        np.testing.assert_allclose(
            np.asarray(seg.energy_history), np.asarray(ref.energy_history),
            rtol=1e-4)

    def test_pt_resume_refuses_engine_mismatch(self, tmp_path):
        """A checkpoint written under one engine layout must not silently
        restore into another (auto-dispatch can change the spin carrier,
        e.g. f32 [R,N] -> int8 [NS,R]); the resume fails with pinning
        advice instead."""
        from spinglass_tpu.utils.checkpoint import CheckpointError

        p = _problem(24, seed=9)
        d = str(tmp_path / "pt_ckpt_mismatch")
        cfg = PT.PTConfig(n_replicas=4, n_sweeps=40, exchange_interval=10,
                          sweep_method="colored", seed=5)
        PT.run(p, cfg, checkpoint_dir=d, checkpoint_every=2)
        cfg2 = PT.PTConfig(n_replicas=4, n_sweeps=40, exchange_interval=10,
                           sweep_method="blocked", seed=5)
        with pytest.raises(CheckpointError, match="sweep_method"):
            PT.run(p, cfg2, checkpoint_dir=d, resume=True)

    def test_pt_resume_refuses_spin_dtype_mismatch(self, tmp_path):
        """Same engine NAME but a different spin carrier dtype (r5: the
        single-call sparse mode carries f32 where the threshold path
        carries int8) must also refuse to resume."""
        import json
        import os

        from spinglass_tpu.utils.checkpoint import CheckpointError

        p = _problem(24, seed=9)
        d = str(tmp_path / "pt_ckpt_dtype")
        cfg = PT.PTConfig(n_replicas=4, n_sweeps=40, exchange_interval=10,
                          sweep_method="blocked", seed=5)
        PT.run(p, cfg, checkpoint_dir=d, checkpoint_every=2)
        meta_path = os.path.join(d, "engine_meta.json")
        meta = json.load(open(meta_path))
        meta["spin_dtype"] = "int8"        # simulate an old-layout writer
        json.dump(meta, open(meta_path, "w"))
        with pytest.raises(CheckpointError, match="spin dtype"):
            PT.run(p, cfg, checkpoint_dir=d, resume=True)

    def test_pt_resume_reproduces_uninterrupted(self, tmp_path):
        import os

        p = _problem(24, seed=7)
        cfg = PT.PTConfig(n_replicas=4, n_sweeps=80, exchange_interval=10,
                          seed=4)
        d = str(tmp_path / "pt_ckpt2")
        ref = PT.run(p, cfg, checkpoint_dir=d, checkpoint_every=2)
        ckpts = sorted(f for f in os.listdir(d) if f.startswith("ckpt_"))
        for f in ckpts[1:]:
            os.remove(os.path.join(d, f))
        res = PT.run(p, cfg, checkpoint_dir=d, resume=True)
        np.testing.assert_allclose(res.best_energy, ref.best_energy,
                                   rtol=1e-4)
        np.testing.assert_allclose(
            np.asarray(res.metadata["exchange_rates"]),
            np.asarray(ref.metadata["exchange_rates"]), atol=1e-6)
        # the on-disk history was AHEAD of the restored checkpoint (all 8
        # super-steps recorded, state rolled back to step 2); the resume must
        # truncate it, not append re-run segments after stale rows
        assert res.energy_history.shape == ref.energy_history.shape
        np.testing.assert_allclose(np.asarray(res.energy_history),
                                   np.asarray(ref.energy_history), rtol=1e-4)
        np.testing.assert_array_equal(
            np.asarray(res.metadata["slot_trajectory"]),
            np.asarray(ref.metadata["slot_trajectory"]))


class TestMultiChainPT:
    """n_chains > 1: independent PT chains sharing one ladder, swept in one
    lockstep batch (the way to fill the device at small ladders)."""

    def test_chains_run_and_slots_stay_permutations(self):
        p = _problem(24, seed=8)
        cfg = PT.PTConfig(n_replicas=4, n_chains=3, n_sweeps=60,
                          exchange_interval=10, seed=5)
        res = PT.run(p, cfg)
        assert np.isfinite(res.best_energy)
        rates = np.asarray(res.metadata["exchange_rates"])
        assert rates.shape == (3,)
        assert np.all((rates >= 0) & (rates <= 1))

    def test_chain_exchange_independence(self, key):
        """exchange_step with C chains: each chain's slots remain a
        permutation of the ladder."""
        p = _problem(16, seed=9)
        cfg = PT.PTConfig(n_replicas=4, n_chains=3, n_sweeps=10,
                          exchange_interval=5, seed=6)
        eng = None
        state = PT.init_state(p, cfg, key)
        betas = jnp.asarray(1.0 / PT.temperature_ladder(cfg))
        st = PT.exchange_step(state, betas, jnp.int32(0), key,
                              n_chains=3)
        slots = np.asarray(st.slot).reshape(3, 4)
        for c in range(3):
            assert sorted(slots[c].tolist()) == [0, 1, 2, 3]

    def test_more_chains_at_least_as_good(self):
        """With the same per-chain budget, 4 chains' best-of is (stochastically)
        at least as good as 1 chain's on a frustrated instance — structural
        sanity, fixed seed."""
        p = _problem(32, seed=10)
        cfg1 = PT.PTConfig(n_replicas=4, n_chains=1, n_sweeps=100,
                           exchange_interval=10, seed=7)
        cfg4 = PT.PTConfig(n_replicas=4, n_chains=4, n_sweeps=100,
                           exchange_interval=10, seed=7)
        r1 = PT.run(p, cfg1)
        r4 = PT.run(p, cfg4)
        assert r4.best_energy <= r1.best_energy + 1e-3


class TestPTExchangeModes:
    """All-pairs exchange + cluster-move mixing + slot trajectories
    (reference parallel_tempering.py:222-232,
    323-410)."""

    def test_all_pairs_runs_and_exchanges(self):
        p = _problem(24, seed=12)
        cfg = PT.PTConfig(n_replicas=8, n_sweeps=100, exchange_interval=10,
                          exchange_method="all_pairs", seed=8,
                          min_temp=0.5, max_temp=3.0)
        res = PT.run(p, cfg)
        assert np.isfinite(res.best_energy)
        rates = np.asarray(res.metadata["exchange_rates"])
        assert res.metadata["exchange_method"] == "all_pairs"
        # random matchings attempt non-adjacent pairs too; with a tight
        # ladder some exchanges must land
        assert np.asarray(res.metadata["exchange_rates"]).max() > 0

    def test_all_pairs_slot_permutation_preserved(self, key):
        p = _problem(16, seed=13)
        cfg = PT.PTConfig(n_replicas=8, n_chains=2, n_sweeps=10,
                          exchange_interval=5, seed=9)
        state = PT.init_state(p, cfg, key)
        betas = jnp.asarray(1.0 / PT.temperature_ladder(cfg))
        st = PT.exchange_step_all_pairs(state, betas, key, n_chains=2)
        slots = np.asarray(st.slot).reshape(2, 8)
        for c in range(2):
            assert sorted(slots[c].tolist()) == list(range(8))

    def test_slot_trajectory_recorded(self):
        p = _problem(24, seed=14)
        cfg = PT.PTConfig(n_replicas=4, n_sweeps=60, exchange_interval=10,
                          seed=10)
        res = PT.run(p, cfg)
        traj = np.asarray(res.metadata["slot_trajectory"])
        assert traj.shape == (6, 4)
        for t in range(traj.shape[0]):
            assert sorted(traj[t].tolist()) == [0, 1, 2, 3]

    def test_cluster_moves_mix_in(self):
        p = _problem(24, seed=15)
        cfg = PT.PTConfig(n_replicas=4, n_sweeps=40, exchange_interval=10,
                          cluster_moves=1, seed=11)
        res = PT.run(p, cfg)
        assert np.isfinite(res.best_energy)
        # energies remain exact after mixed SW + Metropolis updates
        # (best <= all current energies is implied by best tracking)
        assert res.best_energy <= np.min(np.asarray(
            res.replica_best_energy)) + 1e-6

    def test_trajectory_plots_render(self, tmp_path):
        pytest.importorskip("matplotlib")
        from spinglass_tpu.utils import plotting

        p = _problem(24, seed=16)
        cfg = PT.PTConfig(n_replicas=4, n_sweeps=60, exchange_interval=10,
                          seed=12)
        res = PT.run(p, cfg)
        p1 = plotting.plot_replica_trajectories(
            res, str(tmp_path / "traj.png"))
        p2 = plotting.plot_exchange_matrix(
            res, str(tmp_path / "xmat.png"))
        import os
        assert os.path.getsize(p1) > 0 and os.path.getsize(p2) > 0


class TestSignatureSharedSolverCache:
    """Round-5: same-trace-signature dense problems share compiled solver
    executables (jit_cache.SolverCache signature keying) — a cross-object
    hit must rebuild operands for the CURRENT problem and reproduce a
    cold-cache solve exactly."""

    def _p(self, seed, n=24):
        j = topology.fully_connected(n, dist="gaussian",
                                     scale=1.0 / np.sqrt(n), seed=seed)
        return IsingProblem.from_dense(j)

    def test_sa_cross_object_hit_exact(self):
        from spinglass_tpu.anneal.jit_cache import sa_cache

        cfg = SA.SAConfig(n_sweeps=60, n_replicas=4, use_pallas="never", seed=3)
        p1, p2 = self._p(0), self._p(1)
        sa_cache().clear()
        SA.anneal(p1, cfg)
        h0 = sa_cache().hits
        warm = SA.anneal(p2, cfg)          # signature hit, different content
        assert sa_cache().hits == h0 + 1
        sa_cache().clear()
        cold = SA.anneal(p2, cfg)          # fresh build for the same problem
        assert warm.best_energy == cold.best_energy
        np.testing.assert_array_equal(warm.best_spins, cold.best_spins)
        # and the two problems genuinely got different answers
        assert warm.best_energy != SA.anneal(p1, cfg).best_energy

    def test_pt_cross_object_hit_exact(self):
        from spinglass_tpu.anneal import pt as pt_mod
        from spinglass_tpu.anneal.jit_cache import pt_cache

        cfg = pt_mod.PTConfig(n_replicas=4, n_sweeps=40,
                              exchange_interval=10, use_pallas="never",
                              seed=5)
        p1, p2 = self._p(2), self._p(3)
        pt_cache().clear()
        pt_mod.run(p1, cfg)
        h0 = pt_cache().hits
        warm = pt_mod.run(p2, cfg)
        assert pt_cache().hits == h0 + 1
        pt_cache().clear()
        cold = pt_mod.run(p2, cfg)
        assert warm.best_energy == cold.best_energy
        np.testing.assert_array_equal(warm.best_spins, cold.best_spins)

    def test_repeat_anneal_traces_init_once(self, monkeypatch):
        """Repeated anneal() on one sparse problem object reuses the cached
        jitted state initialisation instead of tracing it again."""
        from spinglass_tpu.anneal.jit_cache import sa_cache
        from spinglass_tpu.kernels.sparse import EllProblem

        traces = []
        real_init = SA.init_state

        def counting_init(*a, **k):
            traces.append(1)
            return real_init(*a, **k)

        monkeypatch.setattr(SA, "init_state", counting_init)
        coo = topology.sparse_random_graph_coo(64, avg_degree=4.0,
                                               dist="gaussian", seed=2)
        ell = EllProblem.from_coo(64, *coo)
        cfg = SA.SAConfig(n_sweeps=20, n_replicas=4, record_interval=10,
                          enable_early_stop=False, seed=1)
        sa_cache().clear()
        first = SA.anneal(ell, cfg)
        second = SA.anneal(ell, cfg)
        assert len(traces) == 1
        assert first.best_energy == second.best_energy
        sa_cache().clear()

    def test_different_n_spins_do_not_collide(self):
        # same padded shape (both pad to 128) but different logical size:
        # signatures differ, so no sharing
        p1, p2 = self._p(0, n=24), self._p(0, n=32)
        assert p1.n_padded == p2.n_padded
        assert p1.trace_signature() != p2.trace_signature()

    def test_ell_problem_keeps_id_keying(self):
        from spinglass_tpu.kernels.sparse import EllProblem

        coo = topology.sparse_random_graph_coo(64, avg_degree=4.0,
                                               dist="gaussian", seed=0)
        ell = EllProblem.from_coo(64, *coo)
        assert not hasattr(ell, "trace_signature")

    def test_engine_dispatch_divergence_does_not_collide(self):
        """Same-shape problems whose AUTO dispatch picks different engines
        (content-dependent coloring) must not share cache entries: a
        fully-connected instance (uncolorable within max_colors -> blocked)
        and a 2-colorable ring of the same padded shape (-> colored).
        Regression for the r5 suite failure (KeyError 'masks': a cached
        blocked chunk received a colored engine's operand pytree)."""
        from spinglass_tpu.anneal.jit_cache import sa_cache

        dense = self._p(0)                    # n=24 fully connected
        ring = IsingProblem.from_dense(
            topology.chain(24, periodic=True, dist="binary", seed=1))
        assert dense.trace_signature() == ring.trace_signature()
        cfg = SA.SAConfig(n_sweeps=40, n_replicas=4, use_pallas="never",
                          seed=0)
        sa_cache().clear()
        r1 = SA.anneal(dense, cfg)
        r2 = SA.anneal(ring, cfg)             # KeyError before the fix
        assert np.isfinite(r1.best_energy) and np.isfinite(r2.best_energy)
