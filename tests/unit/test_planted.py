"""Planted-ground-state instances + time-to-target (BASELINE.md:25-28)."""

import numpy as np
import pytest

from spinglass_tpu.benchmarks import planted
from spinglass_tpu.kernels.sparse import EllProblem, sparse_energy


class TestPlantedGauge:
    def test_planted_state_is_ground_state(self):
        """Every bond satisfied at s*: no single-spin flip can lower E, and
        E(s*) equals the analytic -sum |J| bound exactly."""
        inst = planted.planted_gauge_coo(200, avg_degree=5.0, seed=3)
        # symmetric COO: each undirected bond appears twice
        e_direct = -0.5 * float(np.sum(
            inst.vals * inst.s_star[inst.rows] * inst.s_star[inst.cols]))
        assert e_direct == pytest.approx(inst.e0, rel=1e-9)
        assert inst.e0 == pytest.approx(
            -0.5 * np.sum(np.abs(inst.vals)), rel=1e-9)

    def test_energy_through_ell_matches(self):
        import jax.numpy as jnp

        inst = planted.planted_gauge_coo(128, avg_degree=4.0, seed=5)
        ell = EllProblem.from_coo(inst.n_spins, inst.rows, inst.cols,
                                  inst.vals)
        s = np.zeros((1, ell.n_padded), np.float32)
        s[0, : inst.n_spins] = inst.s_star
        s[0, inst.n_spins:] = 1.0
        e = float(sparse_energy(ell, jnp.asarray(s))[0])
        assert e == pytest.approx(inst.e0, rel=1e-5)

    def test_frustration_flag_breaks_exactness(self):
        inst = planted.planted_gauge_coo(100, avg_degree=4.0, seed=7,
                                         frustration=0.2)
        assert inst.e0 > -0.5 * np.sum(np.abs(inst.vals))  # no longer tight

    def test_magnitude_ones(self):
        inst = planted.planted_gauge_coo(50, avg_degree=3.0, seed=1,
                                         magnitude="ones")
        np.testing.assert_allclose(np.abs(inst.vals), 1.0)


class TestTimeToTarget:
    def test_pt_reaches_planted_target(self):
        """PT on a small planted instance must hit the exact ground energy
        (unfrustrated gauge instances are easy — that is the point: the
        metric measures solver wall-clock, not instance hardness)."""
        inst = planted.planted_gauge_coo(200, avg_degree=5.0, seed=11)
        ell = EllProblem.from_coo(inst.n_spins, inst.rows, inst.cols,
                                  inst.vals)
        from spinglass_tpu.anneal import pt as pt_mod

        cfg = pt_mod.PTConfig(n_replicas=8, exchange_interval=10,
                              min_temp=0.1, max_temp=5.0, seed=0)
        out = planted.time_to_target(ell, inst.e0, cfg, rel_gap=1e-3,
                                     max_sweeps=2000)
        assert out["hit"], out
        assert out["best_energy"] <= out["threshold"]
        assert out["seconds"] > 0

    def test_multi_seed_reports_per_seed_median(self):
        """seeds= runs the SAME compiled executable once per seed and
        reports the median-by-seconds run at the top level (one-seed TTT
        is flaky; measure the spread)."""
        inst = planted.planted_gauge_coo(100, avg_degree=4.0, seed=2)
        ell = EllProblem.from_coo(inst.n_spins, inst.rows, inst.cols,
                                  inst.vals)
        from spinglass_tpu.anneal import pt as pt_mod

        cfg = pt_mod.PTConfig(n_replicas=4, exchange_interval=5,
                              min_temp=0.1, max_temp=5.0, seed=0)
        out = planted.time_to_target(ell, inst.e0, cfg, rel_gap=1e-3,
                                     max_sweeps=1500, seeds=(0, 1, 2))
        assert out["seeds"] == [0, 1, 2]
        assert len(out["per_seed"]) == 3
        secs = sorted(r["seconds"] for r in out["per_seed"])
        assert out["seconds"] == secs[1]            # median
        assert out["seconds_min"] == secs[0]
        assert out["seconds_max"] == secs[2]
        assert out["all_hit"] == all(r["hit"] for r in out["per_seed"])


class TestTTTProvenance:
    def test_provenance_hash_matches_generator(self):
        """The committed ttt_provenance.json must describe exactly the
        instance the generator produces today — if numpy or the generator
        drifts, the best-known energy no longer applies and the bench must
        refuse to run (headline.bench_ttt raises on mismatch)."""
        from spinglass_tpu.benchmarks import headline

        prov, path = headline._load_ttt_provenance()
        spec = prov["instance"]
        inst = planted.planted_gauge_coo(
            spec["n_spins"], avg_degree=spec["avg_degree"],
            seed=spec["seed"], frustration=spec["frustration"],
            magnitude=spec["magnitude"])
        assert planted.instance_hash(inst) == spec["sha256"]
        assert len(inst.rows) == spec["n_directed_entries"]
        assert inst.e0 == pytest.approx(spec["planted_state_energy"])
        # the best-known target must beat the planted state's energy
        # (frustrated: planted state is only an upper bound)
        assert prov["best_known_energy"] < inst.e0
        assert all(r["best_energy"] >= prov["best_known_energy"] - 1e-2
                   for r in prov["deep_runs"])


def test_repeat_solve_reuses_init_and_solve(monkeypatch):
    """A second time_to_target on the same problem object traces neither
    the state initialisation nor the solve again, and reproduces the
    first result."""
    from spinglass_tpu.anneal import pt as pt_mod
    from spinglass_tpu.anneal.jit_cache import pt_cache

    traces = []
    real_init = pt_mod.init_state

    def counting_init(*a, **k):
        traces.append(1)
        return real_init(*a, **k)

    monkeypatch.setattr(pt_mod, "init_state", counting_init)
    inst = planted.planted_gauge_coo(100, avg_degree=4.0, seed=4)
    ell = EllProblem.from_coo(inst.n_spins, inst.rows, inst.cols, inst.vals)
    cfg = pt_mod.PTConfig(n_replicas=4, exchange_interval=5, min_temp=0.1,
                          max_temp=5.0, seed=0)
    pt_cache().clear()
    first = planted.time_to_target(ell, inst.e0, cfg, max_sweeps=500)
    hits = pt_cache().hits
    second = planted.time_to_target(ell, inst.e0, cfg, max_sweeps=500)
    assert pt_cache().hits == hits + 1
    assert len(traces) == 1
    assert (first["sweeps"], first["best_energy"]) == (
        second["sweeps"], second["best_energy"])
    pt_cache().clear()
