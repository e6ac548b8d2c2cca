"""Aux-subsystem tests: logging, validation, monitoring, health, checkpoint,
robust retry (reference test ideas from utils/ suites, SURVEY §2.9)."""

import logging
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spinglass_tpu.utils import checkpoint as ckpt
from spinglass_tpu.utils import health as H
from spinglass_tpu.utils import monitoring as mon
from spinglass_tpu.utils import validation as V
from spinglass_tpu.utils.exceptions import (AnnealingError, CheckpointError,
                                            ValidationError)
from spinglass_tpu.utils.logging import (JSONFormatter, PerformanceLogger,
                                         RedactionFilter, setup_logger)
from spinglass_tpu.utils.robust import robust_operation


class TestLogging:
    def test_json_formatter(self):
        rec = logging.LogRecord("t", logging.INFO, "f", 1, "hello %s",
                                ("x",), None)
        import json
        out = json.loads(JSONFormatter().format(rec))
        assert out["message"] == "hello x"
        assert out["level"] == "INFO"

    def test_redaction(self):
        rec = logging.LogRecord("t", logging.INFO, "f", 1,
                                "connect api_key=SECRET123 ok", (), None)
        RedactionFilter().filter(rec)
        assert "SECRET123" not in rec.getMessage()
        assert "redacted" in rec.getMessage()

    def test_performance_logger_timing(self):
        pl = PerformanceLogger(setup_logger("t1"))
        with pl.timer("op"):
            time.sleep(0.01)
        s = pl.summary()
        assert s["op"]["n"] == 1
        assert s["op"]["mean"] >= 0.01

    def test_rotating_file(self, tmp_path):
        log_file = str(tmp_path / "x.log")
        lg = setup_logger("t2", log_file=log_file)
        lg.info("file line")
        for h in lg.handlers:
            h.flush()
        assert "file line" in open(log_file).read()


class TestValidation:
    def test_spins(self):
        V.validate_spins(np.array([1.0, -1.0, 1.0]))
        with pytest.raises(ValidationError):
            V.validate_spins(np.array([1.0, 0.5]))

    def test_couplings(self):
        j = np.array([[0.0, 1.0], [1.0, 0.0]])
        V.validate_couplings(j)
        with pytest.raises(ValidationError):
            V.validate_couplings(np.array([[0.0, 1.0], [2.0, 0.0]]))
        with pytest.raises(ValidationError):
            V.validate_couplings(np.eye(2))

    def test_temperature(self):
        V.validate_temperature(1.0)
        for bad in (0.0, -1.0, float("nan")):
            with pytest.raises(ValidationError):
                V.validate_temperature(bad)
        with pytest.raises(ValidationError):
            V.validate_temperature_range(2.0, 1.0)

    def test_problem(self, small_problem):
        V.validate_problem(small_problem)


class TestMonitoring:
    def test_sampler_thread(self):
        m = mon.PerformanceMonitor(interval=0.05).start()
        deadline = time.time() + 3.0
        while time.time() < deadline and m.snapshot()["n_samples"] < 1:
            time.sleep(0.05)
        m.stop()
        assert m.snapshot()["n_samples"] >= 1

    def test_counters(self):
        m = mon.PerformanceMonitor()
        m.record("sweeps", 10)
        m.record("sweeps", 5)
        assert m.snapshot()["counters"]["sweeps"] == 15

    def test_circuit_breaker_trips_and_recovers(self):
        cb = mon.CircuitBreaker(failure_threshold=2, cooldown_seconds=0.05)
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            raise RuntimeError("boom")

        for _ in range(2):
            with pytest.raises(RuntimeError):
                cb.call(flaky)
        assert cb.state == "open"
        with pytest.raises(AnnealingError):
            cb.call(flaky)
        assert calls["n"] == 2  # open circuit short-circuits
        time.sleep(0.06)
        assert cb.state == "half_open"
        assert cb.call(lambda: 42) == 42
        assert cb.state == "closed"


class TestHealth:
    def test_device_and_deps(self):
        assert H.check_device_compute().status == H.HealthStatus.HEALTHY
        assert H.check_dependencies().status == H.HealthStatus.HEALTHY

    def test_model_check(self, small_problem):
        assert H.check_model(small_problem).status == H.HealthStatus.HEALTHY

    def test_monitor_aggregates(self):
        rep = H.HealthMonitor([H.check_dependencies,
                               H.check_device_compute]).run()
        assert rep["status"] == "healthy"
        assert set(rep["checks"]) == {"dependencies", "device_compute"}

    @pytest.mark.slow
    def test_annealer_micro_check(self):
        assert H.check_annealer().status == H.HealthStatus.HEALTHY


class TestCheckpoint:
    def test_npz_roundtrip_pytree(self, tmp_path):
        tree = {"a": jnp.arange(4.0), "b": {"c": jnp.ones((2, 2))}}
        path = str(tmp_path / "ck.npz")
        ckpt.save_pytree(tree, path)
        out = ckpt.load_pytree(tree, path)
        np.testing.assert_array_equal(np.asarray(out["a"]), np.arange(4.0))

    def test_missing_leaf_raises(self, tmp_path):
        path = str(tmp_path / "ck.npz")
        ckpt.save_pytree({"a": jnp.zeros(2)}, path)
        with pytest.raises(CheckpointError):
            ckpt.load_pytree({"a": jnp.zeros(2), "b": jnp.zeros(1)}, path)

    def test_manager_cadence_and_retention(self, tmp_path):
        mgr = ckpt.CheckpointManager(str(tmp_path), every=2, keep=2,
                                     use_orbax=False)
        tree = {"x": jnp.zeros(3)}
        saved = [mgr.maybe_save(s, tree) for s in range(8)]
        assert sum(p is not None for p in saved) == 4  # steps 0,2,4,6
        assert mgr.latest_step() == 6
        import os
        ckpts = [f for f in os.listdir(tmp_path) if f.startswith("ckpt_")]
        assert len(ckpts) == 2  # retention

    def test_restore_latest(self, tmp_path):
        mgr = ckpt.CheckpointManager(str(tmp_path), every=1, use_orbax=False)
        mgr.maybe_save(0, {"x": jnp.zeros(2)})
        mgr.maybe_save(1, {"x": jnp.ones(2)})
        out = mgr.restore_latest({"x": jnp.zeros(2)})
        np.testing.assert_array_equal(np.asarray(out["x"]), np.ones(2))

    def test_anneal_state_checkpoint(self, small_problem, tmp_path):
        """Full SAState pytree roundtrip — the unified mechanism covering the
        reference's 4 separate ones (SURVEY §5)."""
        from spinglass_tpu.anneal.sa import SAConfig, init_state, make_sweep_engine

        cfg = SAConfig(n_replicas=4, use_pallas="never")
        eng = make_sweep_engine(small_problem, cfg)
        st = init_state(small_problem, cfg, eng)
        path = str(tmp_path / "sa.npz")
        ckpt.save_pytree(st, path)
        st2 = ckpt.load_pytree(st, path)
        np.testing.assert_array_equal(np.asarray(st.spins),
                                      np.asarray(st2.spins))


class TestRobust:
    def test_retries_then_succeeds(self):
        calls = {"n": 0}

        @robust_operation(max_retries=3, backoff=0.001)
        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("flake")
            return "ok"

        assert flaky() == "ok"
        assert calls["n"] == 3

    def test_fallback_used(self):
        @robust_operation(max_retries=1, backoff=0.001,
                          fallback=lambda: "fallback")
        def broken():
            raise RuntimeError("always")

        assert broken() == "fallback"

    def test_raises_after_exhaustion(self):
        @robust_operation(max_retries=1, backoff=0.001)
        def broken():
            raise ValueError("nope")

        with pytest.raises(ValueError):
            broken()


class TestMetricsAuth:
    """Token-gated metrics endpoint (the one real
    HTTP surface, gated with the reference enterprise tier's intent)."""

    def test_token_roles_and_revocation(self, tmp_path):
        from spinglass_tpu.utils.security import AuditLogger, TokenAuthenticator

        audit = AuditLogger(path=str(tmp_path / "audit.jsonl"))
        auth = TokenAuthenticator(tokens={}, audit=audit)
        reader = auth.issue("reader")
        admin = auth.issue("admin")
        assert auth.check(reader, "reader")
        assert not auth.check(reader, "admin")
        assert auth.check(admin, "reader")   # hierarchy: admin >= reader
        assert auth.check(admin, "admin")
        assert not auth.check("wrong-token")
        assert not auth.check(None)
        assert auth.revoke(reader)
        assert not auth.check(reader)
        actions = [e["action"] for e in audit.entries()]
        assert "token_issued" in actions and "auth_check" in actions

    def test_metrics_server_requires_bearer_token(self):
        import urllib.request
        import urllib.error

        from spinglass_tpu.utils.metrics_exporter import (MetricsRegistry,
                                                          MetricsServer)
        from spinglass_tpu.utils.security import TokenAuthenticator

        reg = MetricsRegistry()
        reg.counter_inc("sweeps_total", 3.0)
        auth = TokenAuthenticator(tokens={})
        token = auth.issue("reader")
        srv = MetricsServer(reg, port=0, auth=auth).start()
        try:
            url = f"http://127.0.0.1:{srv.port}/metrics"
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(url)
            assert exc.value.code == 401
            req = urllib.request.Request(
                url, headers={"Authorization": f"Bearer {token}"})
            body = urllib.request.urlopen(req).read().decode()
            assert "spinglass_sweeps_total 3.0" in body
        finally:
            srv.stop()
