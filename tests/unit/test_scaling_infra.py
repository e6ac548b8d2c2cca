"""Auto-scaling, anomaly/self-healing, work stealing, metrics exporter,
global infrastructure, edge orchestration, unified research framework."""

import time
import urllib.request

import numpy as np
import pytest

from spinglass_tpu.core import topology
from spinglass_tpu.core.problem import IsingProblem


def small_problem(n=24, seed=0):
    j = topology.fully_connected(n, dist="gaussian",
                                 scale=1.0 / np.sqrt(n), seed=seed)
    return IsingProblem.from_dense(j)


class TestAnomaly:
    def test_spike_detected(self):
        from spinglass_tpu.utils.anomaly import AnomalyDetector

        det = AnomalyDetector(warmup=3)
        for _ in range(10):
            assert det.observe("lat", 1.0 + np.random.default_rng(0)
                               .normal(0, 1e-3)) is None or True
        a = det.observe("lat", 100.0)
        assert a is not None and a.kind == "spike"

    def test_stuck_detected(self):
        from spinglass_tpu.utils.anomaly import AnomalyDetector

        det = AnomalyDetector(stuck_after=4, z_threshold=1e9)
        out = [det.observe("x", 5.0) for _ in range(8)]
        kinds = [a.kind for a in out if a]
        assert "stuck" in kinds

    def test_self_healing_fires_and_limits(self):
        from spinglass_tpu.utils.anomaly import (AdaptiveMonitoringSystem,
                                                 AnomalyDetector,
                                                 SelfHealingSystem)

        calls = []
        healer = SelfHealingSystem(max_attempts_per_metric=2)
        healer.register("hbm*", "*", lambda a: calls.append(a.metric),
                        name="shrink_batch")
        sys_ = AdaptiveMonitoringSystem(
            AnomalyDetector(warmup=2, z_threshold=2.0), healer)
        for v in [1.0, 1.0, 1.0, 1.0, 50.0, 1.0, 80.0, 1.0, 90.0]:
            sys_.record("hbm_used", v)
        assert 1 <= len(calls) <= 2  # healed, but capped at max_attempts
        rep = sys_.report()
        assert rep["healing"]["n_healings"] == len(calls)


class TestAutoscale:
    def test_scale_up_on_high_util(self):
        from spinglass_tpu.utils.autoscale import AdaptiveScaler

        d = AdaptiveScaler(cooldown_s=0.0).decide(
            n_replicas=256, utilization=0.95, hbm_used_fraction=0.4,
            queue_depth=10)
        assert d.target > 256

    def test_scale_down_on_memory_pressure(self):
        from spinglass_tpu.utils.autoscale import AdaptiveScaler

        d = AdaptiveScaler(cooldown_s=0.0).decide(
            n_replicas=1024, utilization=0.99, hbm_used_fraction=0.95,
            queue_depth=10)
        assert d.target == 512 and "hbm" in d.reason

    def test_cooldown_blocks_change(self):
        from spinglass_tpu.utils.autoscale import AdaptiveScaler

        s = AdaptiveScaler(cooldown_s=1000.0)
        d1 = s.decide(n_replicas=256, utilization=0.95,
                      hbm_used_fraction=0.4, queue_depth=5)
        d2 = s.decide(n_replicas=d1.target, utilization=0.95,
                      hbm_used_fraction=0.4, queue_depth=5)
        assert d1.changed and not d2.changed

    def test_predictor_tracks_trend(self):
        from spinglass_tpu.utils.autoscale import WorkloadPredictor

        p = WorkloadPredictor()
        for i in range(20):
            p.observe(float(i))
        assert p.predict(1) > 15.0

    def test_multiobjective_respects_memory(self):
        from spinglass_tpu.utils.autoscale import MultiObjectiveScaler

        m = MultiObjectiveScaler()
        m.observe(256, 500, 1e9)
        out = m.decide(hbm_bytes_per_replica=64 * 1024 * 1024,
                       hbm_budget=8 * 1024 ** 3)
        assert out["est_hbm"] <= 8 * 1024 ** 3
        assert out["n_replicas"] >= 64

    def test_manager_ticks(self):
        from spinglass_tpu.utils.autoscale import AutoScalingManager

        mgr = AutoScalingManager()
        for _ in range(3):
            d = mgr.tick(n_replicas=128, utilization=0.9,
                         hbm_used_fraction=0.3, queue_depth=8)
        assert d.resource == "n_replicas"


class TestWorkPool:
    def test_map_runs_all_and_steals(self):
        from spinglass_tpu.distributed.workpool import WorkerPool

        def make(i):
            def fn():
                if i % 7 == 0:
                    time.sleep(0.02)  # imbalance → stealing
                return i * i
            return fn

        pool = WorkerPool(n_workers=4)
        items = pool.map([make(i) for i in range(40)], timeout=30)
        assert [it.result for it in items] == [i * i for i in range(40)]
        rep = pool.report()
        assert sum(rep["executed"]) == 40

    def test_errors_captured_not_raised(self):
        from spinglass_tpu.distributed.workpool import WorkerPool

        def boom():
            raise ValueError("nope")

        items = WorkerPool(2).map([boom, lambda: 1], timeout=10)
        assert items[0].error and "ValueError" in items[0].error
        assert items[1].result == 1


class TestMetricsExporter:
    def test_render_counter_gauge_histogram(self):
        from spinglass_tpu.utils.metrics_exporter import MetricsRegistry

        reg = MetricsRegistry()
        reg.counter_inc("sweeps_total", 5, labels={"algo": "sa"},
                        help_="total sweeps")
        reg.gauge_set("replicas", 256)
        reg.observe("solve_seconds", 0.05)
        text = reg.render()
        assert 'spinglass_sweeps_total{algo="sa"} 5.0' in text
        assert "spinglass_replicas 256.0" in text
        assert "spinglass_solve_seconds_count 1.0" in text
        assert "# TYPE spinglass_sweeps_total counter" in text

    def test_http_endpoint(self):
        from spinglass_tpu.utils.metrics_exporter import (MetricsRegistry,
                                                          MetricsServer)

        reg = MetricsRegistry()
        reg.gauge_set("up", 1)
        srv = MetricsServer(reg, port=0).start()
        try:
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=5).read()
            assert b"spinglass_up 1.0" in body
        finally:
            srv.stop()


class TestGlobalInfra:
    def test_i18n_fallback_and_locales(self):
        from spinglass_tpu.deployment.global_infra import I18nManager

        i = I18nManager("ja")
        assert i.t("solve.done") == "最適化が完了しました"
        assert i.t("no.such.key") == "no.such.key"
        with pytest.raises(ValueError):
            i.set_locale("xx")

    def test_compliance_consent_and_transfer(self):
        from spinglass_tpu.deployment.global_infra import ComplianceManager

        c = ComplianceManager("GDPR")
        assert not c.can_process("u1")
        c.record_consent("u1")
        assert c.can_process("u1")
        assert not c.can_transfer("europe-west4", "us-central1")
        assert ComplianceManager("CCPA").can_transfer("us-central1",
                                                      "europe-west4")

    def test_retention_and_scrub(self):
        from spinglass_tpu.deployment.global_infra import ComplianceManager

        c = ComplianceManager("GDPR")
        assert c.retention_expired(0.0, now=100 * 86400)
        rec = c.scrub({"user_email": "a@b.c", "energy": -3.0})
        assert rec["user_email"] == "<redacted>" and rec["energy"] == -3.0

    def test_region_placement_respects_residency(self):
        from spinglass_tpu.deployment.global_infra import (
            GlobalInfrastructureManager)

        g = GlobalInfrastructureManager(home_region="europe-west4")
        placed = g.place(accelerator="h100", data_origin="europe-west4")
        assert placed.name == "europe-west4"  # GDPR: no cross-border
        g2 = GlobalInfrastructureManager(home_region="us-central1")
        assert len(g2.eligible_regions("h100", "us-central1")) >= 2
        assert not g2.eligible_regions("h200", "europe-west4")


class TestEdge:
    def test_dispatch_and_run(self):
        from spinglass_tpu.distributed.edge import EdgeOrchestrator

        orch = EdgeOrchestrator(n_sweeps=30, n_replicas=4)
        p = small_problem(16)
        out = orch.submit(p, prefer_backend="sa")
        assert out.backend == "sa" and np.isfinite(out.best_energy)
        rep = orch.report()
        assert rep["n_jobs"] == 1

    def test_node_selection_prefers_fast(self):
        from spinglass_tpu.distributed.edge import EdgeNode, EdgeOrchestrator

        slow = EdgeNode("slow", "sa", latency_s=5.0)
        fast = EdgeNode("fast", "sa", latency_s=0.001)
        orch = EdgeOrchestrator(nodes=[slow, fast], n_sweeps=10)
        assert orch.pick_node(small_problem(8)).name == "fast"


class TestUnified:
    def test_analyze_classifies(self):
        from spinglass_tpu.research.unified import ProblemAnalyzer

        n = 16
        ferro = IsingProblem.from_dense(np.asarray(
            topology.fully_connected(n, dist="ferromagnetic", seed=0)))
        a = ProblemAnalyzer().analyze(ferro)
        assert a.problem_class == "ferromagnetic"
        sg = small_problem(16)
        assert ProblemAnalyzer().analyze(sg).problem_class == "spin_glass"

    def test_solve_and_learn(self):
        from spinglass_tpu.research.unified import UnifiedResearchFramework

        fw = UnifiedResearchFramework(n_sweeps=40, n_replicas=4)
        p = small_problem(12)
        res = fw.solve(p, algorithm="sa")
        assert np.isfinite(float(res.best_energy))
        rep = fw.report()
        assert rep["n_solved"] == 1 and rep["problem_classes"]

    def test_selector_uses_evidence(self):
        from spinglass_tpu.research.unified import (AlgorithmSelector,
                                                    ProblemAnalyzer)

        sel = AlgorithmSelector(min_evidence=2)
        analysis = ProblemAnalyzer().analyze(small_problem(12))
        for _ in range(3):
            sel.record(analysis.problem_class, "pt", 0.9)
            sel.record(analysis.problem_class, "sa", 0.1)
        assert sel.select(analysis) == "pt"


class TestFederatedQuantum:
    def test_runs_and_aggregates(self):
        from spinglass_tpu.research.federated import (
            FederatedConfig, FederatedQuantumHybridOptimizer)

        opt = FederatedQuantumHybridOptimizer(
            FederatedConfig(n_rounds=2, local_sweeps=40, n_replicas=4),
            n_stages=2)
        out = opt.run([small_problem(10, seed=i) for i in range(2)])
        assert len(out["history"]) == 2
        assert out["global_gamma0"] > 0


class TestComposeMonitoringWiring:
    """The docker-compose monitoring stack must stay consistent with the
    exporter (the reference composes prometheus +
    grafana; the rebuild had a better exporter but nothing scraping it)."""

    def _repo(self):
        import os

        return os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))

    def test_scrape_target_matches_exporter(self):
        import os

        import yaml

        repo = self._repo()
        comp = yaml.safe_load(open(os.path.join(repo, "docker-compose.yml")))
        prom = yaml.safe_load(open(os.path.join(
            repo, "deployment/monitoring/prometheus.yml")))
        env = comp["services"]["solver"]["environment"]
        target = prom["scrape_configs"][0]["static_configs"][0]["targets"][0]
        assert target == f"solver:{env['SGT_METRICS_PORT']}"
        assert prom["scrape_configs"][0]["metrics_path"] == "/metrics"
        assert env["SGT_METRICS_HOST"] == "0.0.0.0"
        assert {"prometheus", "grafana"} <= set(comp["services"])

    def test_dashboard_panels_query_published_metrics(self):
        """Every dashboard expr must reference a metric name the exporter
        actually publishes (publish_anneal_result / publish_rl_metrics /
        sync_from_monitor) — no dead panels."""
        import json
        import os
        import re

        repo = self._repo()
        dash = json.load(open(os.path.join(
            repo, "deployment/monitoring/grafana-dashboard.json")))
        published = {
            "spinglass_solver_flips_per_sec",
            "spinglass_solver_best_energy",
            "spinglass_solver_exchange_rate_mean",
            "spinglass_solver_runs_total",
            "spinglass_rl_env_steps_per_sec",
            "spinglass_rl_final_mean_best_energy",
            "spinglass_host_cpu_percent", "spinglass_host_mem_percent",
            "spinglass_device_bytes_in_use",
        }
        exprs = [t["expr"] for p in dash["panels"]
                 for t in p.get("targets", [])]
        assert exprs
        for expr in exprs:
            names = set(re.findall(r"spinglass_[a-z_]+", expr))
            assert names and names <= published, expr

    def test_solver_publishes_and_env_gated_server_serves(self, monkeypatch):
        """End to end in-process: SGT_METRICS_PORT starts the server, a
        solve + a PT run + publish_rl_metrics populate the gauges, and a
        scrape of /metrics sees them."""
        import urllib.request

        import numpy as np

        from spinglass_tpu.anneal.pt import PTConfig, run as pt_run
        from spinglass_tpu.anneal.sa import SAConfig, anneal
        from spinglass_tpu.core import topology
        from spinglass_tpu.core.problem import IsingProblem
        from spinglass_tpu.utils import metrics_exporter as me

        monkeypatch.setenv("SGT_METRICS_PORT", "0")  # ephemeral port
        monkeypatch.setattr(me, "_global_server", None)
        srv = me.maybe_start_server_from_env()
        assert srv is not None
        assert me.maybe_start_server_from_env() is srv  # idempotent
        try:
            p = IsingProblem.from_dense(np.asarray(topology.fully_connected(
                16, dist="binary", seed=0)))
            anneal(p, SAConfig(n_sweeps=30, n_replicas=4,
                               use_pallas="never", seed=0))
            pt_run(p, PTConfig(n_replicas=4, n_sweeps=20,
                               exchange_interval=10, use_pallas="never",
                               seed=0))
            me.publish_rl_metrics(1234.5, -3.0)
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=5
            ).read().decode()
            assert 'spinglass_solver_flips_per_sec{solver="sa"}' in body
            assert 'spinglass_solver_best_energy{solver="pt"}' in body
            assert 'spinglass_solver_exchange_rate_mean{solver="pt"}' in body
            assert "spinglass_rl_env_steps_per_sec 1234.5" in body
        finally:
            srv.stop()
            me._global_server = None
