"""CLI + benchmark-runner integration tests (reference CLI tests idea)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from click.testing import CliRunner

from spinglass_tpu.cli import main


@pytest.fixture
def runner():
    return CliRunner()


class TestCLI:
    def test_solve_tsp(self, runner, tmp_path):
        out_path = str(tmp_path / "sol.json")
        result = runner.invoke(main, [
            "solve", "-p", "tsp", "-s", "5", "--sweeps", "200",
            "--replicas", "8", "-o", out_path])
        assert result.exit_code == 0, result.output
        assert "objective:" in result.output
        sol = json.loads(open(out_path).read())
        assert sorted(sol["variables"]["tour"]) == [0, 1, 2, 3, 4]

    def test_solve_unknown_problem(self, runner):
        result = runner.invoke(main, ["solve", "-p", "nope"])
        assert result.exit_code != 0
        assert "unknown problem" in result.output

    def test_ising_command(self, runner, tmp_path):
        out_path = str(tmp_path / "res.npz")
        result = runner.invoke(main, [
            "ising", "-n", "16", "--topology", "chain", "--sweeps", "100",
            "--replicas", "4", "-o", out_path])
        assert result.exit_code == 0, result.output
        assert "best energy:" in result.output
        assert os.path.exists(out_path)

    def test_load_command(self, runner, tmp_path):
        out_path = str(tmp_path / "res.npz")
        runner.invoke(main, ["ising", "-n", "12", "--sweeps", "50",
                             "--replicas", "4", "-o", out_path])
        result = runner.invoke(main, ["load", out_path])
        assert result.exit_code == 0
        parsed = json.loads(result.output)
        assert "best_energy" in parsed

    def test_health_command(self, runner):
        result = runner.invoke(main, ["health"])
        assert result.exit_code == 0, result.output
        rep = json.loads(result.output)
        assert rep["status"] in ("healthy", "degraded")

    @pytest.mark.slow
    def test_benchmark_command(self, runner, tmp_path):
        out_path = str(tmp_path / "bench.json")
        result = runner.invoke(main, [
            "benchmark", "--sizes", "10", "--sweeps", "50", "--trials", "1",
            "-o", out_path])
        assert result.exit_code == 0, result.output
        data = json.loads(open(out_path).read())
        assert data["results"]


class TestBenchmarkRunner:
    def test_runner_one_case(self):
        from spinglass_tpu.benchmarks.runner import (BenchmarkCase,
                                                     BenchmarkRunner)
        from spinglass_tpu.problems import MaxCutProblem

        def mk():
            p = MaxCutProblem()
            p.generate_random_instance(n_nodes=10, seed=0)
            return p

        runner = BenchmarkRunner(n_sweeps=50, n_replicas=8, n_trials=2,
                                 use_pallas="never")
        results = runner.run_case(BenchmarkCase("mc10", mk, 10, "maxcut"),
                                  algorithms=("sa",))
        assert len(results) == 2
        assert all(np.isfinite(r.best_energy) for r in results)
        summary = runner.summary()
        assert "maxcut/sa" in summary
        assert summary["maxcut/sa"]["n"] == 2


class TestQualityGates:
    def test_run_all_gates_pass(self):
        from spinglass_tpu.benchmarks.quality_gates import run_quality_gates

        rep = run_quality_gates()
        assert rep["summary"]["failed"] == 0, rep["gates"]

    def test_cli_quality_gates(self, runner, tmp_path):
        import json
        import os

        from spinglass_tpu.cli import main

        out = os.path.join(tmp_path, "qg.json")
        r = runner.invoke(main, ["quality-gates", "-o", out,
                                 "--gates", "imports,security,determinism"])
        assert r.exit_code == 0, r.output
        rep = json.load(open(out))
        assert rep["summary"]["total"] == 3


class TestBenchScript:
    """bench.py: one process, compact last line; and the headline bodies'
    refusal to report numbers measured on anything but a GPU."""

    def _bench_mod(self):
        import importlib.util

        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        spec = importlib.util.spec_from_file_location(
            "bench", os.path.join(repo, "bench.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def test_compact_line_is_small(self):
        b = self._bench_mod()
        result = {"metric": "m", "value": 1.0, "unit": "u",
                  "vs_baseline": 2.0,
                  "extras": {"pt10k": {"value": 0.5, "x": list(range(999))},
                             "ttt": {"error": "E" * 5000},
                             "n_spins": 4096}}
        out = b._compact(result)
        assert out["paths"]["pt10k"] == 0.5
        assert len(out["paths"]["ttt"]["error"]) == 80
        assert len(json.dumps(out)) < 1000

    def test_bench_refuses_cpu(self):
        """Run as a script on the CPU it exits non-zero and prints no
        result line."""
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        proc = subprocess.run([sys.executable, "bench.py", "--pt10k"],
                              cwd=repo, env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode != 0
        assert "refusing" in proc.stderr
        assert not [l for l in proc.stdout.splitlines()
                    if l.startswith("{")]

    @pytest.mark.parametrize("path", ["dense", "sparse", "pt10k", "rl",
                                      "ttt"])
    def test_headline_bodies_refuse_cpu(self, path):
        from spinglass_tpu.benchmarks import headline

        with pytest.raises(RuntimeError, match="refusing"):
            headline.PATHS[path]()


class TestBenchCommand:
    def test_sgt_bench_pt10k(self, runner, monkeypatch):
        """`sgt bench` exposes the headline bodies to installed-package
        users (repo-root bench.py is not shipped). Off a GPU it fails and
        prints no number. JAX_COMPILATION_CACHE_DIR keeps the command from
        flipping jax_compilation_cache_dir for the rest of this process."""
        from spinglass_tpu.cli import main as cli_main

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/nonexistent")
        res = runner.invoke(cli_main, ["bench", "--path", "pt10k"])
        assert res.exit_code != 0
        assert "refusing" in str(res.exception)
        assert not [l for l in res.output.splitlines()
                    if l.startswith("{")]
