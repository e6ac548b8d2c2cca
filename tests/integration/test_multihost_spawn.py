"""Two-process jax.distributed dryrun (BASELINE.md:29).

Spawns two REAL processes that jax.distributed.initialize over localhost and
run sharded PT on a replica mesh spanning both processes' devices — the
actual multi-host code path (multihost.initialize + pt_sharded), not the
reference's in-process thread simulation (SURVEY §4 'how multi-node is
tested without a cluster: it isn't')."""

import json
import os
import socket
import subprocess
import sys

import pytest

pytestmark = [pytest.mark.integration, pytest.mark.slow]

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sharded_pt(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    env["JAX_PLATFORMS"] = "cpu"
    procs = [
        subprocess.Popen(
            [sys.executable, "-m",
             "spinglass_tpu.distributed._multihost_worker",
             str(i), "2", str(port), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            cwd=REPO)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("two-process spawn timed out on this machine")

    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out[-2000:]}"

    reports = []
    for i in range(2):
        path = tmp_path / f"proc{i}.json"
        assert path.exists(), outs[i][-2000:]
        reports.append(json.loads(path.read_text()))

    for r in reports:
        # the mesh really spanned both processes: 2 procs x 2 devices
        assert r["process_count"] == 2
        assert r["global_devices"] == 4
        assert r["local_devices"] == 2
        assert r["n_replicas"] == 8
        assert r["finite"]
    # SPMD: both processes executed the same global program and agree on
    # the global best energy
    assert reports[0]["best_energy"] == pytest.approx(
        reports[1]["best_energy"], rel=1e-6)
