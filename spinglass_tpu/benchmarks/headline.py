"""Headline benchmark bodies shared by bench.py and ``sgt bench``.

Every body runs at its real shape on a GPU and refuses any other device: a
number measured elsewhere must never appear under these metric names. Each
result names the device it ran on.

Baseline note: the reference publishes no throughput numbers (BASELINE.md).
Its CPU sweep path does O(N) torch ops + .item() syncs per spin
(spin_dynamics.py:61-94); measured small-instance runs put it near 2e5
flips/s. BASELINE_FLIPS = 1e6 flips/s is a generous assumed-CPU-reference
figure; vs_baseline fields are speedups VS THAT ASSUMED BASELINE."""

from __future__ import annotations

import time

import numpy as np

BASELINE_FLIPS = 1.0e6

N_SPINS = 4096
N_REPLICAS = 1024
N_SWEEPS = 500
SEED = 42

SPARSE_N = 10_000
SPARSE_DEG = 6.0
SPARSE_REPLICAS = 1024   # 64 chains x 16-replica ladders in PT terms
SPARSE_SWEEPS = 2000


def require_gpu() -> dict:
    """The device these numbers are for; raises unless it is a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"headline benchmarks measure a GPU; JAX found {dev.platform!r} "
            f"({dev.device_kind}) — refusing to report its numbers")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def _time_best(run, *args, trials=3):
    import jax

    out = run(*args)
    jax.block_until_ready(out)
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        out = run(*args)
        jax.block_until_ready(out)
        best = min(best, time.perf_counter() - t0)
    return best


def bench_dense():
    """Dense blocked-sweep throughput (flips/s/chip), 4096-spin SK glass."""
    import jax
    import jax.numpy as jnp

    from spinglass_tpu.anneal.engines import make_engine
    from spinglass_tpu.core import topology
    from spinglass_tpu.core.problem import IsingProblem, random_spins

    device = require_gpu()
    n, r, sweeps = N_SPINS, N_REPLICAS, N_SWEEPS

    j = topology.fully_connected(n, dist="gaussian", scale=1.0 / np.sqrt(n),
                                 seed=SEED)
    problem = IsingProblem.from_dense(j)
    engine = make_engine(problem, sweep_method="blocked")
    key = jax.random.key(SEED)
    spins = engine.to_layout(
        random_spins(key, (r, problem.n_padded), problem.active_mask))
    beta = jnp.float32(1.0)

    # eng_ops as a traced arg keeps J out of the HLO (engines.SweepEngine
    # jit-boundary contract)
    @jax.jit
    def run(s, key, eng_ops):
        eng = engine.bind(eng_ops)

        def body(carry, k):
            s, _ = carry
            s, de, cnt = eng.sweep(s, beta, k)
            return (s, cnt), None
        (s, cnt), _ = jax.lax.scan(body, (s, jnp.zeros((r,), jnp.int32)),
                                   jax.random.split(key, sweeps))
        return s, cnt

    best = _time_best(run, spins, jax.random.key(1), engine.operands())
    flips = sweeps * r * n
    fps = flips / best
    # each sweep's local fields cost 2*N^2*R flops in the block products
    tflops = 2.0 * n * n * r * sweeps / best / 1e12
    return {
        "metric": "spin_flips_per_sec_per_chip",
        "value": fps,
        "unit": "flips/s",
        "vs_baseline": fps / BASELINE_FLIPS,
        "extras": {"device": device, "engine": engine.name,
                   "n_spins": n, "n_replicas": r, "n_sweeps": sweeps,
                   "seconds": best, "field_tflops": tflops,
                   "baseline": "assumed 1e6 flips/s CPU reference"},
    }


def bench_sparse():
    """Sorted sliced-ELL sweep throughput on 10k spins, avg degree 6."""
    import jax
    import jax.numpy as jnp

    from spinglass_tpu.anneal.engines import make_engine
    from spinglass_tpu.core import topology
    from spinglass_tpu.core.problem import random_spins
    from spinglass_tpu.kernels.sparse import EllProblem

    device = require_gpu()
    n, r, sweeps = SPARSE_N, SPARSE_REPLICAS, SPARSE_SWEEPS

    coo = topology.sparse_random_graph_coo(n, avg_degree=SPARSE_DEG,
                                           dist="gaussian", seed=SEED)
    ell = EllProblem.from_coo(n, *coo)
    engine = make_engine(ell, r_hint=r)
    key = jax.random.key(SEED)
    spins = engine.to_layout(
        random_spins(key, (r, ell.n_padded), ell.active_mask))
    beta = jnp.float32(1.0)

    @jax.jit
    def run(s, key, eng_ops):
        eng = engine.bind(eng_ops)

        def body(carry, k):
            s, _ = carry
            s, de, cnt = eng.sweep(s, beta, k)
            return (s, cnt), None
        (s, cnt), _ = jax.lax.scan(body, (s, jnp.zeros((r,), jnp.int32)),
                                   jax.random.split(key, sweeps))
        return s, cnt

    best = _time_best(run, spins, jax.random.key(1), engine.operands())
    flips = sweeps * r * n
    fps = flips / best
    return {
        "metric": "sparse_spin_flips_per_sec_per_chip",
        "value": fps,
        "unit": "flips/s",
        "vs_baseline": fps / BASELINE_FLIPS,
        "extras": {"device": device,
                   "n_spins": n, "avg_degree": SPARSE_DEG, "n_replicas": r,
                   "n_sweeps": sweeps, "seconds": best,
                   "engine": engine.name,
                   "baseline": "assumed 1e6 flips/s CPU reference"},
    }


def bench_pt10k():
    """Wall-clock of a full 10k-spin 16-replica PT run (sub-second target,
    BASELINE.md north star / reference README.md:13)."""
    from spinglass_tpu.anneal import pt as pt_mod
    from spinglass_tpu.core import topology
    from spinglass_tpu.kernels.sparse import EllProblem

    device = require_gpu()
    n, sweeps = SPARSE_N, 1000
    coo = topology.sparse_random_graph_coo(n, avg_degree=SPARSE_DEG,
                                           dist="gaussian", seed=SEED)
    ell = EllProblem.from_coo(n, *coo)
    cfg = pt_mod.PTConfig(n_replicas=16, n_sweeps=sweeps, seed=SEED)
    res = pt_mod.run(ell, cfg)             # compile
    res = pt_mod.run(ell, cfg)             # timed (cached executable)
    return {
        "metric": "pt_10k_wall_seconds",
        "value": res.total_time,
        "unit": "s",
        "vs_baseline": 1.0 / max(res.total_time, 1e-9),  # vs 1 s target
        "extras": {"device": device,
                   "n_spins": n, "n_replicas": 16, "n_sweeps": sweeps,
                   "best_energy": res.best_energy,
                   "flips_per_sec": res.spin_flips_per_second,
                   "baseline": "reference 'sub-second 10k+' claim = 1 s"},
    }


def bench_rl():
    """PPO controller training throughput (env steps/s, steady state) —
    the BASELINE.md 'PPO env-steps/s' north-star metric. The learning-
    significance proof (trained beats geometric + random, Welch-t) lives in
    tests/integration/test_rl_learns.py; this records the throughput."""
    from spinglass_tpu.core import topology
    from spinglass_tpu.core.problem import IsingProblem
    from spinglass_tpu.rl import ppo as ppo_mod
    from spinglass_tpu.rl.env import EnvConfig

    device = require_gpu()
    n, n_envs = 512, 256
    # kd updates scanned per dispatch; 512 updates = 1 warmup dispatch
    # excluded + 3 steady dispatches = the 3 windows whose MEDIAN is
    # reported (each window exactly one dispatch).
    kd, n_updates = 128, 512
    # must mirror train()'s warmup accounting: remainder singles run first
    # (each may compile) + the first scanned dispatch
    n_warm = kd + (n_updates % kd)
    j = topology.fully_connected(n, dist="gaussian", scale=1.0 / np.sqrt(n),
                                 seed=SEED)
    problem = IsingProblem.from_dense(j)
    env_cfg = EnvConfig(n_envs=n_envs, sweeps_per_step=10, max_steps=50,
                        init_temp_range=(0.1, 20.0))
    ppo_cfg = ppo_mod.PPOConfig(n_updates=n_updates, rollout_len=8,
                                hidden_sizes=(128, 128), seed=SEED,
                                updates_per_dispatch=kd)
    out = ppo_mod.train(problem, env_cfg, ppo_cfg)
    steps_per_update = ppo_cfg.rollout_len * env_cfg.n_envs
    steady = out["update_times"][n_warm:]
    n_win = 3 if len(steady) >= 6 else 1
    w = len(steady) // n_win
    # fold the division remainder into the LAST window (32 steady updates
    # must not quietly measure only 30); each window's rate normalizes by
    # its own length
    bounds = [i * w for i in range(n_win)] + [len(steady)]
    win_rates = [steps_per_update * (bounds[i + 1] - bounds[i])
                 / sum(steady[bounds[i]:bounds[i + 1]])
                 for i in range(n_win)]
    sps = sorted(win_rates)[n_win // 2]
    return {
        "metric": "ppo_env_steps_per_sec",
        "value": sps,
        "unit": "env_steps/s",
        "vs_baseline": sps * env_cfg.sweeps_per_step * n / BASELINE_FLIPS,
        "extras": {"device": device,
                   "n_spins": n, "n_envs": n_envs, "n_updates": n_updates,
                   "n_warmup_excluded": n_warm,
                   "window_rates": win_rates,
                   "mean_steady_rate": out["env_steps_per_second"],
                   "sweeps_per_env_step": env_cfg.sweeps_per_step,
                   "final_mean_best_energy": out["final_mean_best_energy"],
                   "baseline": "flips-equivalent vs assumed 1e6 flips/s "
                               "CPU reference"},
    }


PATHS = {
    "dense": bench_dense,
    "sparse": bench_sparse,
    "pt10k": bench_pt10k,
    "rl": bench_rl,
}
# bench_ttt is appended below (defined after its provenance helpers)


# --- time-to-target instance (hard mode) -----------------------------------
# Planted-gauge instance with 30% of bond signs re-flipped post-gauge: a
# genuinely frustrated 10k-spin avg-degree-6 glass (an UNfrustrated gauge
# plant is a disguised ferromagnet — 16-replica PT reached its exact ground
# energy in 10 sweeps / 27 ms, measuring nothing). The target is the
# BEST-KNOWN energy from independent deep PT runs; its full provenance
# (instance hash, deep-run configs + energies, gap calibration) is the
# committed artifact ttt_provenance.json, which bench_ttt loads and asserts
# the generated instance against. The metric: wall-clock (compile excluded
# via AOT, single device-side while_loop dispatch) for a fresh 16-replica
# PT run to reach within rel_gap of best-known — median of TTT_SEEDS runs.
TTT_PROVENANCE = "ttt_provenance.json"
TTT_SEEDS = (42, 43, 44)


def ttt_config():
    """The TTT protocol's PT configuration: 128 replicas, ladder 0.05-3.0."""
    from spinglass_tpu.anneal import pt as pt_mod

    return pt_mod.PTConfig(n_replicas=128, exchange_interval=10,
                           min_temp=0.05, max_temp=3.0, seed=SEED)


def load_ttt_instance(prov):
    """Regenerate the provenance instance and check its hash; returns
    (EllProblem, instance spec)."""
    from spinglass_tpu.benchmarks import planted
    from spinglass_tpu.kernels.sparse import EllProblem

    spec = prov["instance"]
    inst = planted.planted_gauge_coo(
        spec["n_spins"], avg_degree=spec["avg_degree"], seed=spec["seed"],
        frustration=spec["frustration"], magnitude=spec["magnitude"])
    got_hash = planted.instance_hash(inst)
    if got_hash != spec["sha256"]:
        raise RuntimeError(
            f"TTT instance hash mismatch: generated {got_hash} vs "
            f"provenance {spec['sha256']} — the generator or numpy "
            f"changed; re-establish best-known before benching")
    return EllProblem.from_coo(spec["n_spins"], inst.rows, inst.cols,
                               inst.vals), spec


def _load_ttt_provenance():
    import json
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        TTT_PROVENANCE)
    with open(path) as f:
        return json.load(f), path


def bench_ttt():
    """Time-to-target-energy on the 10k-spin frustrated planted instance
    (BASELINE.md:25-28): median wall-clock over TTT_SEEDS fresh 16-replica
    PT runs to reach within rel_gap of the best-known energy recorded in
    ttt_provenance.json (instance hash checked)."""
    from spinglass_tpu.anneal import pt as pt_mod
    from spinglass_tpu.benchmarks import planted

    device = require_gpu()
    prov, prov_path = _load_ttt_provenance()
    ell, spec = load_ttt_instance(prov)
    n, max_sweeps = spec["n_spins"], prov["max_sweeps"]
    target, rel_gap = prov["best_known_energy"], prov["rel_gap"]
    frustration = spec["frustration"]
    # Target/instance/gap fields all come from ttt_provenance.json
    cfg = ttt_config()
    out = planted.time_to_target(ell, target, cfg, rel_gap=rel_gap,
                                 max_sweeps=max_sweeps, seeds=TTT_SEEDS)
    return {
        "metric": "time_to_target_seconds",
        "value": out["seconds"],       # median-by-seconds seed
        "unit": "s",
        # vs the reference's 'sub-second for 10k+ variables' claim = 1 s
        "vs_baseline": 1.0 / max(out["seconds"], 1e-9),
        "extras": {"device": device,
                   "n_spins": n, "target_energy": out["target_energy"],
                   "best_energy": out["best_energy"], "hit": out["hit"],
                   "all_hit": out["all_hit"], "sweeps": out["sweeps"],
                   "seeds": out["seeds"], "per_seed": out["per_seed"],
                   "seconds_min": out["seconds_min"],
                   "seconds_max": out["seconds_max"],
                   "engine": out["engine"], "rel_gap": rel_gap,
                   "frustration": frustration,
                   "target_provenance": prov_path,
                   "baseline": "reference 'sub-second 10k+' claim = 1 s"},
    }


PATHS["ttt"] = bench_ttt
