"""Drive the system's main paths once on one GPU and check what comes out.

    python3 chip_smoke.py           # one card: dense, sparse, PT, TTT, PPO
    python3 chip_smoke.py --four    # four cards: sharded sparse PT only

Run from the root of a checkout. Every phase prints one line and any failed
check stops the script with a non-zero exit. The last line is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}. Without a
GPU, or without the package beside this file, the script fails before that
line. Problems are random instances made from fixed seeds, at the sizes the
benchmark cells use.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.realpath(__file__))

DENSE_N, DENSE_R = 4096, 1024
SPARSE_N, SPARSE_DEG, SPARSE_R = 10_000, 6.0, 1024
PT_R, PT_SWEEPS = 16, 1000
PPO_N, PPO_ENVS, PPO_UPDATES = 512, 256, 4
TTT_MAX_SWEEPS = 50_000
# Fraction of spins that may end a sweep differently from the float64
# oracle: a decision whose margin is below the field product's rounding can
# differ, and later decisions of the sweep can follow it.
ORACLE_MISMATCH_TOL = 1e-3
# Fraction of decisions in which the kernel may differ from the plain XLA
# loop under the same uniforms (both round the same f32 arithmetic; fused
# multiply-adds can move a last bit).
KERNEL_MISMATCH_TOL = 1e-4


def phase(name, **fields):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def check(ok, what):
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def card_info():
    """Name and power limit from nvidia-smi, read by a child off JAX."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (FileNotFoundError, subprocess.TimeoutExpired) as exc:
        raise SystemExit(f"FAILED: no GPU: nvidia-smi unavailable ({exc})")
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi found no GPU: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()


def import_package():
    sys.path.insert(0, HERE)
    try:
        import spinglass_tpu
    except ImportError as exc:
        raise SystemExit(f"FAILED: spinglass_tpu not importable beside "
                         f"{__file__}: {exc}")
    check(os.path.dirname(os.path.dirname(os.path.realpath(
        spinglass_tpu.__file__))) == HERE,
          f"spinglass_tpu imported from {spinglass_tpu.__file__}, not from "
          f"this checkout")


def gpu_tests():
    """The card-only test tier, in a child that exits before this process
    first touches the card (one JAX process per card)."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "pytest", os.path.join(HERE, "tests", "gpu"),
         "-m", "gpu", "-q", "-p", "no:cacheprovider", "-rs"],
        cwd=HERE, capture_output=True, text=True, timeout=900)
    tail = out.stdout.strip().splitlines()[-1:] or [""]
    phase("gpu_tests", rc=out.returncode, summary=repr(tail[0]),
          seconds=round(time.perf_counter() - t0, 1))
    check(out.returncode == 0 and "passed" in tail[0]
          and "skipped" not in tail[0],
          "pytest -m gpu:\n" + out.stdout[-3000:] + out.stderr[-2000:])


def device_info(n_expected):
    import jax

    devs = jax.devices()
    d = devs[0]
    check(d.platform == "gpu", f"JAX found no GPU (platform {d.platform!r})")
    check(len(devs) >= n_expected,
          f"need {n_expected} GPUs, JAX found {len(devs)}")
    phase("device", platform=d.platform, kind=repr(d.device_kind),
          count=len(devs))
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def sk_problem(n, seed=42):
    from spinglass_tpu.core import topology
    from spinglass_tpu.core.problem import IsingProblem

    j = topology.fully_connected(n, dist="gaussian", scale=1.0 / np.sqrt(n),
                                 seed=seed)
    return IsingProblem.from_dense(j)


def sparse_problem(seed=42):
    from spinglass_tpu.core import topology
    from spinglass_tpu.kernels.sparse import EllProblem

    coo = topology.sparse_random_graph_coo(SPARSE_N, avg_degree=SPARSE_DEG,
                                           dist="gaussian", seed=seed)
    return EllProblem.from_coo(SPARSE_N, *coo)


def dense_phase():
    import jax
    import jax.numpy as jnp

    from spinglass_tpu import SAConfig, anneal
    from spinglass_tpu.anneal.engines import BlockedEngine, make_engine
    from spinglass_tpu.core import energy as E
    from spinglass_tpu.core.problem import random_spins
    from spinglass_tpu.kernels import sweeps as K

    p = sk_problem(DENSE_N)
    engine = make_engine(p, r_hint=DENSE_R)
    check(engine.name == "blocked_gpu",
          f"dense dispatch picked {engine.name}, not the GPU kernel")
    plain = BlockedEngine(p, kernel=False)
    s0 = random_spins(jax.random.key(1), (DENSE_R, p.n_padded),
                      p.active_mask)
    u = jax.random.uniform(jax.random.key(2), s0.shape, jnp.float32)
    beta = jnp.float32(1.0)
    t0 = time.perf_counter()
    s_k, de_k, c_k = jax.jit(engine.sweep_with_uniforms)(s0, beta, u)
    jax.block_until_ready(s_k)
    t_compile = time.perf_counter() - t0
    s_x, de_x, c_x = jax.jit(plain.sweep_with_uniforms)(s0, beta, u)
    frac = float(jnp.mean(s_k != s_x))
    phase("dense_kernel_vs_plain", shape=f"{DENSE_N}x{DENSE_R}",
          frac_decisions_differ=frac, tol=KERNEL_MISMATCH_TOL,
          field_precision=K.FIELD_PRECISION,
          first_call_s=round(t_compile, 2))
    check(frac <= KERNEL_MISMATCH_TOL,
          "kernel and plain XLA sweep decided differently")

    hi = jax.lax.Precision.HIGHEST
    e0 = E.energy(p, s0, precision=hi)
    e1 = E.energy(p, s_k, precision=hi)
    ident = float(jnp.max(jnp.abs(e0 + de_k - e1)))
    ident_tol = 1e-5 * float(jnp.max(jnp.abs(e0))) + 1e-2
    phase("dense_energy_identity", max_abs_err=ident, tol=ident_tol,
          mean_acceptance=float(jnp.mean(c_k)) / DENSE_N)
    check(ident <= ident_tol, "dense E0 + dE != E1")

    jn = np.asarray(p.j, np.float64)
    hn = np.asarray(p.h, np.float64)
    s0n, s1n, un = (np.asarray(a) for a in (s0, s_k, u))
    mism = 0
    for r in range(4):
        s_or, _, _ = K.sequential_sweep_oracle(jn, hn, s0n[r], 1.0, un[r])
        mism += int(np.sum(s_or != s1n[r]))
    frac_or = mism / (4 * DENSE_N)
    phase("dense_vs_f64_oracle", replicas=4, spins_differ=mism,
          frac=frac_or, tol=ORACLE_MISMATCH_TOL)
    check(frac_or <= ORACLE_MISMATCH_TOL, "dense sweep vs float64 oracle")

    t0 = time.perf_counter()
    res = anneal(p, SAConfig(n_sweeps=20, n_replicas=DENSE_R,
                             record_interval=10, enable_early_stop=False))
    phase("anneal_dense", algorithm=res.algorithm,
          best_energy=res.best_energy, seconds=round(
              time.perf_counter() - t0, 2))
    check(np.isfinite(res.best_energy) and "blocked_gpu" in res.algorithm,
          "anneal() on the dense glass")
    e_best = float(E.energy(p, jnp.asarray(
        np.pad(res.best_spins, (0, p.n_padded - DENSE_N),
               constant_values=1.0)), precision=hi))
    check(abs(e_best - res.best_energy) <= 1e-4 * abs(e_best) + 1e-2,
          f"anneal best_energy {res.best_energy} vs recompute {e_best}")


def sparse_phase():
    import jax
    import jax.numpy as jnp

    from spinglass_tpu.anneal import pt
    from spinglass_tpu.anneal.engines import make_engine
    from spinglass_tpu.core.problem import random_spins
    from spinglass_tpu.kernels.sparse import sparse_energy

    ell = sparse_problem()
    engine = make_engine(ell, r_hint=SPARSE_R)
    s = engine.to_layout(random_spins(jax.random.key(3),
                                      (SPARSE_R, ell.n_padded),
                                      ell.active_mask))

    @jax.jit
    def run(s, key, ops):
        eng = engine.bind(ops)

        def body(s, k):
            s, de, cnt = eng.sweep(s, jnp.float32(1.0), k)
            return s, (de, cnt)
        return jax.lax.scan(body, s, jax.random.split(key, 5))

    ops = engine.operands()
    energy = jax.jit(lambda s, ops: engine.bind(ops).energy(s))
    s1, (des, cnts) = run(s, jax.random.key(4), ops)
    e0, e1 = energy(s, ops), energy(s1, ops)
    ident = float(jnp.max(jnp.abs(e0 + des.sum(0) - e1)))
    phase("sparse_energy_identity", engine=engine.name,
          shape=f"{SPARSE_N}x{SPARSE_R}", sweeps=5, max_abs_err=ident,
          tol=5e-2, mean_acceptance=float(jnp.mean(cnts[-1])) / SPARSE_N)
    check(engine.name == "sparse_sorted_t" and ident <= 5e-2,
          "sparse engine energy identity")

    cfg = pt.PTConfig(n_replicas=PT_R, n_sweeps=PT_SWEEPS, seed=42)
    pt.run(ell, cfg)                       # compile
    res = pt.run(ell, cfg)
    rates = np.asarray(res.metadata["exchange_rates"])
    e_best = float(sparse_energy(ell, jnp.asarray(np.pad(
        res.best_spins, (0, ell.n_padded - SPARSE_N),
        constant_values=1.0))[None])[0])
    phase("pt_run", n_spins=SPARSE_N, replicas=PT_R, sweeps=res.n_sweeps,
          wall_s=round(res.total_time, 4), best_energy=res.best_energy,
          recomputed=e_best, mean_exchange=round(float(rates.mean()), 4),
          min_exchange=round(float(rates.min()), 4),
          max_exchange=round(float(rates.max()), 4))
    check(0.0 < rates.mean() < 1.0 and rates.min() >= 0.0
          and rates.max() <= 1.0, "PT exchange rates outside (0, 1)")
    check(abs(e_best - res.best_energy) <= 1e-4 * abs(e_best) + 5e-2,
          "PT best energy vs recompute")


def ttt_phase():
    from spinglass_tpu.benchmarks import headline, planted

    prov, _ = headline._load_ttt_provenance()
    ell, spec = headline.load_ttt_instance(prov)     # raises on hash drift
    cfg = headline.ttt_config()
    out = planted.time_to_target(ell, prov["best_known_energy"], cfg,
                                 rel_gap=prov["rel_gap"],
                                 max_sweeps=TTT_MAX_SWEEPS, seeds=(42,))
    phase("ttt", hash_ok=True, n_spins=spec["n_spins"],
          replicas=cfg.n_replicas, engine=out["engine"],
          seconds=round(out["seconds"], 4), sweeps=out["sweeps"],
          best_energy=out["best_energy"], target=out["threshold"],
          hit=out["hit"])
    check(np.isfinite(out["best_energy"]), "TTT best energy not finite")


def ppo_phase():
    from spinglass_tpu.rl import env as env_mod
    from spinglass_tpu.rl import ppo
    from spinglass_tpu.rl.env import EnvConfig

    p = sk_problem(PPO_N)
    env_cfg = EnvConfig(n_envs=PPO_ENVS, sweeps_per_step=10, max_steps=50)
    engine = env_mod.default_engine(p, env_cfg)
    cfg = ppo.PPOConfig(n_updates=PPO_UPDATES, rollout_len=8, seed=42)
    out = ppo.train(p, env_cfg, cfg, engine=engine)
    losses = [[float(v) for k, v in h.items() if "loss" in k]
              for h in out["history"]]
    ok = bool(losses) and all(np.all(np.isfinite(l)) and l for l in losses)
    phase("ppo", n_spins=PPO_N, n_envs=PPO_ENVS, updates=len(losses),
          engine=engine.name, last_losses=losses[-1] if losses else None,
          env_steps_per_s=round(out["env_steps_per_second"], 1))
    check(ok and engine.name == "blocked_gpu", "PPO losses not finite")


def four_phase():
    """pt_sharded.run over four cards, and the sharded sweep's decisions
    against the same sweep on one card."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from spinglass_tpu.anneal.engines import make_engine
    from spinglass_tpu.anneal.pt import PTConfig
    from spinglass_tpu.core.problem import random_spins
    from spinglass_tpu.distributed import pt_sharded

    ell = sparse_problem()
    mesh = pt_sharded.make_mesh(jax.devices()[:4])
    cfg = PTConfig(n_replicas=SPARSE_R, n_sweeps=100, exchange_interval=10,
                   seed=42)
    res = pt_sharded.run(ell, cfg, mesh)
    rates = np.asarray(res.metadata["exchange_rates"])
    phase("pt_sharded", devices=4, replicas=SPARSE_R, sweeps=res.n_sweeps,
          algorithm=res.algorithm,
          wall_s_incl_compile=round(res.total_time, 2),
          best_energy=res.best_energy,
          mean_exchange=round(float(rates.mean()), 4))
    check(np.isfinite(res.best_energy) and 0.0 < rates.mean() < 1.0,
          "sharded PT run")

    engine = make_engine(ell, r_hint=SPARSE_R)
    s = engine.to_layout(random_spins(jax.random.key(5),
                                      (SPARSE_R, ell.n_padded),
                                      ell.active_mask))
    u = jax.random.uniform(jax.random.key(6), s.shape, jnp.float32)
    beta = jnp.asarray(np.geomspace(0.1, 3.0, SPARSE_R), jnp.float32)
    one = jax.jit(engine.sweep_with_uniforms)(s, beta, u)
    rep = NamedSharding(mesh, P(None, "replica"))
    many = jax.jit(engine.sweep_with_uniforms)(
        jax.device_put(s, rep),
        jax.device_put(beta, NamedSharding(mesh, P("replica"))),
        jax.device_put(u, rep))
    same = bool(jnp.all(one[0] == many[0])) and bool(
        jnp.all(one[2] == many[2]))
    phase("sharded_vs_one_card", decisions_identical=same,
          spins_sharding=str(many[0].sharding.spec))
    check(same, "sharded sweep decided differently from one card")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded PT path")
    args = ap.parse_args()
    t_start = time.perf_counter()
    for line in card_info():
        print(line, flush=True)             # name, power limit
    import_package()
    if not args.four:
        gpu_tests()
    device = device_info(4 if args.four else 1)
    from spinglass_tpu.utils.cache import enable_persistent_compile_cache

    phase("compile_cache", dir=enable_persistent_compile_cache())
    phases = [four_phase] if args.four else [dense_phase, sparse_phase,
                                             ttt_phase, ppo_phase]
    for fn in phases:
        t0 = time.perf_counter()
        fn()
        phase(fn.__name__, seconds=round(time.perf_counter() - t0, 1))
    phase("total", seconds=round(time.perf_counter() - t_start, 1))
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
