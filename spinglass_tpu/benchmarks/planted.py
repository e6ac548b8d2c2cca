"""Planted-ground-state instances + time-to-target-energy measurement.

BASELINE.md:25-28 names *time-to-target-energy* on 10k-spin parallel
tempering as a north-star metric, but the reference publishes no energies to
target (BASELINE.md: "no rigorous published benchmark numbers"). Planted
instances solve this self-containedly: generate an instance whose ground
state and ground energy are KNOWN by construction, then measure wall-clock
until the solver reaches it.

Construction (gauge planting): draw a random connected graph with positive
coupling magnitudes |J_ij| and a random planted state s* in {-1,+1}^N, and
set J_ij = |J_ij| * s*_i * s*_j. Every bond is satisfied at s = s*
(J_ij s*_i s*_j = |J_ij| > 0), so s* is a ground state with
E0 = -sum_{i<j} |J_ij|, exactly — on any topology, at any size, with no
transfer-matrix machinery. The gauge is invisible to the solver: local
fields are zero and the signed couplings look like a random spin glass
(it IS one — a gauge transform of a ferromagnet).

``frustration`` > 0 plants an *approximate* target instead: that fraction of
bonds get their sign flipped post-gauge, making the instance genuinely
frustrated. The recorded e0 is then the planted state's energy — an upper
bound on the true ground energy, still a well-defined target for
time-to-target runs (the solver may go below it).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class PlantedInstance:
    rows: np.ndarray
    cols: np.ndarray
    vals: np.ndarray
    s_star: np.ndarray          # planted state [N]
    e0: float                   # its energy (exact ground energy when
    # frustration == 0)
    n_spins: int
    frustration: float


def planted_gauge_coo(n_spins: int, avg_degree: float = 6.0, seed: int = 0,
                      frustration: float = 0.0,
                      magnitude: str = "uniform") -> PlantedInstance:
    """Symmetric COO (both directions) planted instance.

    magnitude: "uniform" |J| ~ U(0.5, 1.5) (gap to first excitation stays
    macroscopic) or "ones" |J| = 1 (±J gauge glass).
    """
    rng = np.random.default_rng(seed)
    m = int(n_spins * avg_degree / 2)
    # random graph: m distinct edges, no self loops (connectivity with a
    # chain backbone so no free-floating spins)
    backbone = np.stack([np.arange(n_spins - 1), np.arange(1, n_spins)], 1)
    extra = rng.integers(0, n_spins, size=(m, 2))
    extra = extra[extra[:, 0] != extra[:, 1]]
    edges = np.concatenate([backbone, extra])
    edges = np.unique(np.sort(edges, axis=1), axis=0)

    if magnitude == "uniform":
        mag = rng.uniform(0.5, 1.5, size=len(edges))
    elif magnitude == "ones":
        mag = np.ones(len(edges))
    else:
        raise ValueError(magnitude)

    s_star = rng.choice([-1.0, 1.0], size=n_spins)
    vals = mag * s_star[edges[:, 0]] * s_star[edges[:, 1]]
    if frustration > 0:
        flip = rng.random(len(edges)) < frustration
        vals = np.where(flip, -vals, vals)
    # E(s*) = -sum_bonds J_ij s*_i s*_j
    e0 = float(-np.sum(vals * s_star[edges[:, 0]] * s_star[edges[:, 1]]))

    rows = np.concatenate([edges[:, 0], edges[:, 1]])
    cols = np.concatenate([edges[:, 1], edges[:, 0]])
    vals2 = np.concatenate([vals, vals])
    return PlantedInstance(rows=rows, cols=cols, vals=vals2,
                           s_star=s_star, e0=e0, n_spins=n_spins,
                           frustration=frustration)


def instance_hash(inst: PlantedInstance) -> str:
    """Content hash of a planted instance (for provenance files): sha256
    over rows.astype(int64) + cols.astype(int64) + vals.astype(float64)
    bytes. Ties a recorded best-known energy to the exact instance."""
    import hashlib

    h = hashlib.sha256()
    h.update(np.ascontiguousarray(inst.rows.astype(np.int64)).tobytes())
    h.update(np.ascontiguousarray(inst.cols.astype(np.int64)).tobytes())
    h.update(np.ascontiguousarray(inst.vals.astype(np.float64)).tobytes())
    return h.hexdigest()


def time_to_target(problem, target_energy: float, cfg=None,
                   rel_gap: float = 1e-3, max_sweeps: int = 20000,
                   chunk_super_steps: int = 5, key=None,
                   warm: bool = True, seeds=None) -> dict:
    """Wall-clock until PT's best energy reaches target*(1 - rel_gap)
    ... i.e. best <= target + rel_gap*|target| (energies are negative).

    The whole solve is ONE device-side ``lax.while_loop`` over super-steps
    with the target check inside jit — a single dispatch, with no host sync
    between super-steps.

    ``warm=True`` AOT-compiles the solve (``jit(...).lower(...).compile()``)
    so the reported time excludes XLA compilation WITHOUT executing the
    up-to-max_sweeps solve an extra throwaway time.

    ``seeds``: optional sequence of ints. When given, the SAME compiled
    executable runs once per seed (fresh init_state each), and the result
    reports the median-by-seconds run at the top level plus all per-seed
    runs under "per_seed" — one-seed TTT numbers are flaky. When None, a
    single run with ``key``.

    ``chunk_super_steps`` is kept for API compatibility but unused.
    Returns seconds, sweeps used, and whether the target was hit within
    max_sweeps."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from spinglass_tpu.anneal import pt as pt_mod
    from spinglass_tpu.anneal.jit_cache import pt_cache

    cfg = cfg or pt_mod.PTConfig(n_replicas=16, exchange_interval=10,
                                 min_temp=0.1, max_temp=5.0)
    threshold = target_energy + rel_gap * abs(target_energy)
    max_super = max(1, max_sweeps // cfg.exchange_interval)

    def _build():
        super_step, _, engine = pt_mod.make_pt_step(problem, cfg)

        # prob/eng_ops as traced args (engines.SweepEngine jit-boundary
        # contract): keeps the instance arrays out of the compiled HLO
        def solve(state, prob, eng_ops):
            def cond(carry):
                _, n_super, best = carry
                return (best > threshold) & (n_super < max_super)

            def body(carry):
                st, n_super, best = carry
                st, stats = super_step(st, None, eng_ops=eng_ops, prob=prob)
                return (st, n_super + 1,
                        jnp.minimum(best, stats["best_energy"]))

            _, n_super, best = lax.while_loop(
                cond, body, (state, jnp.int32(0), jnp.float32(jnp.inf)))
            return n_super, best

        return {"step": super_step, "engine": engine,
                "solve": jax.jit(solve), "compiled": None}

    # repeated solves of one problem object reuse the built step, its
    # jitted init and the compiled solve (anneal.jit_cache)
    built = pt_cache().get_or_build(
        problem, ("ttt", cfg, threshold, max_super), _build)
    super_step, engine = built["step"], built["engine"]
    if seeds is not None:
        keys = [jax.random.key(int(s)) for s in seeds]
    else:
        keys = [key if key is not None else jax.random.key(cfg.seed)]
    eng_ops = super_step.operands_for_step()
    states = [super_step.init(k, problem, eng_ops) for k in keys]

    solve_fn = built["solve"]
    if warm:
        # AOT compile: lowers + compiles the executable without running the
        # up-to-max_sweeps solve (all states share one shape/dtype struct)
        if built["compiled"] is None:
            built["compiled"] = solve_fn.lower(states[0], problem,
                                               eng_ops).compile()
        solve_fn = built["compiled"]

    runs = []
    for st0 in states:
        t0 = time.perf_counter()
        n_super, best_d = solve_fn(st0, problem, eng_ops)
        jax.block_until_ready(best_d)
        elapsed = time.perf_counter() - t0
        best = float(best_d)
        runs.append({
            "seconds": elapsed,
            "sweeps": int(n_super) * cfg.exchange_interval,
            "best_energy": best,
            "hit": best <= threshold,
        })

    med = sorted(runs, key=lambda r: r["seconds"])[len(runs) // 2]
    out = {
        **med,
        "target_energy": target_energy,
        "threshold": threshold,
        "n_replicas": cfg.n_replicas,
        "engine": engine.name,
    }
    if seeds is not None:
        out["seeds"] = [int(s) for s in seeds]
        out["per_seed"] = runs
        out["seconds_min"] = min(r["seconds"] for r in runs)
        out["seconds_max"] = max(r["seconds"] for r in runs)
        out["all_hit"] = all(r["hit"] for r in runs)
    return out
