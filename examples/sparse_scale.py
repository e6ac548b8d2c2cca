"""Large sparse instances at scale: dense-free build and the sorted
sliced-ELL engines.

Covers the workflow the reference markets as "10k+ variables in
sub-second" (reference README.md:13): a 20k-spin degree-6 glass annealed
with 1024 replicas in the [N, R] sorted sliced-ELL layout, then parallel
tempering on the same instance.

Run: python examples/sparse_scale.py [--platform cpu] [--n 20000]
(off a GPU the defaults shrink to keep the demo under a minute.)
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))

import argparse
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", choices=["cpu", "gpu"], default=None)
    ap.add_argument("--n", type=int, default=0, help="spin count")
    ap.add_argument("--replicas", type=int, default=0)
    args = ap.parse_args()
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)
    import jax

    on_gpu = jax.default_backend() == "gpu"
    n = args.n or (20_000 if on_gpu else 2_000)
    r = args.replicas or (1024 if on_gpu else 128)

    from spinglass_tpu.anneal import pt
    from spinglass_tpu.anneal.sa import SAConfig, anneal
    from spinglass_tpu.core import topology
    from spinglass_tpu.kernels.sparse import EllProblem

    # Dense-free build: never materialize an [N, N] matrix for sparse
    # instances
    t0 = time.perf_counter()
    rows, cols, vals = topology.sparse_random_graph_coo(
        n, avg_degree=6.0, dist="gaussian", seed=0)
    ell = EllProblem.from_coo(n, rows, cols, vals)
    print(f"built {n}-spin avg-degree-6 instance in "
          f"{time.perf_counter() - t0:.2f}s "
          f"({len(vals)} couplings, no dense matrix)")

    # SA with a wide replica population: auto-dispatches the transposed
    # sorted engine; each history snapshot costs one host sync
    cfg = SAConfig(n_sweeps=500 if on_gpu else 100, n_replicas=r, seed=0,
                   enable_early_stop=False,
                   record_interval=250 if on_gpu else 50)
    res = anneal(ell, cfg)          # first call compiles
    res = anneal(ell, cfg)          # steady state
    print(f"SA {cfg.n_sweeps} sweeps x {r} replicas: "
          f"{res.total_time:.3f}s = {res.spin_flips_per_second/1e9:.2f} "
          f"Gflips/s (engine {res.algorithm})")
    print(f"  best energy {res.best_energy:.2f}")

    # Parallel tempering on the same instance: one device dispatch for
    # the whole run, replica-exchange statistics in the result metadata
    ptc = pt.PTConfig(n_replicas=128 if on_gpu else 8,
                      n_sweeps=500 if on_gpu else 50,
                      exchange_interval=10, seed=0)
    pt.run(ell, ptc)                # compile
    out = pt.run(ell, ptc)          # steady state (cached executable)
    rates = out.metadata["exchange_rates"]
    print(f"PT {ptc.n_replicas}-replica ladder: best {out.best_energy:.2f} "
          f"in {out.total_time:.3f}s, mean exchange rate "
          f"{float(np.mean(rates)):.2f}")


if __name__ == "__main__":
    main()
