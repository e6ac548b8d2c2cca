"""Basic usage tour (the analog of the reference's examples/basic_usage.py):
build an Ising instance, anneal it, run parallel tempering, inspect results.

Run: python examples/basic_usage.py [--platform cpu]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))

import argparse

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--platform", choices=["cpu", "gpu"], default=None)
    args = ap.parse_args()
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    from spinglass_tpu import IsingProblem, SAConfig, anneal
    from spinglass_tpu.anneal import pt
    from spinglass_tpu.anneal.schedules import ScheduleConfig, ScheduleType
    from spinglass_tpu.core import topology

    # 1. a 256-spin Sherrington-Kirkpatrick spin glass
    n = 256
    j = topology.fully_connected(n, dist="gaussian", scale=1.0 / np.sqrt(n),
                                 seed=0)
    problem = IsingProblem.from_dense(j)

    # 2. simulated annealing: 64 replicas, geometric cooling
    cfg = SAConfig(
        n_sweeps=1000, n_replicas=64,
        schedule=ScheduleConfig(ScheduleType.GEOMETRIC, initial_temp=3.0,
                                final_temp=0.01, alpha=0.995,
                                total_sweeps=1000))
    res = anneal(problem, cfg)
    print(f"SA   best energy: {res.best_energy:10.3f}  "
          f"({res.spin_flips_per_second:.2e} flips/s, {res.algorithm})")

    # 3. parallel tempering: 16-rung temperature ladder, beta swaps
    pt_res = pt.run(problem, pt.PTConfig(n_replicas=16, n_sweeps=1000,
                                         min_temp=0.1, max_temp=3.0,
                                         exchange_interval=10))
    rates = pt.exchange_rate_summary(pt_res)
    print(f"PT   best energy: {pt_res.best_energy:10.3f}  "
          f"(mean exchange rate {rates['mean_exchange_rate']:.2f})")

    # 4. persist + reload
    pt_res.save("/tmp/sgt_example_result.npz")
    from spinglass_tpu.anneal.result import AnnealResult

    loaded = AnnealResult.load("/tmp/sgt_example_result.npz")
    print(f"roundtrip energy: {loaded.best_energy:10.3f}")


if __name__ == "__main__":
    main()
