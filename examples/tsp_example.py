"""TSP via QUBO annealing (the analog of the reference's examples/tsp usage).

Run: python examples/tsp_example.py [--cities 12] [--platform cpu]
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.join(_os.path.dirname(__file__), ".."))

import argparse


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cities", type=int, default=12)
    ap.add_argument("--platform", choices=["cpu", "gpu"], default=None)
    args = ap.parse_args()
    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    from spinglass_tpu.anneal.sa import SAConfig
    from spinglass_tpu.anneal.schedules import ScheduleConfig
    from spinglass_tpu.problems import TSPProblem

    tsp = TSPProblem()
    tsp.generate_random_instance(n_cities=args.cities, seed=7)
    sol = tsp.solve(SAConfig(
        n_sweeps=2000, n_replicas=64,
        schedule=ScheduleConfig(initial_temp=10.0, final_temp=0.01,
                                alpha=0.996, total_sweeps=2000)))
    print(f"cities:       {args.cities}")
    print(f"tour:         {sol.variables['tour'].tolist()}")
    print(f"tour length:  {sol.objective_value:.2f}")
    print(f"clean decode: {sol.metadata['clean_decode']}")
    print(f"solve time:   {sol.metadata['solve_time']:.1f}s "
          f"({sol.metadata['anneal']['algorithm']})")


if __name__ == "__main__":
    main()
