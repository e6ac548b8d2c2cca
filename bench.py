"""Headline benchmark: spin-flips/sec on spin-glass annealing, on a GPU.

Default (--all, implicit): the dense blocked-sweep headline with the
pt10k / time-to-target / sparse / RL paths in extras, all in this one
process. Individual flags run one path. Each path's failure is recorded in
the result and the remaining paths still run; a run on a machine without a
GPU fails (see benchmarks.headline.require_gpu).

Benchmark bodies live in spinglass_tpu.benchmarks.headline (shared with
``sgt bench``). The last stdout line is a COMPACT JSON summary (< 1 KB) with
one number per path:

    {"metric": "...", "value": ..., "unit": "...", "vs_baseline": ...,
     "paths": {"pt10k": 0.33, "sparse": 1.01e10, ...},
     "detail": "BENCH_detail.json"}

The full nested extras go to BENCH_detail.json.

Baseline: the reference has no published throughput numbers (BASELINE.md);
vs_baseline for throughput metrics is the multiple of an ASSUMED 1e6
flips/s CPU reference (label it as such when quoting), and for wall-clock
metrics the multiple vs the reference's "sub-second for 10k+ variables"
claim read as 1 s.
"""

import argparse
import json
import os

DETAIL_PATH = os.path.join(
    os.path.dirname(os.path.abspath(globals().get("__file__", "bench.py"))),
    "BENCH_detail.json")


def _compact(result: dict) -> dict:
    """Numbers-only summary of the combined result, guaranteed small:
    metric/value/unit/vs_baseline plus one number (or a short error string)
    per secondary path, hard-capped under 1 KB. The full nested extras go
    to BENCH_detail.json instead."""
    paths = {}
    for name, sub in result.get("extras", {}).items():
        if not isinstance(sub, dict):
            if name == "error":  # dense-path failure is a bare string
                paths["dense"] = {"error": str(sub)[:80]}
            continue
        if "error" in sub:
            paths[name] = {"error": str(sub["error"])[:80]}
        elif "value" in sub:
            paths[name] = round(float(sub["value"]), 6)
    out = {"metric": result["metric"], "value": result["value"],
           "unit": result["unit"], "vs_baseline": result["vs_baseline"],
           "paths": paths, "detail": os.path.basename(DETAIL_PATH)}
    line = json.dumps(out)
    if len(line) > 1000:  # drop error texts, then paths
        out["paths"] = {k: (v if not isinstance(v, dict) else "error")
                        for k, v in paths.items()}
        if len(json.dumps(out)) > 1000:
            out["paths"] = "overflow: see detail file"
    return out


def _run_all(headline) -> dict:
    """Dense headline + pt10k/sparse/rl/ttt in extras, one process."""
    try:
        result = headline.bench_dense()
    except Exception as exc:  # keep going; later paths still run
        result = {"metric": "spin_flips_per_sec_per_chip", "value": 0.0,
                  "unit": "flips/s", "vs_baseline": 0.0,
                  "extras": {"error": f"{type(exc).__name__}: {exc}"[:500]}}
    for name in ("pt10k", "sparse", "rl", "ttt"):
        try:
            sub = headline.PATHS[name]()
            entry = {k: sub[k] for k in ("metric", "value", "unit")}
            entry.update(sub.get("extras", {}))
        except Exception as exc:
            entry = {"error": f"{type(exc).__name__}: {exc}"[:500]}
        result["extras"][name] = entry
    return result


def main():
    ap = argparse.ArgumentParser()
    for name, doc in (("dense", "dense sweep throughput"),
                      ("sparse", "sparse ELL throughput"),
                      ("pt10k", "full 10k-spin PT wall-clock"),
                      ("rl", "PPO controller env-steps/s"),
                      ("ttt", "time-to-target on the planted 10k instance")):
        ap.add_argument(f"--{name}", action="store_true", help=doc + " only")
    ap.add_argument("--all", action="store_true",
                    help="(default) dense headline with the others in extras")
    args = ap.parse_args()

    from spinglass_tpu.benchmarks import headline
    from spinglass_tpu.utils.cache import enable_persistent_compile_cache

    enable_persistent_compile_cache()
    headline.require_gpu()
    for name in ("dense", "sparse", "pt10k", "rl", "ttt"):
        if getattr(args, name):
            print(json.dumps(headline.PATHS[name]()))
            return
    result = _run_all(headline)
    with open(DETAIL_PATH, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(_compact(result)), flush=True)


if __name__ == "__main__":
    main()
