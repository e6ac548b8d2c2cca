"""Profiling: per-phase timers + jax.profiler trace hooks.

Rebuilds utils/performance.py:386-543 (PerformanceProfiler + @profile) with
one addition: device traces via jax.profiler for offline analysis
in XProf/TensorBoard (SURVEY §5 'tracing/profiling')."""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Optional

import numpy as np


class PerformanceProfiler:
    def __init__(self):
        self.records: dict[str, list] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.records.setdefault(name, []).append(
                time.perf_counter() - t0)

    def profile(self, fn=None, *, name: Optional[str] = None):
        """Decorator form (reference @profile, utils/performance.py:671)."""
        def deco(f):
            label = name or f.__qualname__

            @functools.wraps(f)
            def wrapper(*args, **kwargs):
                with self.phase(label):
                    return f(*args, **kwargs)

            return wrapper

        return deco(fn) if fn is not None else deco

    def summary(self) -> dict:
        return {
            k: {"n": len(v), "total_s": float(np.sum(v)),
                "mean_s": float(np.mean(v)),
                "p50_s": float(np.percentile(v, 50)),
                "max_s": float(np.max(v))}
            for k, v in self.records.items()
        }

    def reset(self) -> None:
        self.records.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace context — view with xprof/tensorboard."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


global_profiler = PerformanceProfiler()
