"""Cross-call solver-executable cache.

The SA/PT drivers build their engines + jitted step functions inside run()/
anneal(); without caching, every call re-traces and re-compiles even for the
same problem object and config.

Entries are keyed by (id(problem), config, ...) by default. The cache holds
a strong reference to the problem object so its id cannot be recycled while
the entry lives; an LRU bound caps the held memory.

Since round 5, callers may pass ``signature`` — a hashable trace signature
(shape/dtype/static-layout) — and same-signature problems SHARE the entry:
post ADR-0004 every array crosses the jit boundary as an argument, so the
compiled trace is content-independent and only the per-problem operands
differ (the drivers rebuild those on a cross-object hit). This turns
"solve 100 same-shape instances" from 100 compiles into 1. Dense
IsingProblem provides ``trace_signature()``; sparse EllProblem does NOT
(its degree-bucket/coloring layout is content-derived static metadata, so
equal shapes can still produce different programs) and keeps id-keying.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Hashable, Tuple


class SolverCache:
    def __init__(self, max_entries: int = 8):
        self.max_entries = max_entries
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get_or_build(self, problem: Any, key: Hashable,
                     builder: Callable[[], Any],
                     signature: Hashable = None) -> Any:
        """``signature`` None -> key by object identity (problem pinned so
        its id can't recycle). Non-None -> key by the signature; distinct
        same-signature problems share the entry (see module docstring)."""
        if signature is not None:
            full_key, pin = ("sig", signature, key), None
        else:
            full_key, pin = ("id", id(problem), key), problem
        with self._lock:
            if full_key in self._d:
                self._d.move_to_end(full_key)
                self.hits += 1
                return self._d[full_key][0]
        # build OUTSIDE the lock (compiles can take minutes)
        value = builder()
        with self._lock:
            self.misses += 1
            self._d[full_key] = (value, pin)  # pin holds id-mode problems
            while len(self._d) > self.max_entries:
                self._d.popitem(last=False)
        return value

    def clear(self) -> None:
        with self._lock:
            self._d.clear()


_pt_cache = SolverCache()
_sa_cache = SolverCache()


def pt_cache() -> SolverCache:
    return _pt_cache


def sa_cache() -> SolverCache:
    return _sa_cache
