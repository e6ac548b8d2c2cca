"""Native host-kernel loader: compiles kernels.cpp on first use (g++ -O3),
binds via ctypes, and falls back to numpy when no toolchain is available.

The reference's only native code was three inline CUDA strings compiled with
torch's load_inline (cuda_kernels.py:174-221, with nvcc detection and torch
fallbacks). Same architecture here for the *host* side: compile-on-demand,
cached .so, graceful numpy fallback — but targeting the encode/graph paths
(the device compute path is XLA plus the Pallas kernel in kernels/block_gpu.py)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

_SRC = os.path.join(os.path.dirname(__file__), "kernels.cpp")
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _build_dir() -> str:
    d = os.environ.get("SGT_NATIVE_CACHE",
                       os.path.join(tempfile.gettempdir(), "sgt_native"))
    os.makedirs(d, exist_ok=True)
    return d


def _compile() -> Optional[str]:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    so_path = os.path.join(_build_dir(), f"sgt_kernels_{digest}.so")
    if os.path.exists(so_path):
        return so_path
    for cxx in ("g++", "c++", "clang++"):
        try:
            subprocess.run(
                [cxx, "-O3", "-march=native", "-shared", "-fPIC", _SRC,
                 "-o", so_path + ".tmp"],
                check=True, capture_output=True, timeout=120)
            os.replace(so_path + ".tmp", so_path)
            return so_path
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired):
            continue
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    """The compiled library, or None (numpy fallbacks used)."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    so = _compile()
    if so is None:
        _load_failed = True
        return None
    lib = ctypes.CDLL(so)
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    c = ctypes.c_int64
    lib.build_ell.argtypes = [i64p, i64p, f64p, c, c, c, i32p, f32p]
    lib.build_ell.restype = c
    lib.greedy_coloring.argtypes = [i64p, i64p, c, c, i64p]
    lib.greedy_coloring.restype = c
    lib.greedy_coloring_balanced.argtypes = [i64p, i64p, c, c, i64p]
    lib.greedy_coloring_balanced.restype = c
    lib.cardinality_terms.argtypes = [i64p, i64p, f64p, f64p, c,
                                      i64p, i64p, f64p, i64p, f64p]
    lib.cardinality_terms.restype = c
    lib.at_most_one_pairs.argtypes = [i64p, i64p, c, i64p, i64p]
    lib.at_most_one_pairs.restype = c
    lib.scatter_add_symmetric.argtypes = [i64p, i64p, f64p, c, c, f64p]
    lib.scatter_add_symmetric.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------------------
# High-level wrappers with numpy fallbacks
# ---------------------------------------------------------------------------

def build_ell(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
              n_pad: int, k: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """COO (symmetric, both directions) -> (idx [Np,K] i32, val [Np,K] f32,
    max_degree)."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    idx = np.tile(np.arange(n_pad, dtype=np.int32)[:, None], (1, k))
    idx = np.ascontiguousarray(idx)
    val = np.zeros((n_pad, k), np.float32)
    lib = get_lib()
    if lib is not None:
        max_deg = int(lib.build_ell(rows, cols, vals, len(rows), n_pad, k,
                                    idx, val))
        return idx, val, max_deg
    fill = np.zeros(n_pad, np.int64)
    max_deg = 0
    for r, cc, v in zip(rows, cols, vals):
        f = fill[r]
        fill[r] += 1
        max_deg = max(max_deg, int(fill[r]))
        if f < k:
            idx[r, f] = cc
            val[r, f] = v
    return idx, val, max_deg


def greedy_coloring_csr(indptr: np.ndarray, indices: np.ndarray, n: int,
                        max_colors: int = 256,
                        balanced: bool = False) -> np.ndarray:
    """CSR-adjacency greedy coloring; raises if > max_colors needed.
    balanced=True uses the equitable-ish variant (identical output to the
    Python fallback — the 1M-node Python loop took ~70 s, the native path
    ~0.4 s)."""
    indptr = np.ascontiguousarray(indptr, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    colors = np.zeros(n, np.int64)
    lib = get_lib()
    if lib is not None:
        fn = (lib.greedy_coloring_balanced if balanced
              else lib.greedy_coloring)
        out = int(fn(indptr, indices, n, max_colors, colors))
        if out < 0:
            raise ValueError(f"graph needs >{max_colors} colors")
        return colors
    # numpy fallback: defer to the pure-python implementation
    from spinglass_tpu.core.topology import greedy_coloring as py_coloring

    j = np.zeros((n, n))
    for i in range(n):
        j[i, indices[indptr[i]:indptr[i + 1]]] = 1.0
    return py_coloring(j, max_colors=max_colors)


def cardinality_terms_batch(supports: list, ks: np.ndarray,
                            weights: np.ndarray):
    """Expand many CardinalityConstraints at once.

    supports: list of index arrays; ks: targets (k of exactly-k); weights in
    SPIN space already divided by 4 upstream if desired. Returns
    (qi, qj, qv, li, lv, const) in the core.constraints Terms convention."""
    offsets = np.zeros(len(supports) + 1, np.int64)
    for i, s in enumerate(supports):
        offsets[i + 1] = offsets[i] + len(s)
    indices = (np.concatenate([np.asarray(s, np.int64) for s in supports])
               if supports else np.zeros(0, np.int64))
    sizes = np.diff(offsets)
    targets = (2.0 * np.asarray(ks, np.float64) - sizes)
    w = np.asarray(weights, np.float64)
    n_pairs = int((sizes * (sizes - 1) // 2).sum())
    n_lin = int(sizes.sum())
    qi = np.zeros(n_pairs, np.int64)
    qj = np.zeros(n_pairs, np.int64)
    qv = np.zeros(n_pairs, np.float64)
    li = np.zeros(n_lin, np.int64)
    lv = np.zeros(n_lin, np.float64)
    lib = get_lib()
    if lib is not None and len(supports):
        lib.cardinality_terms(np.ascontiguousarray(indices), offsets,
                              np.ascontiguousarray(targets),
                              np.ascontiguousarray(w), len(supports),
                              qi, qj, qv, li, lv)
    else:
        qn = ln = 0
        for c, s in enumerate(supports):
            s = np.asarray(s, np.int64)
            m = len(s)
            li[ln:ln + m] = s
            lv[ln:ln + m] = 2.0 * w[c] * targets[c]
            ln += m
            iu, ju = np.triu_indices(m, k=1)
            np_ = len(iu)
            qi[qn:qn + np_] = s[iu]
            qj[qn:qn + np_] = s[ju]
            qv[qn:qn + np_] = -2.0 * w[c]
            qn += np_
    const = float(np.sum(w * (sizes + targets ** 2)))
    return qi, qj, qv, li, lv, const


def scatter_add_symmetric(qi, qj, qv, n: int) -> np.ndarray:
    """Dense symmetric J accumulation (fast path for np.add.at)."""
    qi = np.ascontiguousarray(qi, np.int64)
    qj = np.ascontiguousarray(qj, np.int64)
    qv = np.ascontiguousarray(qv, np.float64)
    j = np.zeros((n, n), np.float64)
    lib = get_lib()
    if lib is not None:
        lib.scatter_add_symmetric(qi, qj, qv, len(qi), n, j)
        return j
    np.add.at(j, (qi, qj), qv)
    np.add.at(j, (qj, qi), qv)
    np.fill_diagonal(j, 0.0)
    return j
