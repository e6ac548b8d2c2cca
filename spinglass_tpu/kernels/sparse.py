"""Sparse (ELL / padded-neighbor-list) sweep engine for large sparse instances.

SURVEY §7 hard part 2: for 10k+ spins with sparse J the dense [N, N] matmul
wastes O(N^2) HBM traffic on zeros. The ELL layout stores, per spin, a fixed
K = max-degree list of (neighbor index, coupling value), padded with
self-loops of value 0; local fields become a gather + K-reduction

    f[r, i] = sum_k val[i, k] * s[r, idx[i, k]] + h[i]

which XLA lowers to vectorized dynamic gathers. Sweeps are colored
(greedy coloring of a sparse graph needs <= max_degree + 1 colors), giving
exact Metropolis with C sparse-field passes per sweep — O(C * R * N * K)
work instead of the dense O(C * R * N^2)."""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from spinglass_tpu.core import pytree
from spinglass_tpu.core import topology
from spinglass_tpu.core.problem import IsingProblem, round_up
from spinglass_tpu.kernels.sweeps import (accept_threshold,
                                          color_masks_from_colors)


@pytree.dataclass
class EllProblem:
    """ELL-format sparse Ising problem pytree.

    idx [Np, K] int32 neighbor indices (self-index on padding slots),
    val [Np, K] coupling values (0 on padding), h [Np], active_mask [Np]."""

    idx: jax.Array
    val: jax.Array
    h: jax.Array
    active_mask: jax.Array
    n_spins: int = pytree.static_field()

    @property
    def n_padded(self) -> int:
        return self.idx.shape[0]

    @property
    def max_degree(self) -> int:
        return self.idx.shape[1]

    @staticmethod
    def from_coo(n_spins: int, rows, cols, vals, h=None,
                 max_degree: Optional[int] = None) -> "EllProblem":
        """Dense-free constructor from symmetric COO (both directions
        present) — THE path for 10k+ sparse instances (no [N, N] matrix is
        ever materialized)."""
        from spinglass_tpu import native

        n_pad = round_up(n_spins)
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, np.float64)
        degs = np.bincount(rows, minlength=n_pad)
        k = int(max_degree or max(int(degs.max()), 1))
        idx, val, _ = native.build_ell(rows, cols, vals, n_pad, k)
        if h is None:
            h_full = np.zeros(n_pad, np.float32)
        else:
            h_full = np.zeros(n_pad, np.float32)
            h_full[:n_spins] = np.asarray(h, np.float32)
        mask = np.zeros(n_pad, np.float32)
        mask[:n_spins] = 1.0
        return EllProblem(idx=jnp.asarray(idx), val=jnp.asarray(val),
                          h=jnp.asarray(h_full),
                          active_mask=jnp.asarray(mask), n_spins=n_spins)

    @staticmethod
    def from_problem(problem: IsingProblem,
                     max_degree: Optional[int] = None) -> "EllProblem":
        """Convert a dense IsingProblem (host-side, once per problem).
        Uses the native C++ COO->ELL builder when available."""
        from spinglass_tpu import native

        n = problem.n_spins
        n_pad = problem.n_padded
        j = np.asarray(problem.j)[:n, :n]
        degs = (j != 0).sum(axis=1)
        k = int(max_degree or max(int(degs.max()), 1))
        rows, cols = np.nonzero(j)
        idx, val, _ = native.build_ell(rows, cols, j[rows, cols], n_pad, k)
        return EllProblem(
            idx=jnp.asarray(idx),
            val=jnp.asarray(val),
            h=problem.h,
            active_mask=problem.active_mask,
            n_spins=n,
        )


def ell_from_terms(n_spins: int, terms, max_degree: Optional[int] = None
                   ) -> EllProblem:
    """Compile core.constraints.Terms straight into an EllProblem — the
    dense-free encode path for constraint-heavy problems (e.g. large
    scheduling QUBOs whose dense J would not fit memory). Duplicate (i, j)
    term entries are kept as separate ELL slots; the gather-reduce sums them,
    so fields/energies match the dense scatter-add exactly."""
    qi = np.asarray(terms.quad_i, np.int64)
    qj = np.asarray(terms.quad_j, np.int64)
    qv = np.asarray(terms.quad_v, np.float64)
    rows = np.concatenate([qi, qj])
    cols = np.concatenate([qj, qi])
    vals = np.concatenate([qv, qv])
    h = np.zeros(n_spins, np.float64)
    if len(terms.lin_i):
        np.add.at(h, np.asarray(terms.lin_i, np.int64),
                  np.asarray(terms.lin_v, np.float64))
    return EllProblem.from_coo(n_spins, rows, cols, vals, h,
                               max_degree=max_degree)


def neighbor_sum(gathered: jax.Array, val: jax.Array, axis: int) -> jax.Array:
    """sum_k val * gathered over the neighbor axis, in f32.

    A multiply and a reduction, not a dot: the products are exact (spins are
    +-1) and the sum is plain f32, as under ``Precision.HIGHEST``, but XLA
    fuses it with the gather instead of emitting one small batched GEMM per
    degree bucket, each of which the GPU compiler autotunes separately.
    ``val`` broadcasts against ``gathered`` with the spin axis inserted."""
    return jnp.sum(gathered.astype(jnp.float32) * val.astype(jnp.float32),
                   axis=axis)


def rows_field(s_t: jax.Array, idx: jax.Array, val: jax.Array) -> jax.Array:
    """[NS, R] spins, [m, k] neighbor rows and couplings -> [m, R] f32
    fields sum_k val[:, k] * s_t[idx[:, k]]."""
    return neighbor_sum(s_t[idx], val[:, :, None], axis=1)


def sparse_local_fields(ell: EllProblem, spins: jax.Array) -> jax.Array:
    """[R, Np] -> [R, Np]: gather neighbors, multiply, reduce K."""
    gathered = spins[:, ell.idx]                   # [R, Np, K]
    f = neighbor_sum(gathered, ell.val[None], axis=-1)
    return f + ell.h.astype(jnp.float32)[None, :]


def sparse_energy(ell: EllProblem, spins: jax.Array) -> jax.Array:
    """E = -1/2 s.f_J - h.s  (f_J excludes h)."""
    f_j = sparse_local_fields(ell, spins) - ell.h.astype(jnp.float32)[None, :]
    s32 = spins.astype(jnp.float32)
    return (-0.5 * jnp.sum(s32 * f_j, axis=-1)
            - jnp.sum(s32 * ell.h.astype(jnp.float32)[None, :], axis=-1))


@functools.partial(jax.jit, static_argnames=("rule",))
def sparse_colored_sweep(
    ell: EllProblem,
    color_masks: jax.Array,   # [C, Np]
    spins: jax.Array,         # [R, Np]
    beta: jax.Array,
    uniforms: jax.Array,      # [R, Np]
    rule: str = "metropolis",
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """One exact colored sweep with sparse fields."""
    r = spins.shape[0]
    beta = jnp.broadcast_to(jnp.asarray(beta, jnp.float32), (r,))
    active = ell.active_mask > 0

    th = accept_threshold(uniforms, beta[:, None], rule)

    def body(carry, mask):
        spins, de_acc, cnt = carry
        f = sparse_local_fields(ell, spins)
        sf = spins.astype(jnp.float32) * f
        acc = (sf < th) & (mask > 0)[None, :] & active[None, :]
        spins = jnp.where(acc, -spins, spins)
        de_acc = de_acc + 2.0 * jnp.sum(jnp.where(acc, sf, 0.0), axis=-1)
        cnt = cnt + jnp.sum(acc, axis=-1).astype(jnp.int32)
        return (spins, de_acc, cnt), None

    init = (spins, jnp.zeros((r,), jnp.float32), jnp.zeros((r,), jnp.int32))
    (spins, de_acc, cnt), _ = lax.scan(body, init, color_masks)
    return spins, de_acc, cnt


# ---------------------------------------------------------------------------
# Compacted colored sweep — per-color gather of ONLY that color's spins
# ---------------------------------------------------------------------------

@pytree.dataclass
class ColorGroups:
    """Per-color compacted operands, padded to the largest class size M.

    nodes [C, M] int32 spin indices (0 on padding, masked), nmask [C, M],
    idx [C, M, K] neighbor indices, val [C, M, K] couplings, h [C, M]."""

    nodes: jax.Array
    nmask: jax.Array
    idx: jax.Array
    val: jax.Array
    h: jax.Array


def build_color_groups(ell: EllProblem, colors: np.ndarray) -> ColorGroups:
    """Precompute the per-color gathered operands (host-side, once).

    The mask-based sweep re-gathers fields for ALL N spins per color — a
    C-fold waste. Compaction makes total per-sweep gather work ~N*K instead
    of C*N*K; with a balanced coloring (topology.greedy_coloring_coo
    balanced=True) the padding overhead M*C/N stays near 1."""
    colors = np.asarray(colors)
    c_count = int(colors.max()) + 1 if colors.size else 1
    idx_np = np.asarray(ell.idx)
    val_np = np.asarray(ell.val)
    h_np = np.asarray(ell.h)
    classes = [np.nonzero(colors == c)[0] for c in range(c_count)]
    m = max(len(cl) for cl in classes)
    nodes = np.zeros((c_count, m), np.int32)
    nmask = np.zeros((c_count, m), np.float32)
    for c, cl in enumerate(classes):
        nodes[c, : len(cl)] = cl
        nmask[c, : len(cl)] = 1.0
    return ColorGroups(
        nodes=jnp.asarray(nodes), nmask=jnp.asarray(nmask),
        idx=jnp.asarray(idx_np[nodes]), val=jnp.asarray(
            val_np[nodes].astype(np.float32)),
        h=jnp.asarray(h_np[nodes].astype(np.float32)))


@functools.partial(jax.jit, static_argnames=("rule",))
def sparse_colored_sweep_compact(
    ell: EllProblem,
    groups: ColorGroups,
    spins: jax.Array,         # [R, Np]
    beta: jax.Array,
    uniforms: jax.Array,      # [R, Np] (spin i consumes uniforms[:, i])
    rule: str = "metropolis",
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Exact colored sweep, decision-identical to sparse_colored_sweep /
    colored_sweep under the same uniforms and coloring, but gathering only
    each color's M spins per pass. Spin updates apply via scatter-ADD of
    ds = -2s (padding adds 0, so duplicate pad indices are benign)."""
    r = spins.shape[0]
    beta = jnp.broadcast_to(jnp.asarray(beta, jnp.float32), (r,))
    th = accept_threshold(uniforms, beta[:, None], rule)

    def body(carry, g):
        spins, de_acc, cnt = carry
        nodes, nmask, idx_c, val_c, h_c = g
        gathered = spins[:, idx_c]                       # [R, M, K]
        f = neighbor_sum(gathered, val_c[None], axis=-1) + h_c[None, :]
        s_c = spins[:, nodes]                            # [R, M]
        sf = s_c.astype(jnp.float32) * f
        acc = (sf < th[:, nodes]) & (nmask > 0)[None, :]
        ds = jnp.where(acc, -2.0 * s_c, 0.0)
        spins = spins.at[:, nodes].add(ds)
        de_acc = de_acc + 2.0 * jnp.sum(jnp.where(acc, sf, 0.0), axis=-1)
        cnt = cnt + jnp.sum(acc, axis=-1).astype(jnp.int32)
        return (spins, de_acc, cnt), None

    init = (spins, jnp.zeros((r,), jnp.float32), jnp.zeros((r,), jnp.int32))
    (spins, de_acc, cnt), _ = lax.scan(
        init=init, xs=(groups.nodes, groups.nmask, groups.idx, groups.val,
                       groups.h), f=body)
    return spins, de_acc, cnt


# ---------------------------------------------------------------------------
# Sorted sliced-ELL sweep — contiguous color classes + per-degree-bucket K
# ---------------------------------------------------------------------------

class SortedBucket:
    """One degree bucket of one color class, in the color-sorted spin layout.

    Spins [off, off+m) of the sorted layout form (part of) an independent
    set; their neighbor lists are padded only to THIS bucket's max degree k
    (sliced-ELL / SELL: per-slice K instead of the global max degree — on an
    avg-degree-6 / max-degree-19 graph this cuts gather work ~3x)."""

    def __init__(self, off: int, idx: np.ndarray, val: np.ndarray,
                 h: np.ndarray):
        self.off = int(off)
        self.m = int(idx.shape[0])
        self.k = int(idx.shape[1])
        self.idx = jnp.asarray(idx, jnp.int32)        # [m, k] sorted-layout indices
        self.val = jnp.asarray(val, jnp.float32)      # [m, k]
        self.h = jnp.asarray(h, jnp.float32)          # [m]


def build_sorted_buckets(ell: EllProblem, colors: np.ndarray,
                         n_buckets: int = 4):
    """Host-side precompute for the sorted sliced-ELL sweep.

    Returns (perm [Np], inv_perm [Np], buckets, color_groups). ``perm`` maps
    sorted position -> original index; within each color class nodes are
    sorted by descending degree and split at degree quantiles so each
    bucket's K is its own max degree. Order of buckets preserves color
    barriers (all of color 0, then color 1, ...); buckets within a color are
    subsets of the same independent set — mutually independent, which the
    sweep exploits by computing their fields from the SAME spin state and
    applying one contiguous update per color (``color_groups`` is a list of
    (offset, size, [bucket, ...]) spans in sorted coordinates)."""
    colors = np.asarray(colors)
    idx_np = np.asarray(ell.idx)
    val_np = np.asarray(ell.val)
    h_np = np.asarray(ell.h, np.float32)
    n_pad = ell.n_padded
    degs = (val_np != 0).sum(axis=1)

    order: list = []
    spans: list = []  # (start, node_array, color) per bucket in sorted coords
    c_count = int(colors.max()) + 1 if colors.size else 1
    pos = 0
    for c in range(c_count):
        cl = np.nonzero(colors == c)[0]
        if len(cl) == 0:
            continue
        cl = cl[np.argsort(-degs[cl], kind="stable")]
        # split at degree quantiles; merge adjacent splits with equal K
        nb = min(n_buckets, len(cl))
        splits = np.array_split(cl, nb)
        merged = [splits[0]]
        for s in splits[1:]:
            if len(s) == 0:
                continue
            if degs[s].max(initial=0) == degs[merged[-1]].max(initial=0):
                merged[-1] = np.concatenate([merged[-1], s])
            else:
                merged.append(s)
        for nodes in merged:
            if len(nodes) == 0:
                continue
            order.append(nodes)
            spans.append((pos, nodes, c))
            pos += len(nodes)
    # leftover positions (padding rows / uncolored) go at the end, never swept
    covered = np.concatenate(order) if order else np.zeros(0, np.int64)
    rest = np.setdiff1d(np.arange(n_pad), covered)
    perm = np.concatenate([covered, rest]).astype(np.int64)
    inv_perm = np.empty(n_pad, np.int64)
    inv_perm[perm] = np.arange(n_pad)

    buckets = []
    bucket_colors = []
    for start, nodes, c in spans:
        k_b = max(int(degs[nodes].max(initial=1)), 1)
        rows_idx = idx_np[nodes][:, :]
        rows_val = val_np[nodes][:, :]
        # compact each row's nonzeros to the front, then cut at k_b —
        # vectorized via a stable argsort on the zero-mask (the per-row
        # np.nonzero loop cost ~8 s alone at 1M rows; this is ~0.5 s)
        colorder = np.argsort(rows_val == 0, axis=1, kind="stable")
        val_b = np.take_along_axis(rows_val, colorder, axis=1)[:, :k_b]
        idx_c = np.take_along_axis(rows_idx, colorder, axis=1)[:, :k_b]
        # zero-valued (padding) slots keep the self-index convention
        idx_b = np.where(val_b != 0, inv_perm[idx_c],
                         inv_perm[nodes][:, None]).astype(np.int64)
        val_b = np.ascontiguousarray(val_b, np.float32)
        buckets.append(SortedBucket(start, idx_b, val_b, h_np[nodes]))
        bucket_colors.append(c)

    color_groups = []
    prev_c = None
    for b, c in zip(buckets, bucket_colors):
        if color_groups and c == prev_c:
            off, size, bs = color_groups[-1]
            color_groups[-1] = (off, size + b.m, bs + [b])
        else:
            color_groups.append((b.off, b.m, [b]))
        prev_c = c
    return perm, inv_perm, buckets, color_groups


def make_sorted_sweep(color_groups, n_padded: int, rule: str = "metropolis"):
    """Build the traceable sorted sliced-ELL sweep, color-grouped.

    spins [R, Np] in SORTED layout; spin at sorted position p consumes
    uniforms[:, p]. Per color: the degree buckets are subsets of the same
    independent set, so their neighbor gathers all read the SAME spin state
    (no false inter-bucket dependency — XLA overlaps them) and the color's
    flips apply as ONE contiguous slice update (the dependent-gather chain
    is n_colors steps long, not n_buckets*n_colors); decision-identical to the bucket-chained and compact sweeps under the
    same uniforms."""

    def sweep(spins, beta, uniforms):
        r = spins.shape[0]
        beta = jnp.broadcast_to(jnp.asarray(beta, jnp.float32), (r,))
        from spinglass_tpu.kernels.sweeps import accept_threshold

        th = accept_threshold(uniforms, beta[:, None], rule)
        de_acc = jnp.zeros((r,), jnp.float32)
        cnt = jnp.zeros((r,), jnp.int32)
        for off, mc, bs in color_groups:
            fs = []
            for b in bs:  # independent: all read the same `spins`
                gathered = spins[:, b.idx]                  # [R, m, k]
                fs.append(neighbor_sum(gathered, b.val[None], axis=-1)
                          + b.h[None, :])
            f = jnp.concatenate(fs, axis=1) if len(fs) > 1 else fs[0]
            s_c = lax.slice_in_dim(spins, off, off + mc, axis=1)
            sf = s_c.astype(jnp.float32) * f
            acc = sf < lax.slice_in_dim(th, off, off + mc, axis=1)
            ds = jnp.where(acc, -2.0 * s_c, 0.0)
            spins = lax.dynamic_update_slice(spins, s_c + ds, (0, off))
            de_acc = de_acc + 2.0 * jnp.sum(jnp.where(acc, sf, 0.0), axis=-1)
            cnt = cnt + jnp.sum(acc, axis=-1).astype(jnp.int32)
        return spins, de_acc, cnt

    return sweep


# ---------------------------------------------------------------------------
# Transposed aligned sorted sliced-ELL — the wide-replica sparse fast path
# ---------------------------------------------------------------------------

class TBucket:
    """One degree bucket of one color class in the TRANSPOSED ([NS, R])
    sorted layout. Rows [off, off+m) of the sorted layout; neighbor lists
    padded to this bucket's max degree k; m padded to ``row_align`` rows
    (inert rows: val=0, h=0, masked in the acceptance thresholds)."""

    def __init__(self, off: int, idx: np.ndarray, val: np.ndarray,
                 h: np.ndarray):
        self.off = int(off)
        self.m = int(idx.shape[0])
        self.k = int(idx.shape[1])
        self.idx = jnp.asarray(idx, jnp.int32)     # [m, k] sorted coords
        self.val = jnp.asarray(val, jnp.float32)   # [m, k]
        self.h = jnp.asarray(h, jnp.float32)       # [m]


def build_sorted_t(ell: EllProblem, colors: np.ndarray, n_buckets: int = 12,
                   row_align: int = 8, color_align: int = 32,
                   total_align: int = 256, bucket_order: str = "degree"):
    """Host-side layout for the transposed sorted sliced-ELL sweep.

    Differences vs build_sorted_buckets:
    * every bucket size is padded to ``row_align`` rows and every color span
      to ``color_align`` rows, so all sweep slices/updates are aligned;
    * more degree buckets (12 vs 4) cut padded gather rows 77k -> 65k on the
      10k-spin avg-degree-6 graph;
    * returns a [NS, 1] threshold mask (0 real / -inf padding) so inert rows
      never flip.

    ``bucket_order``: row order INSIDE each degree bucket — "degree"
    (descending, the historical default) or "index" (ascending original
    index, which keeps the memory locality that degree sorting scatters).
    Bucket membership and padding are identical either way; only the
    within-bucket row order changes.

    Returns (perm [NS] original index per sorted row (-1 padding),
    inv_map [n_padded] sorted position per original row, groups
    [(off, size, [TBucket...])], mask_col [NS, 1], n_sorted)."""
    colors = np.asarray(colors)
    idx_np = np.asarray(ell.idx)
    val_np = np.asarray(ell.val)
    h_np = np.asarray(ell.h, np.float32)
    degs = (val_np != 0).sum(axis=1)
    c_count = int(colors.max()) + 1 if colors.size else 1

    def aup(x, a):
        return -(-x // a) * a

    pos = 0
    plan = []  # (span_start, [(bucket_off, nodes, m_pad, k)])
    for c in range(c_count):
        cl = np.nonzero(colors == c)[0]
        if len(cl) == 0:
            continue
        cl = cl[np.argsort(-degs[cl], kind="stable")]
        nb = min(n_buckets, len(cl))
        splits = [s for s in np.array_split(cl, nb) if len(s)]
        merged = [splits[0]]
        for s in splits[1:]:
            if degs[s].max(initial=0) == degs[merged[-1]].max(initial=0):
                merged[-1] = np.concatenate([merged[-1], s])
            else:
                merged.append(s)
        if bucket_order == "index":
            merged = [np.sort(nodes_b) for nodes_b in merged]
        elif bucket_order != "degree":
            raise ValueError(f"bucket_order must be 'degree' or 'index', "
                             f"got {bucket_order!r}")
        span_start = pos
        buckets = []
        for bi, nodes in enumerate(merged):
            m_pad = aup(len(nodes), row_align)
            if bi == len(merged) - 1:  # color span up to color_align
                m_pad = (aup(pos - span_start + m_pad, color_align)
                         - (pos - span_start))
            buckets.append((pos, nodes, m_pad,
                            max(int(degs[nodes].max(initial=1)), 1)))
            pos += m_pad
        plan.append((span_start, buckets))
    n_sorted = aup(max(pos, total_align), total_align)

    perm = np.full(n_sorted, -1, np.int64)
    for _, buckets in plan:
        for start, nodes, m_pad, k in buckets:
            perm[start:start + len(nodes)] = nodes
    inv_map = np.zeros(ell.n_padded, np.int64)
    real = perm >= 0
    inv_map[perm[real]] = np.nonzero(real)[0]

    groups = []
    for span_start, buckets in plan:
        bl = []
        span_size = 0
        for start, nodes, m_pad, k in buckets:
            bidx = np.zeros((m_pad, k), np.int64)
            bval = np.zeros((m_pad, k), np.float32)
            bh = np.zeros(m_pad, np.float32)
            # vectorized per-row nonzero compaction (same stable argsort
            # trick as build_sorted_buckets — the per-row np.nonzero loop
            # cost ~8 s at 1M rows; found duplicated here in r4 review)
            m = len(nodes)
            rows_val = val_np[nodes]
            rows_idx = idx_np[nodes]
            colorder = np.argsort(rows_val == 0, axis=1, kind="stable")
            v_c = np.take_along_axis(rows_val, colorder, axis=1)[:, :k]
            i_c = np.take_along_axis(rows_idx, colorder, axis=1)[:, :k]
            bidx[:m] = np.where(v_c != 0, inv_map[i_c], 0)
            bval[:m] = v_c
            bh[:m] = h_np[nodes]
            bl.append(TBucket(start, bidx, bval, bh))
            span_size += m_pad
        groups.append((span_start, span_size, bl))
    mask = np.where(real, 0.0, -np.inf).astype(np.float32)
    return perm, inv_map, groups, jnp.asarray(mask[:, None]), n_sorted


def _materialized(f: jax.Array) -> jax.Array:
    """``f`` written to memory before its consumers read it. In [NS, R]
    the sums over spins (dE, flip counts, energy) reduce the major axis;
    fused with the gathers that produce ``f``, each such reduction became
    a kernel that took the GPU compiler 20-50 s (a PT program, minutes).
    Materialized, the gathers compile as plain loop fusions."""
    return lax.optimization_barrier(f)


def make_sorted_t_sweep(groups):
    """Traceable transposed sorted sweep: spins [NS, R] (int8 or f32),
    thresholds [NS, R] f32 (pre-masked). Per color the degree buckets all
    gather from the SAME spin state (independent set) and the color's flips
    apply as one contiguous aligned slice update. Row-gathers in [NS, R]
    read whole contiguous replica rows, where the [R, NS] gathers of
    make_sorted_sweep read one element per replica."""

    def sweep(s_t, th_t):
        r = s_t.shape[1]
        de_acc = jnp.zeros((r,), jnp.float32)
        cnt = jnp.zeros((r,), jnp.int32)
        for off, mc, bs in groups:
            fs = []
            for b in bs:  # independent: all read the same `s_t`
                fs.append(rows_field(s_t, b.idx, b.val) + b.h[:, None])
            f = _materialized(jnp.concatenate(fs, axis=0) if len(fs) > 1
                              else fs[0])
            s_c = lax.slice_in_dim(s_t, off, off + mc, axis=0)
            sf = s_c.astype(jnp.float32) * f
            acc = sf < lax.slice_in_dim(th_t, off, off + mc, axis=0)
            s_new = jnp.where(acc, -s_c, s_c)
            s_t = lax.dynamic_update_slice(s_t, s_new, (off, 0))
            de_acc = de_acc + 2.0 * jnp.sum(jnp.where(acc, sf, 0.0), axis=0)
            cnt = cnt + jnp.sum(acc, axis=0).astype(jnp.int32)
        return s_t, de_acc, cnt

    return sweep


class SortedSparseTEngine:
    """Transposed ([NS, R]) aligned sorted sliced-ELL engine — the
    wide-replica sparse path (engines.SweepEngine contract, layout 'nr').

    Differences from SortedSparseEngine:
    * [NS, R] layout: neighbor gathers read whole contiguous replica rows
      (major-dim gather) instead of minor-dim scattered elements;
    * tile-aligned color spans + 12 degree buckets (build_sorted_t).
    Spins are carried as int8 between sweeps (smaller gather rows and
    memory footprint; decisions are identical — spin values are exact in
    int8 and fields are accumulated in f32).

    make_engine picks between the two engines by ``r_hint``."""

    layout = "nr"
    name = "sparse_sorted_t"

    def __init__(self, problem, rule: str = "metropolis",
                 max_colors: int = 256, n_buckets: int = 12,
                 spin_dtype=jnp.int8, bucket_order: str = "degree"):
        from spinglass_tpu.kernels.sweeps import canonical_rule

        self.problem = problem
        self.rule = canonical_rule(rule)
        self.spin_dtype = jnp.dtype(spin_dtype)
        if isinstance(problem, EllProblem):
            ell = problem
            idx = np.asarray(problem.idx)
            val = np.asarray(problem.val)
            rows_l, cols_l = np.nonzero(val)
            rows = rows_l.astype(np.int64)
            cols = idx[rows_l, cols_l].astype(np.int64)
            colors = topology.greedy_coloring_coo(
                rows, cols, problem.n_spins, max_colors=max_colors,
                balanced=True)
        else:
            ell = EllProblem.from_problem(problem)
            n = problem.n_spins
            j_np = np.asarray(problem.j)[:n, :n]
            rows, cols = (a.astype(np.int64) for a in np.nonzero(j_np))
            colors = topology.greedy_coloring_coo(rows, cols, n,
                                                  max_colors=max_colors,
                                                  balanced=True)
        self.ell = ell
        self.n_colors = int(colors.max()) + 1 if colors.size else 1
        (self.perm, self.inv_map, self.groups, self.mask_col,
         self.n_sorted) = build_sorted_t(ell, colors, n_buckets=n_buckets,
                                         bucket_order=bucket_order)
        self._perm_gather = jnp.asarray(np.where(self.perm >= 0,
                                                 self.perm, 0))
        self._inv_map_j = jnp.asarray(self.inv_map)
        self._sweep = make_sorted_t_sweep(self.groups)

    # -- layout ------------------------------------------------------------
    def to_layout(self, spins_rn):
        s_t = spins_rn[:, self._perm_gather].T
        return s_t.astype(self.spin_dtype)

    def from_layout(self, spins_t):
        s_rn = spins_t[self._inv_map_j].T.astype(jnp.float32)
        # original padding rows carry junk sorted rows; restore the +1
        # convention of core.problem.random_spins
        return jnp.where(self.ell.active_mask[None, :] > 0, s_rn, 1.0)

    # -- energy (exact, in the transposed layout) --------------------------
    def energy(self, spins_t):
        # buckets tile the sorted rows [0, n) in order, so their fields
        # concatenate into one [n, R] array and the energy is one reduction
        bs = [b for _, _, g in self.groups for b in g]
        fj = _materialized(jnp.concatenate(
            [rows_field(spins_t, b.idx, b.val) for b in bs], axis=0))
        h = jnp.concatenate([b.h for b in bs])
        s32 = spins_t[:fj.shape[0]].astype(jnp.float32)
        return -jnp.sum(s32 * (0.5 * fj + h[:, None]), axis=0)

    # -- sweeps ------------------------------------------------------------
    def _thresholds(self, uniforms_t, beta):
        from spinglass_tpu.kernels.sweeps import accept_threshold

        r = uniforms_t.shape[1]
        beta = jnp.broadcast_to(jnp.asarray(beta, jnp.float32), (r,))
        th = accept_threshold(uniforms_t, beta[None, :], self.rule)
        return jnp.where(self.mask_col < 0, -jnp.inf, th)

    def sweep(self, spins_t, beta, key):
        u = jax.random.uniform(key, spins_t.shape, jnp.float32)
        return self._sweep(spins_t, self._thresholds(u, beta))

    def sweep_with_uniforms(self, spins_t, beta, uniforms_t):
        """Deterministic-uniform entry (tests): uniforms in the SORTED
        transposed layout — sorted row p consumes uniforms_t[p, :]."""
        return self._sweep(spins_t, self._thresholds(uniforms_t, beta))

    # jit-boundary contract (anneal.engines.SweepEngine docstring)
    def operands(self):
        return {"ell": self.ell, "mask_col": self.mask_col,
                "_perm_gather": self._perm_gather,
                "_inv_map_j": self._inv_map_j,
                "buckets": _bucket_arrays(self.groups)}

    def bind(self, ops):
        import copy

        eng = copy.copy(self)
        eng.ell = ops["ell"]
        eng.mask_col = ops["mask_col"]
        eng._perm_gather = ops["_perm_gather"]
        eng._inv_map_j = ops["_inv_map_j"]
        eng.groups = _rebind_groups(self.groups, ops["buckets"])
        eng._sweep = make_sorted_t_sweep(eng.groups)
        return eng


class SparseEngine:
    """Sweep engine over ELL problems (engines.SweepEngine contract,
    layout 'rn'). Selected automatically for low-density large instances;
    also constructible dense-free from an EllProblem (anneal() accepts
    EllProblem directly)."""

    layout = "rn"
    name = "sparse_colored"

    def __init__(self, problem, rule: str = "metropolis",
                 max_colors: int = 256, compact: bool = True):
        self.problem = problem
        self.rule = rule
        if isinstance(problem, EllProblem):
            self.ell = problem
            idx = np.asarray(problem.idx)
            val = np.asarray(problem.val)
            rows_l, cols_l = np.nonzero(val)
            rows = rows_l.astype(np.int64)
            cols = idx[rows_l, cols_l].astype(np.int64)
            colors = topology.greedy_coloring_coo(rows, cols,
                                                  problem.n_spins,
                                                  max_colors=max_colors,
                                                  balanced=compact)
        else:
            self.ell = EllProblem.from_problem(problem)
            n = problem.n_spins
            j_np = np.asarray(problem.j)[:n, :n]
            rows, cols = (a.astype(np.int64) for a in np.nonzero(j_np))
            colors = topology.greedy_coloring_coo(rows, cols, n,
                                                  max_colors=max_colors,
                                                  balanced=compact)
        self.n_colors = int(colors.max()) + 1 if colors.size else 1
        self.masks = color_masks_from_colors(colors, problem.n_padded)
        self.compact = compact
        self.groups = build_color_groups(self.ell, colors) if compact else None

    def energy(self, spins):
        return sparse_energy(self.ell, spins)

    def to_layout(self, spins_rn):
        return spins_rn

    def from_layout(self, spins):
        return spins

    def sweep(self, spins, beta, key):
        uniforms = jax.random.uniform(key, spins.shape, jnp.float32)
        if self.compact:
            return sparse_colored_sweep_compact(
                self.ell, self.groups, spins, beta, uniforms, rule=self.rule)
        return sparse_colored_sweep(self.ell, self.masks, spins, beta,
                                    uniforms, rule=self.rule)

    # jit-boundary contract (anneal.engines.SweepEngine docstring);
    # ColorGroups is a pytree so it passes wholesale
    def operands(self):
        return {"ell": self.ell, "masks": self.masks, "groups": self.groups}

    def bind(self, ops):
        import copy

        eng = copy.copy(self)
        eng.ell = ops["ell"]
        eng.masks = ops["masks"]
        eng.groups = ops["groups"]
        return eng


def _bucket_arrays(groups):
    """Flat list of (idx, val, h) per bucket — the operand leaves of a
    sorted-layout engine (see anneal.engines.SweepEngine jit-boundary
    contract; bucket OFFSETS stay static in the closure)."""
    return [(b.idx, b.val, b.h) for _, _, bs in groups for b in bs]


def _rebind_groups(groups, arrays):
    """Same group structure, bucket arrays replaced by (traced) values."""
    import copy

    it = iter(arrays)
    out = []
    for off, size, bs in groups:
        nbs = []
        for b in bs:
            nb = copy.copy(b)
            nb.idx, nb.val, nb.h = next(it)
            nbs.append(nb)
        out.append((off, size, nbs))
    return out


class SortedSparseEngine:
    """Sorted sliced-ELL sweep engine — the narrow-replica sparse path.

    Improvements over SparseEngine(compact=True), both per sweep:
    * sliced-ELL: per-bucket K = that bucket's max degree instead of the
      global max degree (~3x less gather work on irregular-degree graphs);
    * color-sorted spin layout: spin reads/writes are contiguous slices, so
      the node-gather, threshold-gather, and scatter-add of the compact
      sweep disappear — only the irreducible neighbor gather remains.

    State lives in the sorted layout between sweeps; ``to_layout`` /
    ``from_layout`` convert at the run boundary (the SweepEngine contract
    the SA/PT drivers already use)."""

    layout = "rn"
    name = "sparse_sorted"

    def __init__(self, problem, rule: str = "metropolis",
                 max_colors: int = 256, n_buckets: int = 4):
        from spinglass_tpu.kernels.sweeps import canonical_rule

        self.problem = problem
        self.rule = canonical_rule(rule)
        if isinstance(problem, EllProblem):
            ell = problem
            idx = np.asarray(problem.idx)
            val = np.asarray(problem.val)
            rows_l, cols_l = np.nonzero(val)
            rows = rows_l.astype(np.int64)
            cols = idx[rows_l, cols_l].astype(np.int64)
            colors = topology.greedy_coloring_coo(
                rows, cols, problem.n_spins, max_colors=max_colors,
                balanced=True)
        else:
            ell = EllProblem.from_problem(problem)
            n = problem.n_spins
            j_np = np.asarray(problem.j)[:n, :n]
            rows, cols = (a.astype(np.int64) for a in np.nonzero(j_np))
            colors = topology.greedy_coloring_coo(rows, cols, n,
                                                  max_colors=max_colors,
                                                  balanced=True)
        self.ell = ell
        self.n_colors = int(colors.max()) + 1 if colors.size else 1
        (self.perm, self.inv_perm, self.buckets,
         self.color_groups) = build_sorted_buckets(
            ell, colors, n_buckets=n_buckets)
        self._perm_j = jnp.asarray(self.perm)
        self._inv_perm_j = jnp.asarray(self.inv_perm)
        # full sorted ELL for energy evaluation in the sorted layout
        idx_np = np.asarray(ell.idx)
        self.ell_sorted = EllProblem(
            idx=jnp.asarray(self.inv_perm[idx_np[self.perm]].astype(np.int32)),
            val=ell.val[self._perm_j],
            h=ell.h[self._perm_j],
            active_mask=ell.active_mask[self._perm_j],
            n_spins=ell.n_spins,
        )
        self._sweep = make_sorted_sweep(self.color_groups, ell.n_padded,
                                        rule=self.rule)

    def energy(self, spins):
        return sparse_energy(self.ell_sorted, spins)

    def to_layout(self, spins_rn):
        return spins_rn[:, self._perm_j]

    def from_layout(self, spins):
        return spins[:, self._inv_perm_j]

    def sweep(self, spins, beta, key):
        uniforms = jax.random.uniform(key, spins.shape, jnp.float32)
        return self._sweep(spins, beta, uniforms)

    def sweep_with_uniforms(self, spins, beta, uniforms_sorted):
        """Deterministic-uniform entry for tests (uniforms already in the
        sorted layout: sorted position p consumes uniforms[:, p])."""
        return self._sweep(spins, beta, uniforms_sorted)

    # jit-boundary contract (anneal.engines.SweepEngine docstring)
    def operands(self):
        return {"ell_sorted": self.ell_sorted, "_perm_j": self._perm_j,
                "_inv_perm_j": self._inv_perm_j,
                "buckets": _bucket_arrays(self.color_groups)}

    def bind(self, ops):
        import copy

        eng = copy.copy(self)
        eng.ell_sorted = ops["ell_sorted"]
        eng._perm_j = ops["_perm_j"]
        eng._inv_perm_j = ops["_inv_perm_j"]
        eng.color_groups = _rebind_groups(self.color_groups, ops["buckets"])
        eng._sweep = make_sorted_sweep(eng.color_groups,
                                       self.ell.n_padded, rule=self.rule)
        return eng
