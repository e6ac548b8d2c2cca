"""Wolff cluster updates, batched over replicas.

Rebuilds SpinDynamics' Wolff BFS (reference core/spin_dynamics.py:211-323 —
a per-replica Python BFS with set()s) as a jittable frontier iteration:

Each step adds every non-cluster spin j with joint probability
    p_join(j) = 1 - prod_{i in frontier} (1 - p_ij),
    p_ij     = 1 - exp(-2 beta J_ij s_i s_j)   when J_ij s_i s_j > 0
i.e. log(1 - p_join) = -2 beta sum_{i in frontier} max(J_ij s_i s_j, 0),
evaluated as one batched contraction per BFS step. The grown cluster flips
as a whole — rejection-free and ergodicity-preserving (standard Wolff), which
beats single-spin Metropolis near criticality.

The dense BFS step's join-probability sum factors into two [R, N] x [N, N]
matmuls (max(J_ij s_i s_j, 0) = |J|_ij/2 + s_i s_j J_ij/2 for unit spins),
so per-step cost is O(R N) memory and matrix-product flops — no [R, N, N]
materialization; large sparse instances use the ELL variants below."""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from spinglass_tpu.core import energy as energy_ops
from spinglass_tpu.core.problem import IsingProblem


@functools.partial(jax.jit, static_argnames=())
def wolff_update(problem: IsingProblem, spins: jax.Array, beta: jax.Array,
                 key: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """One Wolff cluster flip per replica.

    spins [R, Np]; returns (spins, cluster_size[R])."""
    r, n_pad = spins.shape
    beta = jnp.broadcast_to(jnp.asarray(beta, jnp.float32), (r,))
    k_seed, k_loop = jax.random.split(key)
    active = problem.active_mask > 0

    # random seed spin per replica (logical sites only)
    seed = jax.random.randint(k_seed, (r,), 0, problem.n_spins)
    cluster = jnp.zeros((r, n_pad), bool).at[jnp.arange(r), seed].set(True)
    frontier = cluster

    def cond(carry):
        _, frontier, _, it = carry
        return (it < n_pad) & jnp.any(frontier)

    j32 = problem.j.astype(jnp.float32)
    jabs = jnp.abs(j32)

    def body(carry):
        cluster, frontier, key, it = carry
        key, ku = jax.random.split(key)
        # bond_sum[r, j] = sum_i frontier_i * max(J_ij s_i s_j, 0). Using
        # s_i s_j in {-1, +1}: max(J_ij s_i s_j, 0) = |J|_ij/2 + s_i s_j
        # J_ij/2, so the sum factors into two [R, N] x [N, N] matmuls —
        # O(R N) memory and matrix-product work instead of a [R, N, N]
        # elementwise materialization.
        fmask = frontier.astype(jnp.float32)                       # [R, Np]
        fs = fmask * spins
        hi = lax.Precision.HIGHEST   # full f32: TF32 would round J
        bond_sum = (0.5 * jnp.matmul(fmask, jabs, precision=hi)
                    + 0.5 * spins * jnp.matmul(fs, j32, precision=hi))
        p_join = 1.0 - jnp.exp(-2.0 * beta[:, None] * bond_sum)
        u = jax.random.uniform(ku, (r, n_pad))
        newly = (u < p_join) & ~cluster & active[None, :]
        return (cluster | newly, newly, key, it + 1)

    cluster, _, _, _ = lax.while_loop(
        cond, body, (cluster, frontier, k_loop, jnp.asarray(0)))
    spins = jnp.where(cluster, -spins, spins)
    return spins, jnp.sum(cluster, axis=-1).astype(jnp.int32)


def wolff_sweep(problem: IsingProblem, spins: jax.Array, beta: jax.Array,
                key: jax.Array, n_clusters: int = 1
                ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """n_clusters Wolff updates; returns (spins, dE[R], total_flipped[R]).

    dE is recomputed exactly (cluster flips change energy globally)."""
    e0 = energy_ops.energy(problem, spins)
    total = jnp.zeros((spins.shape[0],), jnp.int32)
    for i in range(n_clusters):
        key, sub = jax.random.split(key)
        spins, size = wolff_update(problem, spins, beta, sub)
        total = total + size
    e1 = energy_ops.energy(problem, spins)
    return spins, e1 - e0, total


@functools.partial(jax.jit, static_argnames=())
def wolff_update_ell(ell, spins: jax.Array, beta: jax.Array,
                     key: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Sparse Wolff: one cluster flip per replica over ELL neighbor lists
    (reference spin_dynamics.py:259-323 sparse Wolff —
    no [R, N, N] materialization, so cluster moves work at 10k+ spins).

    Frontier contraction per BFS step is a gather-reduce over each spin's
    K-neighbor list:
        bond_sum[r, j] = sum_k max(val[j,k] * s_j * s_i, 0) * frontier[i],
        i = idx[j, k]
    O(R * N * K) per step instead of the dense O(R * N^2).

    spins [R, Np]; returns (spins, cluster_size [R])."""
    import jax.numpy as jnp

    r, n_pad = spins.shape
    beta = jnp.broadcast_to(jnp.asarray(beta, jnp.float32), (r,))
    k_seed, k_loop = jax.random.split(key)
    active = ell.active_mask > 0
    val32 = ell.val.astype(jnp.float32)

    seed = jax.random.randint(k_seed, (r,), 0, ell.n_spins)
    cluster = jnp.zeros((r, n_pad), bool).at[jnp.arange(r), seed].set(True)
    frontier = cluster

    def cond(carry):
        _, frontier, _, it = carry
        return (it < n_pad) & jnp.any(frontier)

    def body(carry):
        cluster, frontier, key, it = carry
        key, ku = jax.random.split(key)
        # gather frontier-masked neighbor spins: [R, Np, K]
        f_spins = jnp.where(frontier, spins, 0.0)
        nb = f_spins[:, ell.idx]                                 # [R, Np, K]
        jss = val32[None] * spins[:, :, None] * nb               # J_ij s_j s_i
        bond_sum = jnp.sum(jnp.maximum(jss, 0.0), axis=-1)       # [R, Np]
        p_join = -jnp.expm1(-2.0 * beta[:, None] * bond_sum)
        u = jax.random.uniform(ku, (r, n_pad))
        newly = (u < p_join) & ~cluster & active[None, :]
        return (cluster | newly, newly, key, it + 1)

    cluster, _, _, _ = lax.while_loop(
        cond, body, (cluster, frontier, k_loop, jnp.asarray(0)))
    spins = jnp.where(cluster, -spins, spins)
    return spins, jnp.sum(cluster, axis=-1).astype(jnp.int32)


def wolff_sweep_ell(ell, spins: jax.Array, beta: jax.Array, key: jax.Array,
                    n_clusters: int = 1
                    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """n_clusters sparse Wolff updates; returns (spins, dE[R], flipped[R])."""
    from spinglass_tpu.kernels.sparse import sparse_energy

    e0 = sparse_energy(ell, spins)
    total = jnp.zeros((spins.shape[0],), jnp.int32)
    for _ in range(n_clusters):
        key, sub = jax.random.split(key)
        spins, size = wolff_update_ell(ell, spins, beta, sub)
        total = total + size
    e1 = sparse_energy(ell, spins)
    return spins, e1 - e0, total


# ---------------------------------------------------------------------------
# Swendsen-Wang — batched label propagation over ELL neighbor lists
# ---------------------------------------------------------------------------

def _ell_reverse_slots(idx, val):
    """Host precompute: rev_i/rev_k such that idx[rev_i[i,k], rev_k[i,k]] == i
    for every real slot (self-pointing on padding). Lets both directions of an
    undirected edge consume the SAME uniform (the i<j direction's draw)."""
    import numpy as np

    idx = np.asarray(idx)
    val = np.asarray(val)
    n_pad, k_max = idx.shape
    slot_of = {}
    for i in range(n_pad):
        for k in range(k_max):
            if val[i, k] != 0.0:
                slot_of[(i, int(idx[i, k]), k)] = None
    # map (j -> i) slot lookup: position of i in j's row
    pos = {}
    for j in range(n_pad):
        for k in range(k_max):
            if val[j, k] != 0.0:
                pos.setdefault((j, int(idx[j, k])), k)
    rev_i = np.tile(np.arange(n_pad)[:, None], (1, k_max)).astype(np.int32)
    rev_k = np.tile(np.arange(k_max)[None, :], (n_pad, 1)).astype(np.int32)
    for i in range(n_pad):
        for k in range(k_max):
            j = int(idx[i, k])
            if val[i, k] != 0.0 and (j, i) in pos:
                rev_i[i, k] = j
                rev_k[i, k] = pos[(j, i)]
    return rev_i, rev_k


class SwendsenWang:
    """Swendsen-Wang multi-cluster updates, batched over replicas.

    The reference README advertises a ``SwendsenWang`` sampler that does not
    exist in its code (SURVEY.md preamble); this is the real thing, built
    for accelerators: bond activation, connected components, and cluster flips are
    all vectorized [R, N(,K)] array ops under jit — components via min-label
    propagation with pointer jumping (l = min(l, neighbor_min); l = l[l]),
    which converges in O(log N) rounds instead of a per-cluster BFS.

    External fields use the standard ghost-spin coupling: sites bond to a
    ghost with p = 1 - exp(-2 beta h_i s_i) (when h_i s_i > 0); ghost-connected
    clusters (label -1) never flip, preserving detailed balance with h != 0.
    """

    def __init__(self, problem):
        from spinglass_tpu.kernels.sparse import EllProblem

        if isinstance(problem, EllProblem):
            self.ell = problem
        else:
            self.ell = EllProblem.from_problem(problem)
        self.problem = problem
        rev_i, rev_k = _ell_reverse_slots(self.ell.idx, self.ell.val)
        self.rev_i = jnp.asarray(rev_i)
        self.rev_k = jnp.asarray(rev_k)
        self._sweep_jit = jax.jit(self._sweep)

    # jit-boundary contract (anneal.engines.SweepEngine docstring): the
    # ELL arrays and reverse-slot maps must cross jit as arguments, not
    # closure constants (PT's cluster_moves path runs this inside the
    # jitted super-step)
    def operands(self):
        return {"ell": self.ell, "rev_i": self.rev_i, "rev_k": self.rev_k}

    def bind(self, ops):
        import copy

        sw = copy.copy(self)
        sw.ell = ops["ell"]
        sw.rev_i = ops["rev_i"]
        sw.rev_k = ops["rev_k"]
        # the copied _sweep_jit is a bound method of the ORIGINAL instance
        # and would trace the unbound arrays — rebuild it on the copy
        sw._sweep_jit = jax.jit(sw._sweep)
        return sw

    def _sweep(self, spins, beta, key):
        """One SW update: activate bonds, label clusters, flip half."""
        from spinglass_tpu.kernels.sparse import sparse_energy

        ell = self.ell
        r, n_pad = spins.shape
        k_max = ell.idx.shape[1]
        beta = jnp.broadcast_to(jnp.asarray(beta, jnp.float32), (r,))
        k_bond, k_ghost, k_flip = jax.random.split(key, 3)

        # --- bond activation (one uniform per undirected edge) -----------
        u_dir = jax.random.uniform(k_bond, (r, n_pad, k_max))
        u_rev = u_dir[:, self.rev_i, self.rev_k]
        u_edge = jnp.where((jnp.arange(n_pad)[:, None] < ell.idx)[None],
                           u_dir, u_rev)
        s_i = spins[:, :, None]
        s_j = spins[:, ell.idx]
        jss = ell.val[None].astype(jnp.float32) * s_i * s_j     # [R, Np, K]
        p_bond = -jnp.expm1(-2.0 * beta[:, None, None]
                            * jnp.maximum(jss, 0.0))
        bond = (u_edge < p_bond) & (jss > 0)

        # --- ghost bonds from external fields ----------------------------
        hs = ell.h.astype(jnp.float32)[None, :] * spins
        p_ghost = -jnp.expm1(-2.0 * beta[:, None] * jnp.maximum(hs, 0.0))
        ghost = jax.random.uniform(k_ghost, (r, n_pad)) < p_ghost

        # --- connected components: min-label + pointer jumping -----------
        active = ell.active_mask > 0
        init_l = jnp.where(active[None, :],
                           jnp.arange(n_pad, dtype=jnp.int32)[None, :],
                           jnp.int32(n_pad))  # padding: inert self-labels
        init_l = jnp.where(ghost & active[None, :], jnp.int32(-1), init_l)
        big = jnp.int32(n_pad)

        def cond(carry):
            l, changed, it = carry
            return changed & (it < n_pad)

        def body(carry):
            l, _, it = carry
            nb = l[jnp.arange(r)[:, None, None], ell.idx[None]]  # [R, Np, K]
            nb = jnp.where(bond, nb, big)
            l_new = jnp.minimum(l, jnp.min(nb, axis=-1))
            # pointer jumping: follow the label's current label
            l_idx = jnp.maximum(l_new, 0)                         # guard -1
            l_jump = l_new[jnp.arange(r)[:, None], l_idx]
            l_new = jnp.where(l_new >= 0, jnp.minimum(l_new, l_jump), l_new)
            changed = jnp.any(l_new != l)
            return (l_new, changed, it + 1)

        labels, _, n_iter = lax.while_loop(
            cond, body, (init_l, jnp.asarray(True), jnp.asarray(0)))

        # --- flip each non-ghost cluster with p = 1/2 ---------------------
        coins = jax.random.bernoulli(k_flip, 0.5, (r, n_pad))
        flip = jnp.where(labels >= 0,
                         coins[jnp.arange(r)[:, None],
                               jnp.maximum(labels, 0)], False)
        flip = flip & active[None, :]
        new_spins = jnp.where(flip, -spins, spins)
        e0 = sparse_energy(ell, spins)
        e1 = sparse_energy(ell, new_spins)
        n_clusters = jnp.sum(
            (labels == jnp.arange(n_pad, dtype=jnp.int32)[None, :])
            & active[None, :], axis=-1)
        return new_spins, e1 - e0, n_clusters.astype(jnp.int32)

    def sweep(self, spins, beta, key):
        """spins [R, Np] -> (spins, dE[R], n_clusters[R])."""
        return self._sweep_jit(spins, beta, key)
