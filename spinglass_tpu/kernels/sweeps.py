"""Monte-Carlo sweep engines (XLA implementations).

This module replaces the reference's three CUDA kernels
(spin_glass_rl/annealing/cuda_kernels.py:8-124) and its per-spin Python sweep
(core/spin_dynamics.py:61-94). Two exact strategies, both batched over a replica
axis [R, N]:

1. **Colored sweep** — for sparse/structured coupling graphs. A greedy vertex
   coloring (core/topology.py) guarantees no same-color couplings, so each color
   class updates all its spins simultaneously with one matmul for the local
   fields. Exact Metropolis per color; k matmuls per sweep for a k-coloring.
   This *fixes the reference CUDA kernel's race* (cuda_kernels.py:24-48 updates
   all spins against stale neighbors — wrong detailed balance; SURVEY §5).

2. **Blocked-sequential sweep** — exact sequential-equivalent Metropolis for
   dense J. Spins are processed in blocks of size B: the block's local fields
   come from one [R,N]x[N,B] matmul, then the B spins update sequentially
   with a rank-1 running correction H += ds * J[j, block]. Identical to a fully
   sequential sweep in exact arithmetic, but with all O(N^2) work in matrix
   products. On a GPU the B sequential updates run as one Pallas kernel
   (kernels/block_gpu.py).

Both consume externally supplied uniforms u[R, N] (spin i consumes u[:, i]),
which makes the GPU kernel bitwise-comparable with the XLA reference and
reproduces the reference's pre-generated-randoms design (cuda_kernels.py:244-248).

Update rules (reference core/spin_dynamics.py:131-191):
  metropolis: accept with prob min(1, exp(-beta dE))
  glauber:    flip with prob sigmoid(-beta dE)   (== heat-bath for Ising spins)
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from spinglass_tpu.core.problem import IsingProblem

UPDATE_RULES = ("metropolis", "glauber", "heat_bath")

# Precision of the sweeps' field products (spins @ J): three bf16 products
# with f32 accumulation. Spins are exact in bf16 and J is split into two bf16
# halves, so J keeps 16 mantissa bits (relative error ~1e-5) at a third of
# the f32 product's time on the H100. TF32, what an f32 product with default
# precision may run as on a GPU, keeps 10 bits and disagreed with the
# float64 oracle on 4 of 131072 decisions where this showed none (PERF.md,
# "Kernel decisions"). Energies (core/energy.py) stay at full f32.
FIELD_PRECISION = lax.DotAlgorithmPreset.BF16_BF16_F32_X3


def canonical_rule(rule: str) -> str:
    """Normalize an update-rule name.

    The reference exposes Metropolis, Glauber, and heat-bath as separate
    rules (core/spin_dynamics.py:131-191); for +-1 Ising spins the Glauber
    and heat-bath flip probabilities are identical (sigmoid(-beta dE)), so
    ``heat_bath`` maps onto the Glauber implementation.
    """
    if rule == "heat_bath":
        return "glauber"
    if rule not in UPDATE_RULES:
        raise ValueError(
            f"unknown update rule {rule!r}; expected one of {UPDATE_RULES}")
    return rule


def accept_prob(delta_e: jax.Array, beta: jax.Array, rule: str) -> jax.Array:
    rule = canonical_rule(rule)
    if rule == "metropolis":
        # clamp the exponent at 0: dE<0 is always accepted and exp stays finite
        return jnp.exp(-beta * jnp.maximum(delta_e, 0.0))
    if rule == "glauber":
        return jax.nn.sigmoid(-beta * delta_e)
    raise ValueError(f"unknown update rule {rule!r}; expected one of {UPDATE_RULES}")


def accept_threshold(uniforms: jax.Array, beta: jax.Array,
                     rule: str) -> jax.Array:
    """Exp-free acceptance: accept ⟺ s_i·f_i < th  (i.e. dE/2 < th).

    Equivalent to ``u < accept_prob(dE, beta, rule)`` but with the
    transcendental moved out of the sequential update loop — th depends only
    on (u, beta), so a whole block's thresholds vectorize into one pass:
      metropolis: u < e^{-β·dE⁺}  ⟺  dE < -ln(u)/β     (ln u ≤ 0)
      glauber:    u < σ(-β·dE)    ⟺  dE < -logit(u)/β
    Returned thresholds are divided by 2 so callers compare s·f = dE/2
    directly. u ≥ 1 (the padding sentinel) maps to -inf (never accept).
    """
    rule = canonical_rule(rule)
    nib = -0.5 / beta
    if rule == "metropolis":
        th = jnp.log(uniforms) * nib
    elif rule == "glauber":
        th = (jnp.log(uniforms) - jnp.log1p(-uniforms)) * nib
    else:
        raise ValueError(
            f"unknown update rule {rule!r}; expected one of {UPDATE_RULES}")
    return jnp.where(uniforms < 1.0, th, -jnp.inf)


def _as_replica_beta(beta: jax.Array, r: int) -> jax.Array:
    beta = jnp.asarray(beta, jnp.float32)
    if beta.ndim == 0:
        beta = jnp.broadcast_to(beta, (r,))
    return beta


# ---------------------------------------------------------------------------
# Colored sweep
# ---------------------------------------------------------------------------

def color_masks_from_colors(colors, n_padded: int) -> jax.Array:
    """[N_logical] int colors -> [C, N_padded] float masks (padding excluded)."""
    import numpy as np

    colors = np.asarray(colors)
    c = int(colors.max()) + 1 if colors.size else 1
    masks = np.zeros((c, n_padded), dtype=np.float32)
    for ci in range(c):
        masks[ci, : len(colors)] = (colors == ci).astype(np.float32)
    return jnp.asarray(masks)


@functools.partial(jax.jit, static_argnames=("rule",))
def colored_sweep(
    problem: IsingProblem,
    color_masks: jax.Array,  # [C, Np] float {0,1}
    spins: jax.Array,        # [R, Np] float +-1
    beta: jax.Array,         # [] or [R]
    uniforms: jax.Array,     # [R, Np] in [0,1)
    rule: str = "metropolis",
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """One full sweep (every spin proposed once). Returns (spins, dE_sum[R], n_accepted[R])."""
    r = spins.shape[0]
    beta = _as_replica_beta(beta, r)
    active = problem.active_mask > 0

    th = accept_threshold(uniforms, beta[:, None], rule)

    def body(carry, mask):
        spins, de_acc, cnt = carry
        f = jnp.matmul(spins, problem.j, precision=FIELD_PRECISION,
                       preferred_element_type=jnp.float32)
        f = f + problem.h.astype(jnp.float32)
        sf = spins.astype(jnp.float32) * f
        de = 2.0 * sf
        acc = (sf < th) & (mask > 0)[None, :] & active[None, :]
        spins = jnp.where(acc, -spins, spins)
        de_acc = de_acc + jnp.sum(jnp.where(acc, de, 0.0), axis=-1)
        cnt = cnt + jnp.sum(acc, axis=-1).astype(jnp.int32)
        return (spins, de_acc, cnt), None

    init = (spins, jnp.zeros((r,), jnp.float32), jnp.zeros((r,), jnp.int32))
    (spins, de_acc, cnt), _ = lax.scan(body, init, color_masks)
    return spins, de_acc, cnt


# ---------------------------------------------------------------------------
# Blocked-sequential sweep (dense J)
# ---------------------------------------------------------------------------

def _block_inner_xla(sblk, hblk, jbb, thblk):
    """Sequentially update B spins of one block with rank-1 field corrections.

    sblk [R,B] spins, hblk [R,B] local fields (current, incl. this block's own
    contribution), jbb [B,B] intra-block couplings, thblk [R,B] acceptance
    thresholds (-inf where a spin must not flip). Returns (sblk, de_sum[R],
    cnt[R]). The plain reference for kernels.block_gpu.block_inner_pallas.
    """
    r, b = sblk.shape

    def inner(j, carry):
        sblk, hblk, de_acc, cnt = carry
        s_j = lax.dynamic_slice_in_dim(sblk, j, 1, axis=1)[:, 0]
        f_j = lax.dynamic_slice_in_dim(hblk, j, 1, axis=1)[:, 0]
        th_j = lax.dynamic_slice_in_dim(thblk, j, 1, axis=1)[:, 0]
        sf = s_j * f_j
        de = 2.0 * sf
        acc = sf < th_j
        ds = jnp.where(acc, -2.0 * s_j, 0.0)
        new_s = (s_j + ds)[:, None]
        sblk = lax.dynamic_update_slice_in_dim(sblk, new_s, j, axis=1)
        jrow = lax.dynamic_slice_in_dim(jbb, j, 1, axis=0)  # [1, B]
        hblk = hblk + ds[:, None] * jrow
        de_acc = de_acc + jnp.where(acc, de, 0.0)
        cnt = cnt + acc.astype(jnp.int32)
        return (sblk, hblk, de_acc, cnt)

    init = (sblk, hblk, jnp.zeros((r,), jnp.float32), jnp.zeros((r,), jnp.int32))
    sblk, hblk, de_acc, cnt = lax.fori_loop(0, b, inner, init)
    return sblk, de_acc, cnt


@functools.partial(jax.jit, static_argnames=("block_size", "rule", "inner"))
def blocked_sweep(
    problem: IsingProblem,
    spins: jax.Array,     # [R, Np]
    beta: jax.Array,      # [] or [R]
    uniforms: jax.Array,  # [R, Np]
    block_size: int = 128,
    rule: str = "metropolis",
    inner=_block_inner_xla,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """One exact sequential-equivalent Metropolis sweep over dense J.

    Equivalent (in exact arithmetic) to updating spins 0..N-1 one at a time
    — the semantics of the reference CPU sweep (spin_dynamics.py:61-94, minus
    its random site order) — with all O(N^2) work in one matrix product per
    block. ``inner(sblk, hblk, jbb, thblk)`` runs a block's sequential
    updates: ``_block_inner_xla`` or the GPU kernel
    ``kernels.block_gpu.block_inner_pallas``.
    """
    r, n_pad = spins.shape
    if n_pad % block_size != 0:
        raise ValueError(f"padded N={n_pad} not divisible by block_size={block_size}")
    n_blocks = n_pad // block_size
    beta = _as_replica_beta(beta, r)
    h32 = problem.h.astype(jnp.float32)
    th = accept_threshold(uniforms, beta[:, None], rule)
    th = jnp.where(problem.active_mask[None, :] > 0, th, -jnp.inf)

    def body(carry, b):
        spins, de_acc, cnt = carry
        i0 = b * block_size
        j_cols = lax.dynamic_slice(problem.j, (0, i0), (n_pad, block_size))
        hblk = jnp.matmul(spins, j_cols, precision=FIELD_PRECISION,
                          preferred_element_type=jnp.float32)
        hblk = hblk + lax.dynamic_slice(h32, (i0,), (block_size,))[None, :]
        jbb = lax.dynamic_slice(problem.j, (i0, i0), (block_size, block_size))
        jbb = jbb.astype(jnp.float32)
        thblk = lax.dynamic_slice(th, (0, i0), (r, block_size))
        sblk = lax.dynamic_slice(spins, (0, i0), (r, block_size))
        sblk, de_b, cnt_b = inner(sblk, hblk, jbb, thblk)
        spins = lax.dynamic_update_slice(spins, sblk.astype(spins.dtype),
                                         (0, i0))
        return (spins, de_acc + de_b, cnt + cnt_b), None

    init = (spins, jnp.zeros((r,), jnp.float32), jnp.zeros((r,), jnp.int32))
    (spins, de_acc, cnt), _ = lax.scan(body, init, jnp.arange(n_blocks))
    return spins, de_acc, cnt


# ---------------------------------------------------------------------------
# Host-side sequential oracle (tests only)
# ---------------------------------------------------------------------------

def sequential_sweep_oracle(j, h, spins, beta, uniforms, rule="metropolis"):
    """Numpy float64 single-replica sequential Metropolis sweep, spin order 0..N-1.

    Ground truth for blocked_sweep and its GPU kernel; mirrors the reference's
    minimal fallback semantics (core/minimal_ising.py:123-162) with deterministic
    site order and the same dE = 2 s_i field_i bookkeeping.
    """
    import numpy as np

    s = np.asarray(spins, dtype=np.float64).copy()
    j = np.asarray(j, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64)
    u = np.asarray(uniforms, dtype=np.float64)
    n = s.shape[-1]
    de_sum, cnt = 0.0, 0
    with np.errstate(divide="ignore"):
        if rule == "metropolis":
            th = np.log(u) * (-0.5 / beta)
        else:
            th = (np.log(u) - np.log1p(-np.minimum(u, 0.999999999))) * (
                -0.5 / beta)
        th = np.where(u < 1.0, th, -np.inf)
    for i in range(n):
        f = float(j[i] @ s + h[i])
        de = 2.0 * s[i] * f
        if s[i] * f < th[i]:
            s[i] = -s[i]
            de_sum += de
            cnt += 1
    return s, de_sum, cnt
