"""The dense sweep's in-block sequential updates as one GPU kernel.

``sweeps.blocked_sweep`` splits a dense sweep into blocks of B spins. Each
block's fields come from one [R, N] x [N, B] product, which XLA hands to
cuBLAS. What is left is B dependent single-spin updates: spin j reads a field
that every earlier accepted flip of the block has corrected. As plain XLA
(``sweeps._block_inner_xla``) that is a loop of B tiny steps, each at least
one kernel launch on a GPU.

Here the whole block is one Pallas kernel on the Triton route. Each program
owns one replica and keeps its [1, B] fields, spins and thresholds in
registers. Step j extracts column j by a masked sum, decides, and applies
the rank-1 correction ``h += ds_j * J[j, block]`` with row j of the block's
[B, B] diagonal couplings; the loop is unrolled by UNROLL so the loads of
later rows issue early. One replica per program and one warp measured
fastest on the H100 at both 4096 x 1024 and 512 x 256 (PERF.md, "Kernel
decisions").

Thresholds come in from ``sweeps.accept_threshold`` (the padding mask
already folded in as -inf), so the kernel needs no random numbers and makes
the same decisions as the XLA loop under the same uniforms.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

NUM_WARPS = 1
UNROLL = 4


def _kernel(s_ref, h_ref, th_ref, jbb_ref, s_out, de_out, cnt_out):
    b = s_ref.shape[1]
    cols = jnp.arange(b, dtype=jnp.int32)[None, :]
    s_all = s_ref[...]
    th_all = th_ref[...]

    def one(j, carry):
        h, ds_all, de, cnt = carry
        sel = cols == j
        s_j = jnp.sum(jnp.where(sel, s_all, 0.0), axis=1, keepdims=True)
        th_j = jnp.sum(jnp.where(sel, th_all, 0.0), axis=1, keepdims=True)
        f_j = jnp.sum(jnp.where(sel, h, 0.0), axis=1, keepdims=True)
        sf = s_j * f_j
        acc = sf < th_j
        ds = jnp.where(acc, -2.0 * s_j, 0.0)             # [1, 1]
        h = h + ds * jbb_ref[pl.ds(j, 1), :]             # rank-1 correction
        ds_all = jnp.where(sel, ds, ds_all)
        de = de + jnp.where(acc, 2.0 * sf, 0.0)
        cnt = cnt + acc.astype(jnp.int32)
        return h, ds_all, de, cnt

    unroll = min(UNROLL, b)

    def step(i, carry):
        for k in range(unroll):
            carry = one(i * unroll + k, carry)
        return carry

    init = (h_ref[...], jnp.zeros_like(s_all),
            jnp.zeros((1, 1), jnp.float32), jnp.zeros((1, 1), jnp.int32))
    _, ds_all, de, cnt = lax.fori_loop(0, b // unroll, step, init)
    s_out[...] = s_all + ds_all
    de_out[...] = de
    cnt_out[...] = cnt


@functools.partial(jax.jit, static_argnames=("interpret",))
def block_inner_pallas(sblk, hblk, jbb, thblk, *, interpret=False):
    """Sequentially update one block of B spins for R replicas.

    sblk [R, B] spins (f32 +-1), hblk [R, B] fields including the block's own
    couplings, jbb [B, B] the block's diagonal couplings, thblk [R, B]
    acceptance thresholds (-inf where a spin must not flip). B must be a
    power of two. Returns (sblk [R, B], dE [R], n_accepted [R]), as
    ``sweeps._block_inner_xla``. ``interpret=True`` runs the kernel in Pallas
    interpret mode, for tests off the GPU.
    """
    r, b = sblk.shape
    row = pl.BlockSpec((1, b), lambda i: (i, 0))
    one = pl.BlockSpec((1, 1), lambda i: (i, 0))
    s, de, cnt = pl.pallas_call(
        _kernel,
        out_shape=(jax.ShapeDtypeStruct((r, b), jnp.float32),
                   jax.ShapeDtypeStruct((r, 1), jnp.float32),
                   jax.ShapeDtypeStruct((r, 1), jnp.int32)),
        grid=(r,),
        in_specs=[row, row, row, pl.BlockSpec((b, b), lambda i: (0, 0))],
        out_specs=(row, one, one),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS,
                                           num_stages=1),
        interpret=interpret,
        name="block_inner",
    )(sblk.astype(jnp.float32), hblk, thblk, jbb.astype(jnp.float32))
    return s, de[:, 0], cnt[:, 0]
