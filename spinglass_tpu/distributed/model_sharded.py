"""Model-parallel sweeps: the coupling matrix sharded over a device mesh.

The reference's 'model_parallel' strategy (multi_gpu.py:169-232) sliced spins
into contiguous blocks and **dropped all cross-block couplings** (physically
incorrect; SURVEY §2.6). These are the exact formulations, for instances
whose J exceeds one device's memory:

* blocked_sweep_sharded — J **row-sharded**; each device computes its partial
  contribution to a block's local fields, a psum completes them, and
  the cheap sequential intra-block update runs replicated (identical RNG →
  identical spins on every device). Exact sequential-equivalent Metropolis;
  per-sweep communication is n_blocks x [R, B] psums — independent of J size.
* colored_sweep_sharded — spins + J **column-sharded**; each color pass
  all-gathers the (small, +-1) spin vector and computes fields for its local
  columns. Exact for proper colorings.

Both run under shard_map on a Mesh(("spin",)); multi-host works with the same
code after jax.distributed.initialize().
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from spinglass_tpu.core.problem import IsingProblem
from spinglass_tpu.kernels.sweeps import FIELD_PRECISION, accept_prob


def make_mesh(devices=None, axis: str = "spin") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


def shard_problem_rows(problem: IsingProblem, mesh: Mesh,
                       axis: str = "spin") -> IsingProblem:
    """Place J row-sharded on the mesh (h/mask replicated)."""
    return IsingProblem(
        j=jax.device_put(problem.j, NamedSharding(mesh, P(axis, None))),
        h=jax.device_put(problem.h, NamedSharding(mesh, P())),
        active_mask=jax.device_put(problem.active_mask,
                                   NamedSharding(mesh, P())),
        n_spins=problem.n_spins,
    )


def blocked_sweep_sharded(problem: IsingProblem, mesh: Mesh,
                          spins: jax.Array, beta: jax.Array,
                          uniforms: jax.Array, *, block_size: int = 128,
                          rule: str = "metropolis", axis: str = "spin"
                          ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Exact blocked-sequential sweep with J row-sharded over ``axis``.

    spins/uniforms [R, Np] replicated; J [Np, Np] sharded on rows. Returns
    (spins, dE[R], n_accepted[R]) — identical (up to f32) to
    kernels.sweeps.blocked_sweep on one device.
    """
    r, n_pad = spins.shape
    n_blocks = n_pad // block_size
    d = mesh.devices.size
    rows_per = n_pad // d
    if n_pad % d or rows_per % block_size:
        raise ValueError(
            f"padded N={n_pad} must divide over {d} devices into row shards "
            f"that are multiples of block_size={block_size}")
    beta = jnp.broadcast_to(jnp.asarray(beta, jnp.float32), (r,))
    h32 = problem.h.astype(jnp.float32)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(axis, None), P(), P(), P(), P()),
        out_specs=(P(), P(), P()),
        check_vma=False)
    def run(j_rows, h_full, spins, uniforms, beta):
        # j_rows: [Np/D, Np] local row shard. All other operands replicated.
        my = lax.axis_index(axis)
        row0 = my * rows_per

        def body(carry, b):
            spins, de_acc, cnt = carry
            i0 = b * block_size
            # partial fields from the local row shard:
            # H[r, k] = sum_{i in my rows} s[r, i] * J[i, i0+k]
            s_local = lax.dynamic_slice(spins, (0, row0), (r, rows_per))
            j_cols = lax.dynamic_slice(j_rows, (0, i0),
                                       (rows_per, block_size))
            h_part = jnp.matmul(s_local, j_cols, precision=FIELD_PRECISION,
                                preferred_element_type=jnp.float32)
            hblk = lax.psum(h_part, axis)
            hblk = hblk + lax.dynamic_slice(h_full, (i0,),
                                            (block_size,))[None, :]
            # intra-block couplings: rows_per % block_size == 0 (checked in
            # the wrapper), so each block's rows live wholly on one device;
            # the owner contributes them, psum assembles the [B, B] block
            local_r0 = jnp.clip(i0 - row0, 0, rows_per - block_size)
            jbb_mine = lax.dynamic_slice(j_rows, (local_r0, i0),
                                         (block_size, block_size))
            is_owner = ((i0 >= row0) & (i0 < row0 + rows_per)).astype(
                jnp.float32)
            jbb = lax.psum(jbb_mine * is_owner, axis)

            ublk = lax.dynamic_slice(uniforms, (0, i0), (r, block_size))
            sblk = lax.dynamic_slice(spins, (0, i0), (r, block_size))

            def inner(jj, c):
                sblk, hblk, de_acc, cnt = c
                s_j = lax.dynamic_slice_in_dim(sblk, jj, 1, axis=1)[:, 0]
                f_j = lax.dynamic_slice_in_dim(hblk, jj, 1, axis=1)[:, 0]
                u_j = lax.dynamic_slice_in_dim(ublk, jj, 1, axis=1)[:, 0]
                de = 2.0 * s_j * f_j
                acc = u_j < accept_prob(de, beta, rule)
                ds = jnp.where(acc, -2.0 * s_j, 0.0)
                sblk = lax.dynamic_update_slice_in_dim(
                    sblk, (s_j + ds)[:, None], jj, axis=1)
                jrow = lax.dynamic_slice_in_dim(jbb, jj, 1, axis=0)
                hblk = hblk + ds[:, None] * jrow
                de_acc = de_acc + jnp.where(acc, de, 0.0)
                cnt = cnt + acc.astype(jnp.int32)
                return (sblk, hblk, de_acc, cnt)

            sblk, hblk, de_acc, cnt = lax.fori_loop(
                0, block_size, inner, (sblk, hblk, de_acc, cnt))
            spins = lax.dynamic_update_slice(spins, sblk, (0, i0))
            return (spins, de_acc, cnt), None

        init = (spins, jnp.zeros((r,), jnp.float32),
                jnp.zeros((r,), jnp.int32))
        (spins, de_acc, cnt), _ = lax.scan(body, init, jnp.arange(n_blocks))
        return spins, de_acc, cnt

    # padding: make padded-site uniforms unacceptable
    uniforms = jnp.where(problem.active_mask[None, :] > 0, uniforms, 2.0)
    return run(problem.j, h32, spins, uniforms, beta)


def colored_sweep_sharded(problem: IsingProblem, mesh: Mesh,
                          color_masks: jax.Array, spins_sharded: jax.Array,
                          beta: jax.Array, uniforms_sharded: jax.Array, *,
                          rule: str = "metropolis", axis: str = "spin"
                          ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Colored sweep with spins + J column-sharded over ``axis``.

    spins_sharded/uniforms_sharded [R, Np] sharded on the spin axis; J
    sharded on columns; color_masks [C, Np] sharded on the spin axis too.
    Each color pass all-gathers the spin vector (R*Np values, the only
    communication) and updates local columns. Exact for proper colorings.
    """
    r, n_pad = spins_sharded.shape
    beta = jnp.broadcast_to(jnp.asarray(beta, jnp.float32), (r,))
    h32 = problem.h.astype(jnp.float32)

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, axis), P(axis), P(None, axis), P(None, axis),
                  P(None, axis), P()),
        out_specs=(P(None, axis), P(), P()),
        check_vma=False)
    def run(j_cols, h_local, masks_local, spins_local, u_local, beta):

        def body(carry, mask):
            s_local, de_acc, cnt = carry
            s_full = lax.all_gather(s_local, axis, axis=1, tiled=True)
            f = jnp.matmul(s_full, j_cols, precision=FIELD_PRECISION,
                           preferred_element_type=jnp.float32) + h_local
            de = 2.0 * s_local * f
            p = accept_prob(de, beta[:, None], rule)
            acc = (u_local < p) & (mask > 0)[None, :]
            s_local = jnp.where(acc, -s_local, s_local)
            de_acc = de_acc + lax.psum(
                jnp.sum(jnp.where(acc, de, 0.0), axis=-1), axis)
            cnt = cnt + lax.psum(jnp.sum(acc, axis=-1).astype(jnp.int32),
                                 axis)
            return (s_local, de_acc, cnt), None

        init = (spins_local, jnp.zeros((r,), jnp.float32),
                jnp.zeros((r,), jnp.int32))
        (s_local, de_acc, cnt), _ = lax.scan(body, init, masks_local)
        return s_local, de_acc, cnt

    uniforms_sharded = jnp.where(problem.active_mask[None, :] > 0,
                                 uniforms_sharded, 2.0)
    # masks are scanned over axis 0; shard their spin axis (axis 1)
    return run(problem.j, h32, color_masks, spins_sharded, uniforms_sharded,
               beta)
