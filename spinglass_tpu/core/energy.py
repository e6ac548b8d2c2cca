"""Pure-functional energy / local-field ops, batched over arbitrary leading axes.

Replaces the reference's EnergyComputer (core/energy_computer.py:29-312) and the
scalar-cached IsingModel.compute_energy (core/ising_model.py:149-174). Everything
here is a single matmul over a [..., N] spin batch — the formulation the
reference itself sketched in VectorizedOperations
(optimization/high_performance_computing.py:338-386) but never used on its hot path.

Convention: E(s) = -1/2 s^T J s - h^T s ; field_i = (J s)_i + h_i ;
dE(flip i) = 2 s_i field_i.

The products run at Precision.HIGHEST (full f32): these are reported results,
and the sweeps' bookkeeping E0 + dE = E1 is checked against them. A default
f32 product on a GPU may run in TF32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from spinglass_tpu.core.problem import IsingProblem

HIGHEST = jax.lax.Precision.HIGHEST


def local_fields(problem: IsingProblem, spins: jax.Array, *,
                 precision=HIGHEST) -> jax.Array:
    """[..., N] -> [..., N]: field_i = sum_j J_ij s_j + h_i.

    One batched matmul (reference loops per-spin with .item() syncs,
    core/ising_model.py:176-185).
    """
    f = jnp.matmul(spins, problem.j, precision=precision,
                   preferred_element_type=jnp.float32)
    return f + problem.h.astype(jnp.float32)


def energy(problem: IsingProblem, spins: jax.Array, *,
           precision=HIGHEST) -> jax.Array:
    """[..., N] -> [...]: E = -1/2 s.(J s) - h.s, accumulated in float32."""
    js = jnp.matmul(spins, problem.j, precision=precision,
                    preferred_element_type=jnp.float32)
    s32 = spins.astype(jnp.float32)
    quad = jnp.sum(s32 * js, axis=-1)
    lin = jnp.sum(s32 * problem.h.astype(jnp.float32), axis=-1)
    return -0.5 * quad - lin


def delta_energy(problem: IsingProblem, spins: jax.Array) -> jax.Array:
    """[..., N] -> [..., N]: dE_i of flipping spin i, for ALL i at once.

    dE_i = 2 s_i field_i (reference computes one at a time,
    core/ising_model.py:125-147).
    """
    return 2.0 * spins.astype(jnp.float32) * local_fields(problem, spins)


def energy_t(problem: IsingProblem, spins_t: jax.Array) -> jax.Array:
    """Energy for spin-major layout: [Np, R] -> [R] (no transpose needed):
    E = -1/2 s.(J s) - h.s over axis 0."""
    js = jnp.matmul(problem.j, spins_t, precision=HIGHEST,
                    preferred_element_type=jnp.float32)
    s32 = spins_t.astype(jnp.float32)
    quad = jnp.sum(s32 * js, axis=0)
    lin = jnp.sum(s32 * problem.h.astype(jnp.float32)[:, None], axis=0)
    return -0.5 * quad - lin


def magnetization(problem: IsingProblem, spins: jax.Array) -> jax.Array:
    """Mean spin over *logical* (non-padding) sites."""
    m = problem.active_mask.astype(jnp.float32)
    return jnp.sum(spins.astype(jnp.float32) * m, axis=-1) / problem.n_spins


def energy_decomposition(problem: IsingProblem, spins: jax.Array) -> dict:
    """Per-spin energy contributions, mirroring EnergyStats
    (reference core/energy_computer.py:19-26, 89-118)."""
    s32 = spins.astype(jnp.float32)
    js = jnp.matmul(spins, problem.j, precision=HIGHEST,
                    preferred_element_type=jnp.float32)
    inter = -0.5 * s32 * js
    field = -s32 * problem.h.astype(jnp.float32)
    per_spin = inter + field
    return {
        "total": jnp.sum(per_spin, axis=-1),
        "interaction": jnp.sum(inter, axis=-1),
        "field": jnp.sum(field, axis=-1),
        "per_spin": per_spin,
    }


def energy_gradient(problem: IsingProblem, spins: jax.Array) -> jax.Array:
    """dE/ds_i = -field_i (reference core/energy_computer.py:120-140)."""
    return -local_fields(problem, spins)
