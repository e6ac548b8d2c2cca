"""Ising problem container — the JAX analog of the reference's IsingModel.

The reference (spin_glass_rl/core/ising_model.py:36-259) is a mutable torch-based
container with per-element ``set_coupling`` calls and an in-place ``spins`` tensor.
Here the problem is an immutable pytree: a dense, symmetric, zero-diagonal coupling
matrix laid out for matrix products, external fields, and optional metadata. Spin *state*
lives outside the problem (see spinglass_tpu.anneal.state.AnnealState) so the whole
thing jits/vmaps/shards cleanly.

Conventions (identical to the reference, ising_model.py:149-174):
    E(s)        = -1/2 * s^T J s - h^T s            (s in {-1,+1}^N)
    field_i(s)  = sum_j J_ij s_j + h_i
    dE(flip i)  = 2 * s_i * field_i(s)

J is stored dense (a 10k^2 f32 J is 400 MB of device memory); a padded ELL
sparse form is provided for larger/sparser instances (see
spinglass_tpu.kernels.sparse).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from spinglass_tpu.core import pytree

# Pad spin counts to a multiple of 128 so every block and tile is aligned.
LANE = 128


def round_up(x: int, m: int = LANE) -> int:
    return ((x + m - 1) // m) * m


@pytree.dataclass
class IsingProblem:
    """Immutable Ising/QUBO problem pytree.

    Attributes:
      j: [N, N] symmetric coupling matrix, zero diagonal. ``N`` may include
         padding; padded rows/cols are all-zero so they never affect energies.
      h: [N] external fields (zero on padding).
      n_spins: the *logical* spin count (static aux data, <= N).
      active_mask: [N] float {0,1} mask of logical spins. Padded spins have
         mask 0; sweeps must never flip them (their field and coupling are zero
         so accepting a flip would be a no-op for energy, but the mask keeps
         magnetization and decode exact).
    """

    j: jax.Array
    h: jax.Array
    active_mask: jax.Array
    n_spins: int = pytree.static_field()

    @property
    def n_padded(self) -> int:
        return self.j.shape[-1]

    def trace_signature(self):
        """Hashable signature of everything that shapes a compiled solver
        program for this problem (shapes/dtypes/static aux — NOT content).
        Same-signature problems can share jitted solver executables because
        all arrays cross the jit boundary as arguments (ADR-0004); see
        anneal.jit_cache.SolverCache. Sparse EllProblem deliberately has no
        trace_signature: its bucket/coloring layout is content-derived."""
        return ("ising", self.n_spins, self.j.shape,
                str(self.j.dtype), str(self.h.dtype))

    # ---- constructors -----------------------------------------------------

    @staticmethod
    def from_dense(
        j: np.ndarray | jax.Array,
        h: Optional[np.ndarray | jax.Array] = None,
        *,
        dtype=jnp.float32,
        pad: bool = True,
        validate: bool = True,
    ) -> "IsingProblem":
        """Build a problem from a dense coupling matrix.

        Symmetrizes J as (J + J^T)/2, zeroes the diagonal, and pads to a
        multiple of 128 lanes. Mirrors IsingModelConfig/IsingModel.__init__
        (reference core/ising_model.py:56-104) but does all of it once,
        vectorized, instead of per-coupling calls.
        """
        j = np.asarray(j, dtype=np.float64)
        if j.ndim != 2 or j.shape[0] != j.shape[1]:
            raise ValueError(f"J must be square, got {j.shape}")
        n = j.shape[0]
        if validate and not np.all(np.isfinite(j)):
            raise ValueError("J contains non-finite entries")
        j = 0.5 * (j + j.T)
        np.fill_diagonal(j, 0.0)
        if h is None:
            h = np.zeros((n,), dtype=np.float64)
        else:
            h = np.asarray(h, dtype=np.float64)
            if h.shape != (n,):
                raise ValueError(f"h must have shape ({n},), got {h.shape}")
            if validate and not np.all(np.isfinite(h)):
                raise ValueError("h contains non-finite entries")
        n_pad = round_up(n) if pad else n
        jp = np.zeros((n_pad, n_pad), dtype=np.float64)
        jp[:n, :n] = j
        hp = np.zeros((n_pad,), dtype=np.float64)
        hp[:n] = h
        mask = np.zeros((n_pad,), dtype=np.float64)
        mask[:n] = 1.0
        return IsingProblem(
            j=jnp.asarray(jp, dtype=dtype),
            h=jnp.asarray(hp, dtype=dtype),
            active_mask=jnp.asarray(mask, dtype=dtype),
            n_spins=n,
        )

    @staticmethod
    def from_terms(
        n_spins: int,
        quad_i: np.ndarray,
        quad_j: np.ndarray,
        quad_val: np.ndarray,
        lin_i: Optional[np.ndarray] = None,
        lin_val: Optional[np.ndarray] = None,
        *,
        dtype=jnp.float32,
    ) -> "IsingProblem":
        """Build from sparse term lists with a single scatter-add.

        Replaces the reference's per-term ``set_coupling`` loop (each of which
        did a dense round-trip, core/ising_model.py:89-104 — the dominant encode
        cost per SURVEY §3.1). quad terms are accumulated symmetrically:
        J[i, j] += v and J[j, i] += v.
        """
        qi = np.asarray(quad_i, dtype=np.int64)
        qj = np.asarray(quad_j, dtype=np.int64)
        qv = np.asarray(quad_val, dtype=np.float64)
        from spinglass_tpu import native

        j = native.scatter_add_symmetric(qi, qj, qv, n_spins)
        h = np.zeros((n_spins,), dtype=np.float64)
        if lin_i is not None:
            np.add.at(h, np.asarray(lin_i, dtype=np.int64), np.asarray(lin_val, dtype=np.float64))
        # from_dense halves (J + J^T); we already built the symmetric matrix.
        return IsingProblem.from_dense(j, h, dtype=dtype, validate=False)

    # ---- serialization ----------------------------------------------------

    def to_dict(self) -> dict:
        """Dict form mirroring IsingModel.to_dict (core/ising_model.py:213-231)."""
        n = self.n_spins
        return {
            "n_spins": n,
            "j": np.asarray(self.j)[:n, :n],
            "h": np.asarray(self.h)[:n],
        }

    @staticmethod
    def from_dict(d: dict, *, dtype=jnp.float32) -> "IsingProblem":
        return IsingProblem.from_dense(d["j"], d["h"], dtype=dtype)

    def save(self, path: str) -> None:
        d = self.to_dict()
        np.savez_compressed(path, n_spins=d["n_spins"], j=d["j"], h=d["h"])

    @staticmethod
    def load(path: str, *, dtype=jnp.float32) -> "IsingProblem":
        with np.load(path) as z:
            return IsingProblem.from_dense(z["j"], z["h"], dtype=dtype)


def random_spins(key: jax.Array, shape: tuple, mask: Optional[jax.Array] = None, dtype=jnp.float32) -> jax.Array:
    """Uniform random spins in {-1, +1}; padded positions forced to +1."""
    s = jnp.where(jax.random.bernoulli(key, 0.5, shape), 1.0, -1.0).astype(dtype)
    if mask is not None:
        s = jnp.where(mask > 0, s, 1.0)
    return s
