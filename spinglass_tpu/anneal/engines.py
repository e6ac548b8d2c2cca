"""Sweep-engine abstraction shared by the SA and PT drivers.

An engine is a callable bundle with a declared spin LAYOUT:
  * "rn" — spins [R, N] (replica-major): the dense and [R, N] sparse engines.
  * "nr" — spins [N, R] (spin-major): the transposed sparse engine, whose
    neighbor gathers then read whole replica rows.

The drivers keep annealing state in the engine's layout for the whole jitted
scan (no per-sweep transposes) and only convert at chunk boundaries.

Engine selection policy (make_engine), the one place that decides engine and
backend:
  1. sparse problems → sorted sliced-ELL, [R, N] or [N, R] by replica count.
  2. sweep_method="colored" or auto+small-coloring → colored XLA sweeps
     (k matmuls/sweep; ideal for grids and sparse graphs).
  3. otherwise → the blocked dense sweep; on a GPU its in-block updates run
     as the Pallas kernel kernels.block_gpu, elsewhere as plain XLA.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from spinglass_tpu.core import topology
from spinglass_tpu.core.problem import IsingProblem
from spinglass_tpu.kernels import sweeps as sweep_kernels


class SweepEngine:
    """Base: sweep(spins, beta, key) -> (spins, dE[R], n_accepted[R]).

    Jit-boundary contract: an engine's device arrays must cross jit as
    ARGUMENTS, not closure constants — closure-captured arrays get embedded
    in the HLO, so the J matrix et al. would ride along with every compile
    and serialize into every executable. Drivers therefore do::

        ops = engine.operands()              # pytree of arrays (host, once)
        @jax.jit
        def step(state, ops):
            eng = engine.bind(ops)           # shallow copy, traced arrays
            ... eng.sweep(...)
        step(state, ops)

    ``operands()`` returns the engine's array pytree; ``bind(ops)`` returns
    a shallow copy whose arrays are the (traced) values from ``ops``.
    Structural data (offsets, shapes, configs) stays in the closure — it
    must remain static."""

    layout = "rn"
    name = "base"
    _operand_attrs: Tuple[str, ...] = ("problem",)

    def __init__(self, problem: IsingProblem):
        self.problem = problem

    def operands(self):
        return {a: getattr(self, a) for a in self._operand_attrs}

    def bind(self, ops):
        import copy

        eng = copy.copy(self)
        for a in self._operand_attrs:
            setattr(eng, a, ops[a])
        eng._rebind()
        return eng

    def _rebind(self) -> None:
        """Hook for subclasses whose sweep closures capture operand arrays
        (rebuild them from the now-bound attributes)."""


    def to_layout(self, spins_rn: jax.Array) -> jax.Array:
        return spins_rn.T if self.layout == "nr" else spins_rn

    def from_layout(self, spins: jax.Array) -> jax.Array:
        return spins.T if self.layout == "nr" else spins

    def energy(self, spins: jax.Array) -> jax.Array:
        """Exact energies in this engine's layout (sparse engines override
        to avoid any dense matmul)."""
        from spinglass_tpu.core import energy as energy_ops

        if self.layout == "nr":
            return energy_ops.energy_t(self.problem, spins)
        return energy_ops.energy(self.problem, spins)

    def sweep(self, spins, beta, key):
        raise NotImplementedError


def bind_call(raw_fn, problem, engine):
    """Jit ``raw_fn(state, prob, eng_ops)`` under the operands contract.

    Returns ``call(state)`` with ``call.raw`` (the unjitted body, for
    callers that scan several steps inside ONE outer jit — they must pass
    ``call.call_args`` as traced arguments there, or the arrays re-embed
    as constants) and ``call.call_args = (problem, eng_ops)``.

    When the engine's operands carry the problem pytree it must be the
    SAME object as ``problem`` — two diverging instances inside one traced
    body (env math vs sweep math) would be a silent correctness bug, so
    this fails loudly instead."""
    ops = (engine.operands() if engine is not None
           and hasattr(engine, "operands") else None)
    if isinstance(ops, dict):
        # sparse engines carry the instance under "ell"; the check only
        # applies when the caller's problem IS that EllProblem (an ell
        # DERIVED from a dense problem is legitimately a different object)
        anchor_key = ("problem" if "problem" in ops
                      else "ell" if "ell" in ops
                      and hasattr(problem, "idx") else None)
        if anchor_key is not None and ops[anchor_key] is not problem:
            raise ValueError(
                "engine was built for a different problem object than the "
                "one passed to bind_call — env math and sweep math would "
                "diverge")
    jitted = jax.jit(raw_fn)
    call_args = (problem, ops)

    def call(state):
        return jitted(state, *call_args)

    call.raw = raw_fn
    call.call_args = call_args
    return call


class ColoredEngine(SweepEngine):
    """Vectorized same-color simultaneous updates (exact for proper colorings)."""

    name = "colored"

    _operand_attrs = ("problem", "masks")

    def __init__(self, problem: IsingProblem, colors: np.ndarray,
                 rule: str = "metropolis"):
        super().__init__(problem)
        self.rule = rule
        self.n_colors = int(colors.max()) + 1 if colors.size else 1
        self.masks = sweep_kernels.color_masks_from_colors(
            colors, problem.n_padded)

    def sweep(self, spins, beta, key):
        uniforms = jax.random.uniform(key, spins.shape, jnp.float32)
        return sweep_kernels.colored_sweep(
            self.problem, self.masks, spins, beta, uniforms, rule=self.rule)


class BlockedEngine(SweepEngine):
    """Exact sequential-equivalent blocked dense sweep. ``kernel=True`` runs
    each block's sequential updates as the GPU kernel
    (kernels.block_gpu.block_inner_pallas); ``interpret=True`` runs that
    kernel in Pallas interpret mode, for tests off the GPU."""

    def __init__(self, problem: IsingProblem, block_size: int = 128,
                 rule: str = "metropolis", kernel: bool = False,
                 interpret: bool = False):
        super().__init__(problem)
        self.block_size = block_size
        self.rule = rule
        self.name = "blocked_gpu" if kernel else "blocked"
        self.inner = sweep_kernels._block_inner_xla
        if kernel:
            from spinglass_tpu.kernels.block_gpu import block_inner_pallas

            self.inner = (functools.partial(block_inner_pallas,
                                            interpret=True)
                          if interpret else block_inner_pallas)

    def sweep(self, spins, beta, key):
        uniforms = jax.random.uniform(key, spins.shape, jnp.float32)
        return self.sweep_with_uniforms(spins, beta, uniforms)

    def sweep_with_uniforms(self, spins, beta, uniforms):
        return sweep_kernels.blocked_sweep(
            self.problem, spins, beta, uniforms,
            block_size=self.block_size, rule=self.rule, inner=self.inner)


# Engines whose traced program + operand shapes depend ONLY on problem
# shape/dtype and config — safe to share compiled solver executables
# across equal-trace-signature problems (jit_cache signature keying).
# "colored" is EXCLUDED: its mask count/shapes come from a greedy coloring
# of the problem CONTENT (two same-shape problems can dispatch to colored
# vs blocked, or color differently — an r5 suite failure caught exactly
# that: a cached blocked chunk received a colored engine's operands).
# Sparse engines never reach signature mode (EllProblem has no
# trace_signature — bucket layout is content-derived).
SIGNATURE_SHARED_ENGINES = frozenset({"blocked", "blocked_gpu"})


SPARSE_DENSITY_THRESHOLD = 0.05
SPARSE_MIN_SPINS = 2048


# Replica count from which the [N, R] sparse engine is chosen over the
# [R, N] one. Measured end to end on an H100 (10k spins, degree 6, 1000-sweep
# pt.run, warm): [R, N] 0.075 / 0.270 / 0.350 / 1.771 s and [N, R] 0.127 /
# 0.186 / 0.220 / 0.389 s at 16 / 32 / 128 / 1024 replicas; time to target
# at 128 replicas 0.75 s [R, N] against 0.32 s [N, R] (PERF.md, "Sparse
# engine choice").
SPARSE_T_MIN_REPLICAS = 32


def make_engine(problem: IsingProblem, *, sweep_method: str = "auto",
                update_rule: str = "metropolis", block_size: int = 0,
                use_pallas: str = "auto",
                max_colors: int = 8,
                r_hint: int = 0) -> SweepEngine:
    """Pick the sweep engine (replaces the reference's CUDA-vs-torch dispatch,
    annealing/gpu_annealer.py:199-234 / cuda_kernels.py:150-171).

    ``r_hint``: expected total replica count. Sparse problems with
    r_hint >= SPARSE_T_MIN_REPLICAS get the transposed SortedSparseTEngine,
    narrower runs the [R, N] SortedSparseEngine.

    ``use_pallas`` governs the dense engine's GPU kernel: "auto" uses it on
    a GPU, "never" keeps plain XLA, and "always" demands it — off a GPU that
    raises, since the kernel has no compiled route there."""
    from spinglass_tpu.kernels.sparse import (EllProblem, SortedSparseEngine,
                                              SortedSparseTEngine,
                                              SparseEngine)
    from spinglass_tpu.kernels.sweeps import canonical_rule

    update_rule = canonical_rule(update_rule)
    if use_pallas not in ("auto", "never", "always"):
        raise ValueError(f"use_pallas must be 'auto', 'never' or 'always', "
                         f"got {use_pallas!r}")
    on_gpu = jax.default_backend() == "gpu"
    if use_pallas == "always" and not on_gpu:
        raise ValueError(
            f"use_pallas='always' needs a GPU: the dense sweep kernel has no "
            f"compiled route on {jax.default_backend()!r}")

    def _sorted(p):
        if sweep_method == "sparse_t" or (
                sweep_method in ("auto", "sparse")
                and r_hint >= SPARSE_T_MIN_REPLICAS):
            return SortedSparseTEngine(p, rule=update_rule)
        return SortedSparseEngine(p, rule=update_rule)

    if isinstance(problem, EllProblem):
        if sweep_method == "sparse_compact":
            return SparseEngine(problem, rule=update_rule)
        return _sorted(problem)
    if sweep_method == "sparse_compact":
        return SparseEngine(problem, rule=update_rule)
    if sweep_method in ("sparse", "sparse_t") or (
            sweep_method == "auto"
            and problem.n_spins >= SPARSE_MIN_SPINS
            and topology.density(
                np.asarray(problem.j)[: problem.n_spins, : problem.n_spins])
            < SPARSE_DENSITY_THRESHOLD):
        return _sorted(problem)
    if sweep_method in ("auto", "colored"):
        j_np = np.asarray(problem.j)[: problem.n_spins, : problem.n_spins]
        try:
            colors = topology.greedy_coloring(
                j_np, max_colors=max_colors if sweep_method == "auto" else 256)
            n_colors = int(colors.max()) + 1 if colors.size else 1
            if sweep_method == "colored" or n_colors <= max_colors:
                return ColoredEngine(problem, colors, rule=update_rule)
        except ValueError:
            if sweep_method == "colored":
                raise
    return BlockedEngine(problem, block_size=block_size or 128,
                         rule=update_rule,
                         kernel=use_pallas == "always"
                         or (use_pallas == "auto" and on_gpu))
