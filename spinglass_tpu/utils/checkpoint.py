"""Pytree checkpointing: Orbax when available, npz fallback.

Unifies the reference's four separate mechanisms (SURVEY §5 checkpoint/resume:
AnnealingResult npz, IsingModel dicts, RL JSON checkpoints, batch-processor
progress) into one pytree saver that handles any framework state (SAState,
PTState, PPO TrainState, ...)."""

from __future__ import annotations

import os
from typing import Any, Optional

import jax
import numpy as np

from spinglass_tpu.utils.exceptions import CheckpointError


def _try_orbax():
    try:
        import orbax.checkpoint as ocp

        return ocp
    except Exception:
        return None


def _is_typed_key(v) -> bool:
    import jax.numpy as jnp

    return hasattr(v, "dtype") and jnp.issubdtype(v.dtype, jax.dtypes.prng_key)


def save_pytree(tree: Any, path: str) -> None:
    """Save any jax pytree (typed PRNG keys included).
    Directory path → Orbax; .npz path → flat npz."""
    if path.endswith(".npz"):
        flat, _ = jax.tree_util.tree_flatten_with_path(tree)
        arrays = {}
        for k, v in flat:
            if _is_typed_key(v):
                v = jax.random.key_data(v)
            arrays[jax.tree_util.keystr(k)] = np.asarray(v)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez_compressed(path, **arrays)
        return
    ocp = _try_orbax()
    if ocp is None:
        raise CheckpointError("orbax unavailable; use an .npz path")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(os.path.abspath(path), tree, force=True)
    ckptr.wait_until_finished()


def load_pytree(template: Any, path: str) -> Any:
    """Load into the structure of ``template`` (shapes/dtypes must match)."""
    if path.endswith(".npz"):
        import jax.numpy as jnp

        with np.load(path) as z:
            flat, treedef = jax.tree_util.tree_flatten_with_path(template)
            leaves = []
            for k, v in flat:
                key = jax.tree_util.keystr(k)
                if key not in z:
                    raise CheckpointError(f"missing leaf {key} in {path}")
                if _is_typed_key(v):
                    leaves.append(jax.random.wrap_key_data(
                        jnp.asarray(z[key])))
                elif isinstance(v, (jax.Array,)):
                    tmpl = np.asarray(v)
                    stored = z[key]
                    # jnp.asarray would silently accept a wrong shape (and
                    # cast across dtype kinds, e.g. a float-spins checkpoint
                    # into an int8-layout engine); fail
                    # loudly instead
                    if stored.shape != tmpl.shape:
                        raise CheckpointError(
                            f"leaf {key}: stored shape {stored.shape} != "
                            f"expected {tmpl.shape} in {path} — the "
                            f"checkpoint was written under a different "
                            f"layout/config")
                    if stored.dtype.kind != tmpl.dtype.kind:
                        raise CheckpointError(
                            f"leaf {key}: stored dtype {stored.dtype} is a "
                            f"different kind than expected {tmpl.dtype} in "
                            f"{path} — the checkpoint was written under a "
                            f"different engine layout")
                    leaves.append(jnp.asarray(stored, dtype=tmpl.dtype))
                else:
                    # host-side leaves (np scalars/arrays, e.g. int64 step
                    # counters) restore on host — jnp.asarray would silently
                    # truncate int64 to int32 under jax's default x64=off
                    leaves.append(np.asarray(z[key],
                                             dtype=np.asarray(v).dtype))
            return jax.tree_util.tree_unflatten(treedef, leaves)
    ocp = _try_orbax()
    if ocp is None:
        raise CheckpointError("orbax unavailable; use an .npz path")
    ckptr = ocp.StandardCheckpointer()
    return ckptr.restore(os.path.abspath(path),
                         target=jax.tree.map(np.asarray, template))


class CheckpointManager:
    """Periodic checkpoints with retention (the analog of the reference's
    batch-processor/training cadence, batch_processor.py:521-531)."""

    def __init__(self, directory: str, every: int = 10, keep: int = 3,
                 use_orbax: Optional[bool] = None):
        self.directory = directory
        self.every = every
        self.keep = keep
        self.use_orbax = (_try_orbax() is not None if use_orbax is None
                          else use_orbax)
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        if self.use_orbax:
            return os.path.join(self.directory, f"ckpt_{step}")
        return os.path.join(self.directory, f"ckpt_{step}.npz")

    def maybe_save(self, step: int, tree: Any) -> Optional[str]:
        if step % self.every != 0:
            return None
        path = self._path(step)
        save_pytree(tree, path)
        self._gc()
        return path

    def latest_step(self) -> Optional[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt_"):
                stem = name[len("ckpt_"):].removesuffix(".npz")
                if stem.isdigit():
                    steps.append(int(stem))
        return max(steps) if steps else None

    def restore_latest(self, template: Any) -> Optional[Any]:
        step = self.latest_step()
        if step is None:
            return None
        return load_pytree(template, self._path(step))

    def _gc(self) -> None:
        steps = sorted(
            s for s in (self.latest_step(),) if s is not None)
        all_steps = []
        for name in os.listdir(self.directory):
            if name.startswith("ckpt_"):
                stem = name[len("ckpt_"):].removesuffix(".npz")
                if stem.isdigit():
                    all_steps.append(int(stem))
        for s in sorted(all_steps)[: -self.keep]:
            p = self._path(s)
            if os.path.isdir(p):
                import shutil

                shutil.rmtree(p, ignore_errors=True)
            elif os.path.exists(p):
                os.remove(p)
