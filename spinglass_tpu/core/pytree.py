"""Frozen dataclasses that are JAX pytrees.

``@dataclass`` registers a frozen dataclass with ``jax.tree_util``: fields
are pytree children unless declared with ``static_field()``, which makes them
hashable aux data (shapes, counts). ``obj.replace(**changes)`` returns an
updated copy.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A field kept out of the pytree's leaves (part of its static structure)."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def dataclass(cls):
    """Frozen dataclass registered as a pytree, with a ``replace`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    meta = [f.name for f in fields if f.metadata.get("static", False)]
    data = [f.name for f in fields if not f.metadata.get("static", False)]
    cls.replace = dataclasses.replace
    return jax.tree_util.register_dataclass(cls, data_fields=data,
                                            meta_fields=meta)
