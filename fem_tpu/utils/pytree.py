# coding=utf-8
"""Frozen dataclasses that are JAX pytrees.

Array fields are pytree leaves (traced under ``jit``); fields declared with
``static_field`` are part of the tree structure, so they are trace-time
constants and hashed into the compilation cache key.  ``.replace(**changes)``
returns a copy with the given fields changed.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(default=dataclasses.MISSING):
    """A field carried in the pytree's structure, not as a leaf."""
    return dataclasses.field(default=default, metadata={"static": True})


def dataclass(cls):
    """Make ``cls`` a frozen dataclass registered as a JAX pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")],
    )
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls
