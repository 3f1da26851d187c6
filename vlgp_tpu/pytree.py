"""Immutable dataclass pytrees: the base of ``Params``, ``TrialSet`` and
``FactorModel``.

A subclass of :class:`PyTreeNode` becomes a frozen dataclass registered
with ``jax.tree_util.register_dataclass``.  Fields are pytree leaves (data)
unless declared with :func:`static_field`, which makes them part of the
tree structure (meta): hashable constants that jit treats as static.
"""
from __future__ import annotations

import dataclasses

import jax

__all__ = ["PyTreeNode", "static_field"]


def static_field(**kwargs):
    """A dataclass field kept in the tree structure, not among the leaves."""
    metadata = dict(kwargs.pop("metadata", None) or {}, static=True)
    return dataclasses.field(metadata=metadata, **kwargs)


class PyTreeNode:
    """Frozen dataclass registered as a pytree; ``.replace`` returns a copy."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        fields = dataclasses.fields(cls)
        jax.tree_util.register_dataclass(
            cls,
            data_fields=[f.name for f in fields if not f.metadata.get("static")],
            meta_fields=[f.name for f in fields if f.metadata.get("static")],
        )

    def replace(self, **updates):
        return dataclasses.replace(self, **updates)
