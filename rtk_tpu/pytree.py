"""Frozen dataclasses registered as JAX pytrees.

Fields are pytree children unless declared with `static_field()`, which
makes them part of the tree structure (hashable, static under jit).
Copies with changed fields use `dataclasses.replace`.
"""
from __future__ import annotations

import dataclasses

import jax


def pytree_dataclass(cls):
    """Make `cls` a frozen dataclass and register it as a pytree node."""
    return jax.tree_util.register_dataclass(dataclasses.dataclass(frozen=True)(cls))


def static_field(**kwargs):
    """A dataclass field that is pytree metadata rather than a child."""
    return dataclasses.field(metadata={"static": True}, **kwargs)
