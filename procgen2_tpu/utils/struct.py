"""Frozen dataclasses that are JAX pytrees.

`@struct.dataclass` makes a frozen dataclass whose every field is a
pytree child (no static fields), registered with
`jax.tree_util.register_dataclass`, plus a `.replace(**changes)` method.
Game `Level`/`State` classes, `EnvState`, `TimeStep` and
`RolloutBuffer` are built with it, so they jit, vmap, scan and shard
like any pytree.
"""
from __future__ import annotations

import dataclasses

import jax


def _replace(self, **changes):
    """A copy with the named fields replaced (`dataclasses.replace`)."""
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    names = [f.name for f in dataclasses.fields(cls)]
    return jax.tree_util.register_dataclass(
        cls, data_fields=names, meta_fields=[])
