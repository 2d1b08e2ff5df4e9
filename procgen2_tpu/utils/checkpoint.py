"""Checkpoint save/restore for env state pytrees.

The reference cannot checkpoint at all: env state lives in C++ globals
behind the CEnv ABI and is never exported (SURVEY.md §5 "Checkpoint /
resume"; the only reproducibility hook is reseeding on reset,
games/coinrun/coinrun.cpp:308-318). Here the entire environment state —
`EnvState` (per-game SoA pytrees + episode accumulators + PRNG keys) and
the level bank — is an explicit pytree, so checkpointing is exact:
serialize the leaves, restore them, and the continued trajectory is
bit-identical (tests/test_checkpoint.py proves it).

Format: a single compressed ``.npz`` holding every leaf under its
pytree path (``state/game/level/grid``: dataclass fields, dict keys and
list indices joined by ``/``). JAX typed PRNG keys (``jax.random.key``) are
stored as their raw key data plus the impl name and re-wrapped on
restore. Restoring requires a *target* pytree of the same structure
(e.g. the live state, or one freshly built the same way) — the usual
"example tree" restore contract; no pickling, no custom classes in the
file, so checkpoints are portable across processes and hosts.

Usage::

    from procgen2_tpu.utils import checkpoint
    checkpoint.save("ckpt.npz", state=state, bank=bank)
    ...
    restored = checkpoint.restore("ckpt.npz", state=state, bank=bank)
    state, bank = restored["state"], restored["bank"]
"""
from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

_KEY_PREFIX = "__prngkey__"


def _is_typed_key(x) -> bool:
    return isinstance(x, jax.Array) and jnp.issubdtype(
        x.dtype, jax.dtypes.prng_key
    )


def _key_name(k) -> str:
    """One path component: a dataclass field, dict key or list index."""
    for attr in ("name", "key", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    raise TypeError(f"unsupported pytree path entry {k!r}")


def _leaves_by_path(tree: Any, prefix: str):
    """[(path, leaf)] with paths `prefix/field/.../leaf` (the archive's
    key for that leaf)."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join([prefix] + [_key_name(k) for k in path]), leaf)
            for path, leaf in leaves]


def save(path: str, **trees: Any) -> None:
    """Serialize named pytrees (``state=``, ``bank=``, ...) to ``path``.

    Each keyword becomes a top-level namespace in the archive, so a
    single file can hold the env state, the level bank, and anything
    else (optimizer state, rollout buffers) side by side.
    """
    flat: Dict[str, np.ndarray] = {}
    for name, tree in trees.items():
        for p, leaf in _leaves_by_path(tree, name):
            if _is_typed_key(leaf):
                impl = str(jax.random.key_impl(leaf))
                flat[f"{_KEY_PREFIX}:{impl}:{p}"] = np.asarray(
                    jax.random.key_data(leaf))
            else:
                flat[p] = np.asarray(leaf)
    np.savez_compressed(path, **flat)


def restore(path: str, **targets: Any) -> Dict[str, Any]:
    """Load pytrees from ``path`` into the structure of ``targets``.

    ``targets`` supplies one example pytree per saved namespace (the
    live object, or a freshly constructed one of identical structure);
    returns a dict mapping each requested name to the restored pytree.
    A leaf missing from the archive, or one whose shape differs from
    the target's, raises ValueError.
    """
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    keys = {}  # leaf path -> (impl, raw key data) for typed PRNG keys
    for k in [k for k in flat if k.startswith(_KEY_PREFIX + ":")]:
        _, impl, p = k.split(":", 2)
        keys[p] = (impl, flat.pop(k))
    namespaces = {p.split("/", 1)[0] for p in list(flat) + list(keys)}
    out: Dict[str, Any] = {}
    for name, target in targets.items():
        if name not in namespaces:
            raise KeyError(
                f"checkpoint {path!r} has no namespace {name!r}; "
                f"available: {sorted(namespaces)}"
            )
        values = []
        for p, leaf in _leaves_by_path(target, name):
            if p in keys:
                impl, raw = keys[p]
                values.append(jax.random.wrap_key_data(
                    jnp.asarray(raw), impl=impl))
                continue
            if p not in flat:
                raise ValueError(f"checkpoint {path!r} has no leaf {p!r}")
            arr = flat[p]
            if arr.shape != np.shape(leaf):
                raise ValueError(
                    f"leaf {p!r}: checkpoint shape {arr.shape} != "
                    f"target shape {np.shape(leaf)}")
            values.append(jnp.asarray(arr, getattr(leaf, "dtype", None)))
        out[name] = jax.tree.unflatten(jax.tree.structure(target), values)
    return out
