"""Small pytree utilities shared across the framework."""
from __future__ import annotations

import jax
import jax.numpy as jnp


def tree_select(pred, on_true, on_false):
    """Per-leaf `jnp.where(pred, a, b)` with broadcast over leading dims.

    `pred` is a scalar (or batched) boolean; each leaf pair must share trailing
    shape. Used for auto-reset lane merging (SURVEY.md section 7: "done ?
    init(new_key) : state" via tree select).
    """

    def _sel(a, b):
        p = pred
        # Broadcast pred over the leaf's extra trailing dims.
        extra = a.ndim - jnp.ndim(pred)
        if extra > 0:
            p = jnp.reshape(p, jnp.shape(p) + (1,) * extra)
        return jnp.where(p, a, b)

    return jax.tree.map(_sel, on_true, on_false)


def bank_gather(bank, idx):
    """Select one level (row `idx`) from a stacked level-bank pytree.

    A per-leaf `x[idx]` under vmap lowers to batched row gathers; here
    the selection runs as ONE one-hot bf16 matmul per leaf over a uint8
    *byte view* of the data: a one-hot contraction copies exact byte
    values (<=255, exact in bf16), so the result is bit-exact for every
    dtype after bitcasting back. (Whether a plain row gather is faster
    on the GPU is ROADMAP Speed #3.)
    """
    import jax
    import jax.numpy as jnp

    leaves, treedef = jax.tree.flatten(bank)
    num = leaves[0].shape[0]
    sel = (jnp.arange(num) == idx).astype(jnp.bfloat16)

    def pick(x):
        if x.dtype == jnp.bool_:
            xb = x.astype(jnp.uint8)[..., None]
        else:
            xb = jax.lax.bitcast_convert_type(x, jnp.uint8)
            if xb.shape == x.shape:  # itemsize 1: no trailing byte dim
                xb = xb[..., None]
        flat = xb.reshape(num, -1).astype(jnp.bfloat16)
        v = jnp.round(sel @ flat).astype(jnp.uint8)
        v = v.reshape(xb.shape[1:])
        if x.dtype == jnp.bool_:
            return v[..., 0] > 0
        if x.dtype.itemsize == 1:  # uint8/int8: drop the byte dim
            return jax.lax.bitcast_convert_type(v[..., 0], x.dtype)
        return jax.lax.bitcast_convert_type(v, x.dtype)

    return treedef.unflatten([pick(x) for x in leaves])
