"""utils.struct.dataclass: frozen dataclasses that are JAX pytrees."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from procgen2_tpu.utils import struct


@struct.dataclass
class Inner:
    a: jnp.ndarray
    b: jnp.ndarray


@struct.dataclass
class Outer:
    inner: Inner
    c: jnp.ndarray
    info: dict


def _outer():
    return Outer(inner=Inner(a=jnp.arange(3), b=jnp.ones((3, 2))),
                 c=jnp.float32(2.0), info={"x": jnp.zeros(3)})


def test_struct_flatten_unflatten_roundtrip():
    o = _outer()
    leaves, treedef = jax.tree.flatten(o)
    # every field is a child, in field order (dict leaves by key)
    assert [np.shape(x) for x in leaves] == [(3,), (3, 2), (), (3,)]
    back = jax.tree.unflatten(treedef, leaves)
    assert isinstance(back, Outer) and isinstance(back.inner, Inner)
    for x, y in zip(jax.tree.leaves(back), leaves):
        np.testing.assert_array_equal(x, y)
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_flatten_with_path(o)[0]]
    assert paths == [".inner.a", ".inner.b", ".c", ".info['x']"]


def test_struct_replace_and_frozen():
    o = _outer()
    o2 = o.replace(c=jnp.float32(5.0))
    assert float(o2.c) == 5.0 and float(o.c) == 2.0
    assert o2.inner is o.inner
    with pytest.raises(dataclasses.FrozenInstanceError):
        o.c = jnp.float32(1.0)
    with pytest.raises(TypeError):
        o.replace(nope=1)


def test_struct_through_jit_and_vmap():
    @jax.jit
    def f(o):
        return o.replace(c=o.c + o.inner.a.sum())

    out = f(_outer())
    assert isinstance(out, Outer) and float(out.c) == 5.0

    batched = jax.vmap(lambda i: Inner(a=i * jnp.arange(3), b=jnp.ones(2)))(
        jnp.arange(4))
    assert batched.a.shape == (4, 3) and batched.b.shape == (4, 2)
    s = jax.vmap(lambda x: x.a.sum() + x.b.sum())(batched)
    np.testing.assert_array_equal(s, np.arange(4) * 3 + 2)
