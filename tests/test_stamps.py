"""Stamp placement (compositor._stamps_matmul) against a numpy oracle.

Every stamp group of every game goes through the one-hot matmul
formulation: a variant select from a premultiplied bank, then a pair of
one-hot placement contractions summing the group's patches into the
frame. The oracle places each patch by slicing, over offsets that
include negative (edge-crossing) and past-edge positions, where the
one-hot masks must drop exactly the off-frame texels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from procgen2_tpu.render import compositor
from procgen2_tpu.render import scene as scene_lib

OBS = compositor.OBS


def _np_place(bank, var, scale, r0, c0, obs=OBS):
    """float64 premultiplied sum of every stamp at its offset:
    (rgbp [N, 3, obs, obs], a [N, 1, obs, obs])."""
    bank = np.asarray(bank, np.float64)
    var, scale = np.asarray(var), np.asarray(scale, np.float64)
    r0, c0 = np.asarray(r0), np.asarray(c0)
    N, K = var.shape
    V, _, P, _ = bank.shape
    out = np.zeros((N, 4, obs, obs))
    for n in range(N):
        for k in range(K):
            v = var[n, k]
            if not 0 <= v < V:
                continue
            r, c = r0[n, k], c0[n, k]
            ra, rb = max(r, 0), min(r + P, obs)
            ca, cb = max(c, 0), min(c + P, obs)
            if ra < rb and ca < cb:
                out[n, :, ra:rb, ca:cb] += (
                    bank[v, :, ra - r:rb - r, ca - c:cb - c] * scale[n, k])
    return out[:, :3], out[:, 3:4]


def _random_group(P, seed, N=8, K=5, V=4):
    ks = jax.random.split(jax.random.key(17 + P + seed), 6)
    # strictly positive texels so the nonzero-support sets are exact
    bank = jax.random.uniform(ks[0], (V, 4, P, P), minval=0.25, maxval=1.0)
    bank = bank.at[:, :3].mul(200.0).astype(jnp.bfloat16)
    var = jax.random.randint(ks[1], (N, K), 0, V)
    alive = jax.random.uniform(ks[2], (N, K)) >= 0.25
    r0 = jax.random.randint(ks[3], (N, K), -P, OBS + 2)
    c0 = jax.random.randint(ks[4], (N, K), -P, OBS + 2)
    # adversarial corners: barely on-frame at each edge
    r0 = r0.at[0, 0].set(-P + 1).at[0, 1].set(OBS - 1)
    c0 = c0.at[0, 0].set(-P + 1).at[0, 1].set(OBS - 1)
    r0 = r0.at[1, 0].set(-1).at[1, 1].set(0)
    c0 = c0.at[1, 0].set(OBS - P).at[1, 1].set(-P // 2)
    return bank, var, alive, r0, c0


@pytest.mark.parametrize("P", [8, 12, 20, 28, 40])
def test_stamps_matmul_matches_numpy_oracle(P):
    bank, var, alive, r0, c0 = _random_group(P, 0)
    alpha = 0.75
    rgb, a = compositor._stamps_matmul(bank, var, r0, c0, alives=alive,
                                       alpha=alpha)
    assert rgb.shape == (8, 3, OBS, OBS) and a.shape == (8, 1, OBS, OBS)
    scale = np.asarray(alive, np.float64) * alpha
    rgb_o, a_o = _np_place(bank, var, scale, r0, c0)
    # placement is exact: the same texels are covered
    np.testing.assert_array_equal(np.asarray(a) != 0, a_o != 0)
    # values agree to bf16 rounding of the sums (alpha 0.75 is exact)
    np.testing.assert_allclose(np.float32(rgb), rgb_o, atol=4.0, rtol=0.02)
    np.testing.assert_allclose(np.float32(a), a_o, atol=1 / 32, rtol=0.02)


def _out_of_range_case(P=8, N=8, V=2):
    bank = jnp.ones((V, 4, P, P), jnp.bfloat16)
    var = jnp.array([[-1, V, 0]] * N, jnp.int32)
    r0 = jnp.full((N, 3), 10, jnp.int32)
    c0 = jnp.array([[40, 20, 5]] * N, jnp.int32)
    return bank, var, r0, c0


@pytest.mark.parametrize("path", ["stamps_matmul", "composite_scene"])
def test_out_of_range_variants_draw_nothing(path):
    """Sentinel variants (negative / >= V) contribute nothing even with
    a nonzero weight; only the in-range slot is drawn."""
    bank, var, r0, c0 = _out_of_range_case()
    N = var.shape[0]
    want = np.zeros((N, OBS, OBS), bool)
    want[:, 10:18, 5:13] = True
    if path == "stamps_matmul":
        _, a = compositor._stamps_matmul(bank, var, r0, c0)
        covered = np.asarray(a[:, 0]) != 0
    else:
        X = jnp.zeros((N, 4, OBS, OBS), jnp.bfloat16)
        tb = jnp.zeros((1, 0, 4, OBS, OBS), jnp.bfloat16)
        img = scene_lib.composite_scene(
            X, jnp.zeros((N,), jnp.int32), jnp.zeros((N,), jnp.int32), tb,
            (), (), [(bank, var, jnp.ones((N, 3)), r0, c0)], OBS)
        covered = np.asarray(img[:, 0]) != 0
    np.testing.assert_array_equal(covered, want)
