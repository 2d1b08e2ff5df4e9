"""Scene compositor (render/scene.py) + phase machinery tests.

`composite_scene` must agree with a float64 numpy oracle of its
semantics (tile entries, then painter-order stamps), and the quantized
coinrun scene path must agree with the exact per-env-camera renderer
wherever the camera already sits on the quantization grid (there the
phase decomposition is lossless).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from procgen2_tpu.render import phases as phases_lib
from procgen2_tpu.render import scene as scene_lib


def _random_scene(key, N=8, obs=64, qp=4, ne=5):
    ks = list(jax.random.split(key, 10))
    kinds = tuple(range(1, ne + 1))
    themes = (-1, -1, 0, 1, -1)[:ne]
    G = jax.random.randint(ks[0], (N, obs, obs), 0, ne + 1)
    bg = jax.random.randint(ks[1], (N, 3, obs, obs), 0, 256)
    X = jnp.concatenate(
        [G[:, None].astype(jnp.bfloat16), bg.astype(jnp.bfloat16)], 1)
    p = jax.random.randint(ks[2], (N,), 0, qp * qp)
    theme = jax.random.randint(ks[3], (N,), 0, 2)
    tb = jax.random.uniform(ks[4], (qp * qp, ne, 4, obs, obs))
    tb = (jnp.round(tb * 4) / 4).astype(jnp.bfloat16)  # exact bf16 values

    def group(k, V, K, P):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        bank = (jnp.round(
            jax.random.uniform(k1, (V, 4, P, P)) * 4) / 4).astype(jnp.bfloat16)
        var = jax.random.randint(k2, (N, K), -1, V + 1)  # incl. out of range
        scale = jax.random.bernoulli(k3, 0.7, (N, K)).astype(jnp.float32)
        r0 = jax.random.randint(k4, (N, K), -P, obs + 2)
        c0 = jax.random.randint(ks[9], (N, K), -P, obs + 2)
        return (bank, var, scale, r0, c0)

    groups = [group(ks[5], 6, 5, 8), group(ks[6], 4, 2, 12)]
    return X, p, theme, tb, kinds, themes, groups


def _np_scene(X, p, theme, tb, kinds, themes, groups, obs=64):
    """float64 numpy oracle of composite_scene: tile entries, then every
    stamp group slot by slot in painter order, each stamp blended over
    the frame; out-of-range variants and off-frame texels draw
    nothing."""
    X, tb = np.asarray(X, np.float64), np.asarray(tb, np.float64)
    img, G = X[:, 1:4].copy(), X[:, 0]
    theme = np.asarray(theme)
    for i, (kv, tv) in enumerate(zip(kinds, themes)):
        t = tb[np.asarray(p), i]  # [N, 4, obs, obs]
        m = G == kv
        if tv >= 0:
            m = m & (theme == tv)[:, None, None]
        img = np.where(m[:, None], img * (1 - t[:, 3:4]) + t[:, :3], img)
    for bank, var, scale, r0, c0 in groups:
        bank = np.asarray(bank, np.float64)
        var, scale = np.asarray(var), np.asarray(scale, np.float64)
        r0, c0 = np.asarray(r0), np.asarray(c0)
        V, _, P, _ = bank.shape
        for k in range(var.shape[1]):
            for n in range(var.shape[0]):
                v = var[n, k]
                if not 0 <= v < V:
                    continue
                patch = bank[v] * scale[n, k]
                r, c = r0[n, k], c0[n, k]
                ra, rb = max(r, 0), min(r + P, obs)
                ca, cb = max(c, 0), min(c + P, obs)
                if ra >= rb or ca >= cb:
                    continue
                w = patch[:, ra - r:rb - r, ca - c:cb - c]
                img[n, :, ra:rb, ca:cb] = (
                    img[n, :, ra:rb, ca:cb] * (1 - w[3:4]) + w[:3])
    return img


@pytest.mark.parametrize("P", [8, 12, 28])
def test_composite_scene_painter_order(P):
    """Overlapping stamps blend over each other in slot order (the
    painter's algorithm, renderer.cpp:5-101), after the tile entries."""
    X, p, theme, tb, kinds, themes, _ = _random_scene(
        jax.random.key(31 + P))
    ks = jax.random.split(jax.random.key(P), 5)
    N, K, V = X.shape[0], 4, 3
    bank = jax.random.uniform(ks[0], (V, 4, P, P), minval=0.1, maxval=0.9)
    bank = bank.at[:, :3].mul(200.0).astype(jnp.bfloat16)
    var = jax.random.randint(ks[1], (N, K), 0, V)
    scale = jnp.where(jax.random.uniform(ks[2], (N, K)) < 0.25, 0.0, 1.0)
    r0 = jax.random.randint(ks[3], (N, K), -P, 64 + 2)
    c0 = jax.random.randint(ks[4], (N, K), -P, 64 + 2)
    # force overlaps so painter ORDER is actually exercised
    r0 = r0.at[:, 1].set(r0[:, 0] + 2)
    c0 = c0.at[:, 1].set(c0[:, 0] + 2)
    groups = [(bank, var, scale, r0, c0)]
    got = scene_lib.composite_scene(X, p, theme, tb, kinds, themes,
                                    groups, 64)
    want = _np_scene(X, p, theme, tb, kinds, themes, groups)
    # bf16 blend chains vs the float64 oracle
    np.testing.assert_allclose(np.float32(got), want, atol=4.0, rtol=0.02)


def test_composite_scene_random_scene_matches_oracle():
    """Themed tile entries plus two stamp groups with out-of-range
    variants and edge-crossing offsets."""
    X, p, theme, tb, kinds, themes, groups = _random_scene(
        jax.random.key(0))
    got = scene_lib.composite_scene(X, p, theme, tb, kinds, themes,
                                    groups, 64)
    want = _np_scene(X, p, theme, tb, kinds, themes, groups)
    np.testing.assert_allclose(np.float32(got), want, atol=4.0, rtol=0.02)


def test_phase_tables_reconstruct_sampling():
    # TR/VV must reproduce direct floor() sampling for every phase.
    ppu, obs, qp = 4.8, 64, 4
    TR, VV, t0_off = phases_lib.phase_tables(ppu, obs, qp)
    for m in range(-5, 9):
        cam = m / qp
        j = m % qp
        t0 = int(np.floor(cam + t0_off))
        wx = cam + (np.arange(obs) + 0.5 - obs / 2) / ppu
        t = np.floor(wx).astype(int)
        np.testing.assert_array_equal(TR[j], t - t0)
        np.testing.assert_array_equal(
            VV[j], np.floor((wx - t) * phases_lib.S).astype(int))


def test_coinrun_scene_matches_exact_on_grid():
    """Place the agent exactly on the camera quantization grid: the
    quantized path is then lossless and must match the exact renderer
    up to bf16 blend-order rounding (<= 1 pixel-value unit) and stamp
    overlap order."""
    from procgen2_tpu import make

    env = make("coinrun")
    bank = env.generate_bank(jax.random.key(0), num_levels=8)
    state, _ = env.reset(bank, jax.random.key(1), num_envs=8)
    g = state.game
    # snap agent positions to the 1/4-unit grid (render cam = pos)
    g = g.replace(pos=jnp.round(g.pos * 4) / 4)

    from procgen2_tpu.games import coinrun

    fast = coinrun._observe_scene(env.cfg, g).astype(jnp.int32)
    slow = coinrun._observe_exact(env.cfg, g).astype(jnp.int32)
    diff = jnp.abs(fast - slow)
    # blend-formula rounding differs by at most ~2/255; stamp-overlap
    # painter-vs-sum differences are confined to overlapping sprites
    assert float(jnp.mean((diff > 2).astype(jnp.float32))) < 0.02
    assert float(jnp.mean(diff)) < 0.5


def test_coinrun_scene_close_to_exact_off_grid():
    """Off-grid cameras shift the scene by <= 0.6 px: images stay close
    (most pixels identical, differences on texel boundaries)."""
    from procgen2_tpu import make

    env = make("coinrun")
    bank = env.generate_bank(jax.random.key(2), num_levels=8)
    state, _ = env.reset(bank, jax.random.key(3), num_envs=8)
    for _ in range(3):
        state, _ = env._step(
            bank, state, jnp.full((8,), 7, jnp.int32))  # move right
    g = state.game

    from procgen2_tpu.games import coinrun

    fast = coinrun._observe_scene(env.cfg, g).astype(jnp.int32)
    slow = coinrun._observe_exact(env.cfg, g).astype(jnp.int32)
    diff = jnp.abs(fast - slow).astype(jnp.float32)
    assert float(jnp.mean(diff)) < 12.0
    # the scenes must still be the *same scene* (sub-pixel shift, not a
    # misplaced camera): demand strong agreement
    assert float(jnp.mean((diff < 8).astype(jnp.float32))) > 0.70


@pytest.mark.parametrize("qp", [2, 4, 8])
def test_tile_phase_bank_shapes(qp):
    S = phases_lib.S
    tex = np.random.default_rng(0).integers(
        0, 256, (3, 4, S, S), np.uint8)
    bank = phases_lib.tile_phase_bank(tex, 4.8, 64, qp)
    assert bank.shape == (qp * qp, 3, 4, 64, 64)
    # phase 0 pixel (0, 0) must equal the texel under the first pixel
    TR, VV, _ = phases_lib.phase_tables(4.8, 64, qp)
    a = tex[0, 3, VV[0][0], VV[0][0]] / 255.0
    np.testing.assert_allclose(bank[0, 0, 3, 0, 0], a, rtol=1e-6)
