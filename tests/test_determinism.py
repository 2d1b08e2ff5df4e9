"""Cross-game determinism: same keys -> bit-identical banks/trajectories.

The reference offers reproducibility only via reseeding on reset
(games/*/coinrun.cpp:308-318); here the whole system is keyed, so full
trajectories (states, rewards, observations) must be exactly
reproducible — this is also what makes env-state checkpointing sound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import procgen2_tpu as pg


@pytest.mark.parametrize("game", pg.GAMES)
def test_bank_and_trajectory_deterministic(game):
    env = pg.make(game)
    b1 = env.generate_bank(jax.random.key(0), num_levels=4)
    b2 = env.generate_bank(jax.random.key(0), num_levels=4)
    for l1, l2 in zip(jax.tree.leaves(b1), jax.tree.leaves(b2)):
        np.testing.assert_array_equal(np.asarray(l1), np.asarray(l2))

    def run(bank):
        state, ts = env.reset(bank, jax.random.key(1), num_envs=2)
        rs, obs = [], None
        for i in range(5):
            a = jnp.full((2,), [7, 5, 9, 4][i % 4], jnp.int32)
            state, ts = env.step(bank, state, a)
            rs.append(np.asarray(ts.reward))
        return np.stack(rs), np.asarray(ts.obs)

    r1, o1 = run(b1)
    r2, o2 = run(b2)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(o1, o2)


def test_level_set_semantics():
    """procgen-style num_levels/start_level: level i == fold_in(key,
    start_level+i), so shifted ranges share identical levels and the
    same range is portable across bank sizes."""
    env = pg.make("maze")
    key = jax.random.key(42)
    full = env.generate_bank(key, num_levels=6, start_level=0)
    tail = env.generate_bank(key, num_levels=3, start_level=3)
    for lf, lt in zip(jax.tree.leaves(full), jax.tree.leaves(tail)):
        np.testing.assert_array_equal(np.asarray(lf)[3:6], np.asarray(lt))
    # disjoint ranges differ
    head = env.generate_bank(key, num_levels=3, start_level=0)
    same = all(
        np.array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(jax.tree.leaves(head), jax.tree.leaves(tail))
    )
    assert not same
