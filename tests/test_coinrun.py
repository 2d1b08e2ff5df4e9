"""Coinrun behavior: generation invariants, physics, hazards, goal.

The most complex generator (sections / pits / crates / danger types,
games/coinrun/tilemap.cpp:97-292) plus the platformer core
(common_systems.cpp:121-252) — exercised with both vmapped generation
and hand-built deterministic levels.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from procgen2_tpu.games import coinrun as G

CFG = G.Config()


@pytest.fixture(scope="module")
def jit_step():
    return jax.jit(functools.partial(G.step, CFG))


@pytest.fixture(scope="module")
def gen_batch():
    keys = jax.random.split(jax.random.key(3), 32)
    return jax.jit(jax.vmap(functools.partial(G.generate, CFG)))(keys)


def _level(grid_rows, coin=(62.5, 62.5), saws=(), mobs=()):
    """Hand-built Level. grid_rows: int8 [64, 64] render coords [ry, x]."""
    saw_pos = np.zeros((G.MAX_SAWS, 2), np.float32)
    saw_alive = np.zeros(G.MAX_SAWS, bool)
    for i, p in enumerate(saws):
        saw_pos[i] = p
        saw_alive[i] = True
    mob_pos = np.zeros((G.MAX_MOBS, 2), np.float32)
    mob_vx = np.zeros(G.MAX_MOBS, np.float32)
    mob_alive = np.zeros(G.MAX_MOBS, bool)
    for i, (p, vx) in enumerate(mobs):
        mob_pos[i] = p
        mob_vx[i] = vx
        mob_alive[i] = True
    return G.Level(
        grid=jnp.asarray(grid_rows, jnp.int8),
        crate_variant=jnp.zeros((G.WORLD, G.WORLD), jnp.int8),
        coin_pos=jnp.asarray(coin, jnp.float32),
        saw_pos=jnp.asarray(saw_pos),
        saw_alive=jnp.asarray(saw_alive),
        mob_pos0=jnp.asarray(mob_pos),
        mob_vx0=jnp.asarray(mob_vx),
        mob_variant=jnp.zeros(G.MAX_MOBS, jnp.int8),
        mob_alive=jnp.asarray(mob_alive),
        theme=jnp.int32(0),
        agent_theme=jnp.int32(0),
        bg_index=jnp.int32(0),
        difficulty=jnp.int32(1),
    )


def _flat_grid():
    """Border walls + a solid floor at the bottom (rows are render coords:
    row 63 = world y_up 0, the generator's floor, tilemap.cpp:113)."""
    g = np.zeros((G.WORLD, G.WORLD), np.int8)
    g[63, :] = G.WALL_TOP
    g[:, 0] = G.WALL_MID
    g[:, 63] = G.WALL_MID
    g[0, :] = G.WALL_MID
    return g


def _reset(level):
    return G.reset(CFG, level, jax.random.key(0))


def _run(jit_step, state, action, n):
    rewards, dones = [], []
    for _ in range(n):
        state, r, d, _ = jit_step(state, jnp.int32(action))
        rewards.append(float(r))
        dones.append(bool(d))
        if dones[-1]:
            break
    return state, rewards, dones


# ---------------------------------------------------------------------------
# Generation invariants (tilemap.cpp:97-292)
# ---------------------------------------------------------------------------

def test_generation_invariants(gen_batch):
    grids = np.asarray(gen_batch.grid)  # [32, 64, 64] render [ry, x]
    # floor (world y 0 == render row 63) fully solid; side/top borders walls
    assert (grids[:, 63, :] != G.EMPTY).all()
    assert (grids[:, :, 0] != G.EMPTY).all()
    assert (grids[:, :, 63] != G.EMPTY).all()
    # coin inside the map, above floor
    coin = np.asarray(gen_batch.coin_pos)
    assert (coin[:, 0] > 0).all() and (coin[:, 0] < G.WORLD).all()
    assert (coin[:, 1] > 0).all() and (coin[:, 1] < 63).all()
    # coin sits on the close-off column: tile under the coin is solid
    cx = coin[:, 0].astype(int)
    cy = np.ceil(coin[:, 1]).astype(int)
    under = grids[np.arange(32), np.clip(cy, 0, 63), cx]
    assert (under != G.EMPTY).all()
    # every crate is supported from below by crate or wall (piles grow up
    # from the section surface, tilemap.cpp:258-273)
    for b in range(32):
        ys, xs = np.where(grids[b] == G.CRATE)
        assert (grids[b, ys + 1, xs] != G.EMPTY).all()
    # fixed-capacity pools respected
    assert np.asarray(gen_batch.saw_alive).sum(1).max() <= G.MAX_SAWS
    assert np.asarray(gen_batch.mob_alive).sum(1).max() <= G.MAX_MOBS
    # saws/mobs only spawn inside the map
    saw = np.asarray(gen_batch.saw_pos)
    alive = np.asarray(gen_batch.saw_alive)
    assert (saw[alive] >= 0).all() and (saw[alive] <= G.WORLD).all()


def test_config_flags_disable_features():
    keys = jax.random.split(jax.random.key(5), 16)
    no_extra = G.Config(allow_crate=False, allow_mobs=False, allow_pit=False)
    bank = jax.jit(jax.vmap(functools.partial(G.generate, no_extra)))(keys)
    grids = np.asarray(bank.grid)
    assert not (grids == G.CRATE).any()  # tilemap.h:44 allow_crate
    assert not np.asarray(bank.mob_alive).any()  # tilemap.h:46 allow_mobs
    assert not np.isin(grids, [G.LAVA_TOP, G.LAVA_MID]).any()  # pits gone


# ---------------------------------------------------------------------------
# Physics + rewards (common_systems.cpp:121-252)
# ---------------------------------------------------------------------------

def test_walk_right_and_coin_terminates(jit_step):
    lvl = _level(_flat_grid(), coin=(8.5, 62.5))
    state = _reset(lvl)
    state, rewards, dones = _run(jit_step, state, 7, 60)  # 7 = right
    assert dones[-1], "agent walking right must reach the coin"
    assert rewards[-1] == 10.0  # +10 coin, coinrun.cpp:364-366
    assert sum(rewards) == 10.0


def test_lava_kills_with_zero_reward(jit_step):
    g = _flat_grid()
    g[63, 4:10] = G.LAVA_TOP  # lava strip in the floor ahead
    state = _reset(_level(g, coin=(40.5, 62.5)))
    state, rewards, dones = _run(jit_step, state, 7, 60)
    assert dones[-1], "agent must die in the lava strip"
    assert sum(rewards) == 0.0


def test_saw_contact_terminates(jit_step):
    lvl = _level(_flat_grid(), coin=(40.5, 62.5), saws=[(5.5, 62.5)])
    state = _reset(lvl)
    state, rewards, dones = _run(jit_step, state, 7, 60)
    assert dones[-1] and sum(rewards) == 0.0


def test_jump_leaves_ground_and_lands(jit_step):
    state = _reset(_level(_flat_grid(), coin=(40.5, 62.5)))
    # settle onto the floor first (spawn is 1 unit above it, coinrun.cpp:489)
    state, _, _ = _run(jit_step, state, 4, 15)
    assert bool(state.on_ground)
    y0 = float(state.pos[1])
    state, _, _ = _run(jit_step, state, 5, 1)  # 5 = jump
    assert float(state.pos[1]) < y0  # moved up (render y decreases upward)
    assert not bool(state.on_ground)
    state, _, _ = _run(jit_step, state, 4, 30)
    assert bool(state.on_ground)
    assert abs(float(state.pos[1]) - y0) < 1e-3  # back on the same floor


def test_crate_fallthrough(jit_step):
    g = _flat_grid()
    g[58, 1:8] = G.CRATE  # one-way platform at height
    lvl = _level(g, coin=(40.5, 62.5))
    state = _reset(lvl)
    # spawn above the crates: stand on them
    state = state.replace(pos=jnp.array([3.5, 57.0], jnp.float32))
    state, _, _ = _run(jit_step, state, 4, 10)
    assert bool(state.on_ground)
    assert float(state.pos[1]) < 59.0  # resting on the crate row
    # down action (3) falls through DOWN_ONLY tiles
    # (tilemap.cpp:352-360 fallthrough + step_y)
    state, _, _ = _run(jit_step, state, 3, 4)
    state, _, _ = _run(jit_step, state, 4, 30)
    assert float(state.pos[1]) > 60.0  # landed on the real floor below


def test_mob_patrols_and_rebounds_at_ledge(jit_step):
    g = _flat_grid()
    g[58, 10:15] = G.WALL_TOP  # 5-wide elevated platform
    lvl = _level(g, coin=(40.5, 62.5),
                 mobs=[((12.5, 57.5), 0.15)])
    state = _reset(lvl)
    xs, vxs = [], []
    for _ in range(120):
        state, r, d, _ = jit_step(state, jnp.int32(4))
        xs.append(float(state.mob_pos[0, 0]))
        vxs.append(float(state.mob_vx[0]))
    xs = np.asarray(xs)
    # never walks off the platform (ledge sensor, common_systems.cpp:84-86)
    assert xs.min() >= 10.0 - 0.1 and xs.max() <= 15.0 + 0.1
    # direction flips at least twice over the horizon (patrol)
    assert (np.sign(vxs[:-1]) != np.sign(vxs[1:])).sum() >= 2


def test_mob_contact_terminates(jit_step):
    lvl = _level(_flat_grid(), coin=(40.5, 62.5),
                 mobs=[((4.5, 62.5), 0.0)])
    state = _reset(lvl)
    state, rewards, dones = _run(jit_step, state, 7, 60)
    assert dones[-1] and sum(rewards) == 0.0
