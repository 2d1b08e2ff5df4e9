"""Deliberately-fatal scripted runs: exact death-step parity.

The scripted return-parity suite pins seeds where bots avoid enemy
contact, so hazard-death semantics were only covered by per-game unit
tests. Here each game runs trajectories chosen to DIE — walking into
saws/spikes/mobs/meteors — and the exact termination step and the
0/-10 terminal reward are asserted:

  * coinrun / jumper / bossfight: the death step is independently
    predicted by the scalar numpy re-simulations in tools/predict
    (mob patrols, spike boxes, boss bullet kinematics), compared with
    exact f32 equality.
  * chaser / climber / caveflyer: enemies are simulated only by the
    engine, so the death steps are pinned constants measured once from
    the deterministic engine (regression locks); the *semantics* —
    death yields no reward and terminates (chaser.cpp:296-312,
    climber.cpp:339-355, caveflyer.cpp:317-332) — are asserted
    directly, plus state evidence that the agent actually overlaps a
    live hazard at the recorded death step.

maze has no hazards (the only terminal events are the cheese and the
500-step timeout, maze.cpp:49, 308-310) — its "fatal" analogue, exact
timeout termination, is covered in tests/test_maze.py.
"""
import jax
import jax.numpy as jnp
import numpy as np

import procgen2_tpu as pg
from procgen2_tpu.tools import bots, predict
from procgen2_tpu.tools.reference_levels import reference_bank

f32 = np.float32
RIGHT, NOOP, JUMP_R = bots.RIGHT, bots.NOOP, 8


def _level_i(bank_np, i):
    return jax.tree.map(lambda x: np.asarray(x[i]), bank_np)


def _run_script(env, bank_np, seeds, actions, max_steps):
    """All lanes follow the same open-loop action list."""
    bank = jax.tree.map(jnp.asarray, bank_np)
    state = env.reset_pinned(
        bank, jax.random.key(123), jnp.asarray(seeds, jnp.uint32)
    )
    keys0 = getattr(state.game, "rng", None)
    N = len(seeds)
    R = np.zeros((max_steps, N), f32)
    D = np.zeros((max_steps, N), bool)
    states = []
    for t in range(max_steps):
        state, ts = env.step_raw(
            state, jnp.full((N,), actions[t], jnp.int32), render=False
        )
        R[t] = np.asarray(ts.reward)
        D[t] = np.asarray(ts.terminated)
        states.append(state)
    return R, D, keys0, states


def _assert_predicted_death(R, D, pr, pt, seed, i):
    assert D[:, i].any(), f"seed {seed}: survived"
    end = int(np.argmax(D[:, i]))
    assert R[end, i] == f32(0.0), f"seed {seed}: death reward {R[end, i]}"
    assert not R[:end, i].any(), f"seed {seed}: stray rewards"
    assert len(pr) == end + 1, (
        f"seed {seed}: predictor death at {len(pr) - 1}, engine at {end}"
    )
    assert np.array_equal(R[: end + 1, i], pr), f"seed {seed}"
    assert pt[-1] and not pt[:-1].any()


# ---------------------------------------------------------------------------
# coinrun: jump-right spam lands in saw/lava/mob hazards
# ---------------------------------------------------------------------------

COINRUN_FATAL_SEEDS = [3, 6, 8, 10, 15, 16, 20, 23, 24, 25, 28, 29]


def test_coinrun_fatal_death_step_parity():
    """Blind jump-right runs die on the first hazard; death pays 0.0 and
    terminates (coinrun.cpp:357-371: `dead` sets terminated with no
    reward write). Exact step from the CoinrunSim re-simulation."""
    env = pg.make("coinrun")
    bank_np = reference_bank("coinrun", COINRUN_FATAL_SEEDS)
    acts = [JUMP_R] * 300
    R, D, _, _ = _run_script(env, bank_np, COINRUN_FATAL_SEEDS, acts, 150)
    for i, seed in enumerate(COINRUN_FATAL_SEEDS):
        pr, pt = predict.coinrun_predict(_level_i(bank_np, i), acts)
        _assert_predicted_death(R, D, pr, pt, seed, i)


# ---------------------------------------------------------------------------
# jumper: blind right walk into ground spikes
# ---------------------------------------------------------------------------

JUMPER_FATAL_SEEDS = [3, 6, 7, 16, 17, 27, 36, 37, 39, 43, 52, 53]


def test_jumper_fatal_death_step_parity():
    """Walking right into a spike cell terminates with 0.0
    (jumper.cpp:362-364). Exact step from the JumperSim re-simulation
    (spike rects at cell centers, common_systems.cpp:149-162)."""
    env = pg.make("jumper", mode="easy")
    bank_np = reference_bank("jumper", JUMPER_FATAL_SEEDS)
    acts = [RIGHT] * 300
    R, D, _, _ = _run_script(env, bank_np, JUMPER_FATAL_SEEDS, acts, 30)
    for i, seed in enumerate(JUMPER_FATAL_SEEDS):
        pr, pt = predict.jumper_predict(_level_i(bank_np, i), acts)
        _assert_predicted_death(R, D, pr, pt, seed, i)


# ---------------------------------------------------------------------------
# chaser / climber / caveflyer: engine-measured pinned death steps
# ---------------------------------------------------------------------------
# Enemies in these games are simulated only by the engine, so the death
# steps below are regression locks measured once from the deterministic
# engine (reset key 123, the lanes' oracle seeds). The semantics under
# test — enemy/hazard contact terminates with NO reward — come from the
# cited step loops; the frozen terminal state must additionally show the
# agent overlapping a live hazard by the game's own contact rects.

CHASER_FATAL = [  # easy mode, NOOP agent eaten by a patrolling enemy
    # (re-pinned after mirroring the reference's always-true junction
    # gate — enemies re-decide direction every sub-step, chaser.py)
    (0, 56), (2, 118), (3, 126), (6, 88), (7, 50), (8, 69),
    (9, 50), (10, 60), (11, 102), (12, 86),
]


def test_chaser_fatal_enemy_contact():
    """Enemy contact with eat_timer==0 terminates with reward 0.0
    (chaser.cpp:296-312: death writes no reward; the last sub-step's
    pellet delta is 0 for a stationary agent)."""
    from procgen2_tpu.games.chaser import HATCH_TIME

    seeds = [s for s, _ in CHASER_FATAL]
    env = pg.make("chaser", mode="easy")
    bank_np = reference_bank("chaser", seeds)
    R, D, _, states = _run_script(env, bank_np, seeds, [NOOP] * 200, 200)
    for i, (seed, step_pin) in enumerate(CHASER_FATAL):
        assert D[:, i].any(), f"seed {seed}: survived"
        end = int(np.argmax(D[:, i]))
        assert end == step_pin, f"seed {seed}: died at {end} != {step_pin}"
        assert R[end, i] == f32(0.0)
        assert not R[:end, i].any()  # stationary agent scores nothing
        gs = states[end].game
        pos = np.asarray(gs.pos[i])
        mob_pos = np.asarray(gs.mob_pos[i])
        hatched = np.asarray(gs.hatch_timer[i]) >= HATCH_TIME
        overlap = hatched & (
            (np.abs(mob_pos[:, 0] - pos[0]) < 1.0)
            & (np.abs(mob_pos[:, 1] - pos[1]) < 1.0)
        )
        assert overlap.any(), f"seed {seed}: no enemy at death position"
        assert np.asarray(gs.eat_timer[i]) == 0.0


CLIMBER_FATAL = [  # hard mode, blind jump-right into patrol mobs
    (1, 24), (3, 47), (4, 100), (5, 115), (7, 43), (8, 20),
    (9, 41), (10, 14), (14, 78), (15, 9), (17, 27), (19, 71),
]


def test_climber_fatal_mob_contact():
    """Flying-mob contact terminates with reward 0.0
    (climber.cpp:339-355: dead sets terminated, no reward write; mob
    bounds (-0.4,-0.4,0.8,0.8) vs agent (-0.5,-1,1,1),
    common_systems.cpp:146-153)."""
    seeds = [s for s, _ in CLIMBER_FATAL]
    env = pg.make("climber", easy_mode=False)
    bank_np = reference_bank("climber", seeds, easy_mode=False)
    R, D, _, states = _run_script(env, bank_np, seeds, [JUMP_R] * 150, 150)
    for i, (seed, step_pin) in enumerate(CLIMBER_FATAL):
        assert D[:, i].any(), f"seed {seed}: survived"
        end = int(np.argmax(D[:, i]))
        assert end == step_pin, f"seed {seed}: died at {end} != {step_pin}"
        assert R[end, i] == f32(0.0), f"seed {seed}: {R[end, i]}"
        # crystals may be collected en route (+1 each), never +10
        assert all(v in (f32(0.0), f32(1.0), f32(2.0)) for v in R[:end, i])
        gs = states[end].game
        pos = np.asarray(gs.pos[i])
        mob_pos = np.asarray(gs.mob_pos[i])
        mob_alive = np.asarray(gs.level.mob_alive[i])
        overlap = mob_alive & (
            (pos[0] - 0.5 < mob_pos[:, 0] + 0.4)
            & (pos[0] + 0.5 > mob_pos[:, 0] - 0.4)
            & (pos[1] - 1.0 < mob_pos[:, 1] + 0.4)
            & (pos[1] > mob_pos[:, 1] - 0.4)
        )
        assert overlap.any(), f"seed {seed}: no mob at death position"


CAVEFLYER_FATAL = [  # hard mode, blind thrust+turn into meteors/targets
    (1, 3), (3, 1), (6, 95), (7, 95), (8, 116), (10, 115),
    (12, 95), (13, 124), (17, 11), (18, 28), (20, 14), (21, 52),
]


def test_caveflyer_fatal_hazard_contact():
    """Meteor/target/enemy contact terminates with reward 0.0
    (caveflyer.cpp:317-332: death writes no reward; hazard rects
    common_systems.cpp:182-195)."""
    seeds = [s for s, _ in CAVEFLYER_FATAL]
    env = pg.make("caveflyer", mode="hard")
    bank_np = reference_bank("caveflyer", seeds, mode="hard")
    R, D, _, states = _run_script(
        env, bank_np, seeds, [bots.UP_RIGHT] * 200, 200)
    for i, (seed, step_pin) in enumerate(CAVEFLYER_FATAL):
        assert D[:, i].any(), f"seed {seed}: survived"
        end = int(np.argmax(D[:, i]))
        assert end == step_pin, f"seed {seed}: died at {end} != {step_pin}"
        assert R[end, i] == f32(0.0), f"seed {seed}: {R[end, i]}"
        # a blind flight may incidentally shoot nothing: no +3/+10 at all
        assert not R[:end, i].any(), f"seed {seed}: stray rewards"
        gs = states[end].game
        pos = np.asarray(gs.pos[i])
        lvl = jax.tree.map(lambda x: np.asarray(x[i]), states[end].game.level)

        def _rects_overlap(cx, cy, half):
            return (
                (pos[0] - 0.4 < cx + half) & (pos[0] + 0.4 > cx - half)
                & (pos[1] - 0.4 < cy + half) & (pos[1] + 0.4 > cy - half)
            )

        enemy_pos = np.asarray(gs.enemy_pos[i])
        hit = (
            (lvl.obst_exists & _rects_overlap(
                lvl.obst_pos[:, 0], lvl.obst_pos[:, 1], 0.25)).any()
            or (np.asarray(gs.target_alive[i]) & _rects_overlap(
                lvl.target_pos[:, 0], lvl.target_pos[:, 1], 0.25)).any()
            # enemies advance within the killing sub-step after the
            # (pre-move) contact test — allow their one-sub-step drift
            or (lvl.enemy_exists & _rects_overlap(
                enemy_pos[:, 0], enemy_pos[:, 1], 0.4 + 0.2)).any()
        )
        assert hit, f"seed {seed}: no hazard at death position"
