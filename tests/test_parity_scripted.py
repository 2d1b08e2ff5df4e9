"""Scripted bit-exact return parity for the non-maze games.

For each game, oracle-pinned reference levels (tools/reference_levels,
driven by the mt19937 oracle) are played by scripted/bot trajectories
that *score*, and the engine's per-step reward/termination sequence is
asserted against the reference's reward rules — re-derived from the
layout by an independent predictor where the game's kinematics permit
(tools/bots.py), or as exact event values/counts/order where the
trajectory is found by a closed-loop bot.

Seeds are pinned to trajectories proven to avoid enemy contact (the
engine is deterministic given reset keys, so once green, always green);
the reward-rule citations per game:
  chaser    +0.04/point, +10 all collected   chaser.cpp:307-309
  climber   +1/crystal, +10 all collected    climber.cpp:348-350
  coinrun   +10 coin                         coinrun.cpp:357-371
  jumper    +10 carrot                       jumper.cpp:362-364
  caveflyer +3/target, +10 goal              caveflyer.cpp:330-332
  bossfight -10 death, +10 boss kill         bossfight.cpp:318-320
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import procgen2_tpu as pg
from procgen2_tpu.tools import bots, predict
from procgen2_tpu.tools.reference_levels import reference_bank

f32 = np.float32


def _level_i(bank_np, i):
    return jax.tree.map(lambda x: np.asarray(x[i]), bank_np)


def _run_batched(env, bank_np, seeds, actions_per_lane, render=False):
    """Step every lane through its own action list (NOOP-padded);
    returns (rewards f32[T, N], terminated bool[T, N], keys0) where
    keys0 are the post-reset game PRNG keys (stochastic-game
    predictors replay the engine's keyed draw schedule from them)."""
    bank = jax.tree.map(jnp.asarray, bank_np)
    state = env.reset_pinned(
        bank, jax.random.key(123), jnp.asarray(seeds, jnp.uint32)
    )
    keys0 = getattr(state.game, "rng", None)
    T = max(len(a) for a in actions_per_lane)
    N = len(seeds)
    A = np.full((T, N), bots.NOOP, np.int32)
    for i, a in enumerate(actions_per_lane):
        A[: len(a), i] = a
    R = np.zeros((T, N), np.float32)
    D = np.zeros((T, N), bool)
    for t in range(T):
        state, ts = env.step_raw(state, jnp.asarray(A[t]), render=render)
        R[t] = np.asarray(ts.reward)
        D[t] = np.asarray(ts.terminated)
    return R, D, keys0


# ---------------------------------------------------------------------------
# chaser: full clear — every pellet (+0.04 each), orbs, completion +10
# ---------------------------------------------------------------------------

# Seeds whose planned full-clear route avoids all enemy contact under
# the pinned reset keys (searched over seeds 0..100; deterministic).
# Mixed pool: most scripted routes now END IN ENEMY CONTACT — with the
# reference's int-bound ::abs junction gate mirrored (see
# games/chaser.py:_mob_substep), enemies re-decide every sub-step and
# are as lethal as the executed binary's (which catches the route on
# 14 of 15 cross-engine seeds). Economy parity is asserted as exact
# prefixes up to death; CHASER_CLEAR_SEEDS are the rare full clears.
CHASER_SEEDS = [5, 17, 20, 21, 28, 34, 35, 36, 43, 46, 59, 71, 83, 84, 88]
CHASER_CLEAR_SEEDS = [119, 137, 261]


def _run_closed_loop(env, bank_np, seeds, make_bot, state_reader,
                     max_steps=1200):
    """Drive per-lane closed-loop bots; returns (R, D, T, A, keys0):
    rewards/terminations like `_run_batched`, the per-step action log
    (for replaying through the independent predictors), and the batched
    post-reset game PRNG keys (the stochastic games' predictors replay
    the engine's keyed draw schedule from them)."""
    N = len(seeds)
    levels = [_level_i(bank_np, i) for i in range(N)]
    bots_ = [make_bot(l) for l in levels]
    bank = jax.tree.map(jnp.asarray, bank_np)
    state = env.reset_pinned(
        bank, jax.random.key(123), jnp.asarray(seeds, jnp.uint32)
    )
    keys0 = getattr(state.game, "rng", None)
    R = np.zeros((max_steps, N), np.float32)
    D = np.zeros((max_steps, N), bool)
    A = np.full((max_steps, N), bots.NOOP, np.int32)
    done = np.zeros(N, bool)
    T = max_steps
    for t in range(max_steps):
        args = state_reader(state.game)
        acts = np.array(
            [bots_[i].act(*[a[i] for a in args]) if not done[i] else bots.NOOP
             for i in range(N)],
            np.int32,
        )
        A[t] = acts
        state, ts = env.step_raw(state, jnp.asarray(acts), render=False)
        R[t] = np.asarray(ts.reward)
        D[t] = np.asarray(ts.terminated)
        done |= D[t]
        if done.all():
            T = t + 1
            break
    return R[:T], D[:T], T, A[:T], keys0


def test_chaser_scripted_full_clear_return_parity():
    env = pg.make("chaser", mode="easy")
    bank_np = reference_bank("chaser", CHASER_SEEDS)

    acts, preds, totals = [], [], []
    for i, seed in enumerate(CHASER_SEEDS):
        lvl = _level_i(bank_np, i)
        route = bots.chaser_full_route(lvl)
        a = bots.route_to_actions(route, bots.CHASER_STEPS_PER_CELL)
        rew, term = bots.chaser_predict(lvl, a)
        # The independent predictor embodies the reference economy,
        # including its last-write-wins sub-step quirk: `reward` is
        # REASSIGNED every sub-step (chaser.cpp:297-307), so a pellet
        # picked up on sub-steps 1-3 of a step is overwritten by the
        # 4th sub-step's 0.0 and never observed. Observable scoring
        # events are therefore <= the layout's point count, every
        # nonzero is an exact 0.04 multiple, and the completion step
        # pays delta*0.04 + 10.0.
        n_points = int(np.asarray(lvl.point_grid0).sum()) + int(
            np.asarray(lvl.orb_exists).sum()
        )
        scoring = rew[rew != 0.0]
        assert 1 <= len(scoring) <= n_points
        assert term[-1] and not term[:-1].any()
        assert rew[-1] >= f32(10.0)  # completion bonus observed
        # every scoring value is exactly delta*0.04f (+10.0f at the end)
        candidates = {f32(f32(k) * f32(0.04)) for k in range(1, 5)} | {
            f32(f32(f32(k) * f32(0.04)) + f32(10.0)) for k in range(0, 5)
        }
        assert all(r in candidates for r in scoring), seed
        acts.append(a)
        preds.append((rew, term))
        totals.append(rew.sum())

    R, D, _ = _run_batched(env, bank_np, CHASER_SEEDS, acts)
    for i, seed in enumerate(CHASER_SEEDS):
        rew, term = preds[i]
        n = len(rew)
        if D[: n - 1, i].any():
            # enemy contact (keyed-RNG timing): economy must be
            # bit-exact right up to the death step, which pays 0.0
            end = int(np.argmax(D[:, i]))
            assert np.array_equal(R[:end, i], rew[:end]), (
                f"seed {seed}: prefix mismatch at "
                f"{np.nonzero(R[:end, i] != rew[:end])[0][:5]}"
            )
            assert R[end, i] == f32(0.0), f"seed {seed}: death reward"
        else:
            assert D[n - 1, i], f"seed {seed}: no completion"
            assert np.array_equal(R[:n, i], rew), (
                f"seed {seed}: reward sequence mismatch at "
                f"{np.nonzero(R[:n, i] != rew)[0][:5]}"
            )

    # the full-clear pool: scripted routes that beat the (now
    # reference-lethal) enemies end-to-end, +10 completion included
    bank_np = reference_bank("chaser", CHASER_CLEAR_SEEDS)
    acts, preds = [], []
    for i, seed in enumerate(CHASER_CLEAR_SEEDS):
        lvl = _level_i(bank_np, i)
        route = bots.chaser_full_route(lvl)
        a = bots.route_to_actions(route, bots.CHASER_STEPS_PER_CELL)
        acts.append(a)
        preds.append(bots.chaser_predict(lvl, a))
    R, D, _ = _run_batched(env, bank_np, CHASER_CLEAR_SEEDS, acts)
    for i, seed in enumerate(CHASER_CLEAR_SEEDS):
        rew, term = preds[i]
        n = len(rew)
        assert not D[: n - 1, i].any(), f"seed {seed}: early death"
        assert D[n - 1, i], f"seed {seed}: no completion"
        assert rew[-1] >= f32(10.0)
        assert np.array_equal(R[:n, i], rew), f"seed {seed}" 


# ---------------------------------------------------------------------------
# climber: scripted ascent — +1 per crystal, +10 on collecting all
# ---------------------------------------------------------------------------

# Seeds whose closed-loop ascent reaches the top crystal without enemy
# contact under the pinned reset keys (searched; deterministic).
CLIMBER_SEEDS = [0, 5, 7, 9, 11, 12, 13, 17, 18, 19, 22, 23, 24, 25, 28]


def test_climber_scripted_ascent_return_parity():
    env = pg.make("climber", easy_mode=True)
    bank_np = reference_bank("climber", CLIMBER_SEEDS, easy_mode=True)

    R, D, T, _, _ = _run_closed_loop(
        env, bank_np, CLIMBER_SEEDS,
        bots.ClimberBot,
        lambda gs: (
            np.asarray(gs.pos), np.asarray(gs.vel),
            np.asarray(gs.on_ground), np.asarray(gs.point_taken),
        ),
    )
    for i, seed in enumerate(CLIMBER_SEEDS):
        n_crystals = int(np.asarray(_level_i(bank_np, i).point_exists).sum())
        d = D[:, i]
        assert d.any(), f"seed {seed}: never completed"
        end = int(np.argmax(d))
        r = R[: end + 1, i]
        # Completion step: final crystal (+1) and all-collected (+10)
        # land in the same sub-step — exactly 11.0f (climber.cpp:348-350)
        assert r[end] == f32(11.0), f"seed {seed}: end reward {r[end]}"
        # Every other scoring step is an exact whole crystal count; the
        # sub-step last-write-wins quirk may hide intermediate crystals
        # (climber.cpp:339-355) but never invents rewards.
        mid = r[:end]
        nz = mid[mid != 0.0]
        assert all(v in (f32(1.0), f32(2.0)) for v in nz), (seed, nz)
        assert len(nz) <= n_crystals - 1
        # no termination before completion (no enemy contact)
        assert not d[:end].any()


# ---------------------------------------------------------------------------
# coinrun: run right to the coin — single +10 on the coin step
# ---------------------------------------------------------------------------

COINRUN_SEEDS = [0, 1, 2, 5, 7, 9, 11, 12, 17, 19, 22, 26, 27, 31, 33]


def test_coinrun_scripted_run_right_return_parity():
    env = pg.make("coinrun")
    bank_np = reference_bank("coinrun", COINRUN_SEEDS)

    R, D, T, A, _ = _run_closed_loop(
        env, bank_np, COINRUN_SEEDS,
        bots.CoinrunBot,
        lambda gs: (
            np.asarray(gs.pos), np.asarray(gs.vel), np.asarray(gs.on_ground),
        ),
        max_steps=400,
    )
    for i, seed in enumerate(COINRUN_SEEDS):
        d = D[:, i]
        assert d.any(), f"seed {seed}: never reached the coin"
        end = int(np.argmax(d))
        r = R[: end + 1, i]
        # exactly one scoring event: the coin, +10.0f, terminal
        # (coinrun.cpp:357-371; no other reward source exists)
        assert r[end] == f32(10.0), f"seed {seed}: end reward {r[end]}"
        assert not r[:end].any(), f"seed {seed}: stray rewards"
        assert not d[:end].any()
        # Independent re-simulation (tools/predict.CoinrunSim, a scalar
        # numpy second implementation of coinrun.cpp:341-391 +
        # common_systems.cpp:65-252): the engine's per-step reward
        # sequence and termination step must match it bit-exactly.
        pr, pt = predict.coinrun_predict(_level_i(bank_np, i), A[: end + 1, i])
        assert len(pr) == end + 1, f"seed {seed}: predictor ended at " \
            f"{len(pr) - 1}, engine at {end}"
        assert np.array_equal(r, pr), f"seed {seed}: reward mismatch at " \
            f"{np.nonzero(r != pr)[0][:5]}"
        assert pt[-1] and not pt[:-1].any()


# ---------------------------------------------------------------------------
# jumper: BFS waypoint flight to the carrot — single +10, terminal
# ---------------------------------------------------------------------------

JUMPER_SEEDS = [0, 6, 8, 9, 11, 12, 14, 15, 19, 20, 21, 22, 25, 26, 37]


def test_jumper_scripted_carrot_return_parity():
    env = pg.make("jumper", mode="easy")
    bank_np = reference_bank("jumper", JUMPER_SEEDS)

    R, D, T, A, _ = _run_closed_loop(
        env, bank_np, JUMPER_SEEDS,
        bots.JumperBot,
        lambda gs: (
            np.asarray(gs.pos), np.asarray(gs.vel), np.asarray(gs.on_ground),
            np.asarray(gs.jumps_left), np.asarray(gs.jump_timer),
        ),
        max_steps=500,
    )
    for i, seed in enumerate(JUMPER_SEEDS):
        d = D[:, i]
        assert d.any(), f"seed {seed}: never reached the carrot"
        end = int(np.argmax(d))
        r = R[: end + 1, i]
        # exactly one scoring event: the carrot, +10.0f, terminal
        # (jumper.cpp:362-364; no spike contact on the pinned routes)
        assert r[end] == f32(10.0), f"seed {seed}: end reward {r[end]}"
        assert not r[:end].any(), f"seed {seed}: stray rewards"
        assert not d[:end].any()
        # Independent re-simulation (tools/predict.JumperSim, scalar
        # numpy second implementation of jumper.cpp:341-375 +
        # common_systems.cpp:57-201): bit-exact sequence match.
        pr, pt = predict.jumper_predict(_level_i(bank_np, i), A[: end + 1, i])
        assert len(pr) == end + 1, f"seed {seed}: predictor ended at " \
            f"{len(pr) - 1}, engine at {end}"
        assert np.array_equal(r, pr), f"seed {seed}: reward mismatch at " \
            f"{np.nonzero(r != pr)[0][:5]}"
        assert pt[-1] and not pt[:-1].any()


# ---------------------------------------------------------------------------
# caveflyer: shoot a target (+3 visible), fly to the goal (+10 terminal)
# ---------------------------------------------------------------------------

# Hard mode: easy levels frequently have zero targets (max_obj =
# free_cells/80, tilemap.cpp:232-236). Seeds pinned where the bot lands
# a sub-step-4-visible +3 AND reaches the goal without hazard contact.
CAVEFLYER_SEEDS = [7, 9, 20, 27, 35, 36, 39, 51, 53, 68, 69, 77]


def test_caveflyer_scripted_target_and_goal_return_parity():
    env = pg.make("caveflyer", mode="hard")
    bank_np = reference_bank("caveflyer", CAVEFLYER_SEEDS, mode="hard")

    R, D, T, _, _ = _run_closed_loop(
        env, bank_np, CAVEFLYER_SEEDS,
        bots.CaveflyerBot,
        lambda gs: (
            np.asarray(gs.pos), np.asarray(gs.vel), np.asarray(gs.rot),
            np.asarray(gs.target_alive),
        ),
        max_steps=900,
    )
    for i, seed in enumerate(CAVEFLYER_SEEDS):
        d = D[:, i]
        assert d.any(), f"seed {seed}: never reached the goal"
        end = int(np.argmax(d))
        r = R[: end + 1, i]
        # goal step: exactly +10.0f (or +13.0f if a kill shares the
        # sub-step), terminal (caveflyer.cpp:330-332)
        assert r[end] in (f32(10.0), f32(13.0)), \
            f"seed {seed}: end reward {r[end]}"
        # at least one VISIBLE +3 target kill; every mid scoring value
        # is an exact multiple of 3.0f (sub-step last-write-wins can
        # hide kills but never invents rewards)
        mid = r[:end]
        nz = mid[mid != 0.0]
        total_target = float(nz.sum()) + float(r[end]) - 10.0
        assert total_target >= 3.0, f"seed {seed}: no visible +3"
        assert all(v in (f32(3.0), f32(6.0)) for v in nz), (seed, nz)
        assert not d[:end].any()


# ---------------------------------------------------------------------------
# bossfight: death -10; full phase-machine boss kill +10
# ---------------------------------------------------------------------------

BOSSFIGHT_KILL_SEEDS = [0, 1, 2, 4, 5, 6, 8, 9, 10, 11]


def test_bossfight_noop_death_return_parity():
    """A stationary agent is eventually hit by a boss bullet: exactly
    one scoring step, the terminal -10.0f (bossfight.cpp:318-320), and
    0.0 everywhere before — with the exact death step independently
    predicted by tools/predict.BossfightSim (a scalar numpy second
    implementation of the boss phase machine + bullet kinematics,
    common_systems.cpp:199-386)."""
    seeds = [1, 2, 3, 4, 5, 6, 7, 8, 9, 12]  # all die within ~170 steps
    env = pg.make("bossfight")  # hard (reference default)
    bank_np = reference_bank("bossfight", seeds)
    acts = [[bots.NOOP] * 250 for _ in seeds]
    R, D, keys0 = _run_batched(env, bank_np, seeds, acts)
    for i, seed in enumerate(seeds):
        d = D[:, i]
        assert d.any(), f"seed {seed}: noop agent survived 400 steps?"
        end = int(np.argmax(d))
        assert R[end, i] == f32(-10.0), f"seed {seed}: {R[end, i]}"
        assert not R[:end, i].any()
        key = jax.tree.map(lambda x: x[i], keys0)
        pr, pt = predict.bossfight_predict(
            _level_i(bank_np, i), key, [bots.NOOP] * 250, mode="hard"
        )
        assert len(pr) == end + 1, f"seed {seed}: predictor death at " \
            f"{len(pr) - 1}, engine at {end}"
        assert np.array_equal(R[: end + 1, i], pr), f"seed {seed}"
        assert pt[-1] and not pt[:-1].any()


def test_bossfight_scripted_boss_kill_return_parity():
    """Closed-loop duel through the full phase machine: hide in a
    barrier's shadow while shielded, volley while unshielded, 3 HP x 3
    rounds -> phase_index 6; exactly one scoring step, the terminal
    +10.0f, zero everywhere else (common_systems.cpp:199-287, 385-386).
    Easy mode (half bullet speed, common_systems.cpp:104) — level
    layouts are mode-independent."""
    env = pg.make("bossfight", mode="easy")
    bank_np = reference_bank("bossfight", BOSSFIGHT_KILL_SEEDS)

    R, D, T, A, keys0 = _run_closed_loop(
        env, bank_np, BOSSFIGHT_KILL_SEEDS,
        bots.BossfightBot,
        lambda gs: (
            np.asarray(gs.pos), np.asarray(gs.vel), np.asarray(gs.boss_pos),
            np.asarray(gs.phase_index), np.asarray(gs.bb_pos),
            np.asarray(gs.bb_vel), np.asarray(gs.bb_frame),
        ),
        max_steps=1500,
    )
    for i, seed in enumerate(BOSSFIGHT_KILL_SEEDS):
        d = D[:, i]
        assert d.any(), f"seed {seed}: boss survived"
        end = int(np.argmax(d))
        assert R[end, i] == f32(10.0), f"seed {seed}: end {R[end, i]}"
        assert not R[:end, i].any(), f"seed {seed}: stray rewards"
        assert not d[:end].any()
        # Full-duel independent re-simulation: player volleys, shield
        # bounces, HP rounds and the final phase_index 6 kill step must
        # all reproduce in the numpy second implementation.
        key = jax.tree.map(lambda x: x[i], keys0)
        pr, pt = predict.bossfight_predict(
            _level_i(bank_np, i), key, A[: end + 1, i], mode="easy"
        )
        assert len(pr) == end + 1, f"seed {seed}: predictor ended at " \
            f"{len(pr) - 1}, engine at {end}"
        assert np.array_equal(R[: end + 1, i], pr), f"seed {seed}"
        assert pt[-1] and not pt[:-1].any()
