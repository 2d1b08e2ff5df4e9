"""Bossfight: bullet-hell duel against a phase-shifting boss ship.

JAX re-implementation of the reference's `games/bossfight/`:
  * arena — no tilemap; a fixed 4x4-unit screen rect centered at the
    origin (camera_size / camera_scale * pixels_to_unit, zoom 1.0,
    bossfight.cpp:32, common_systems.cpp:227-228, 512-515); agent clamped
    to the screen edges (common_systems.cpp:540-557);
  * level layout — agent at a random bottom position, boss at the center,
    1-4 meteor barriers at random non-overlapping spots near the bottom
    (a colliding candidate is skipped, not re-drawn —
    bossfight.cpp:428-497); random background + per-episode ship/bullet
    skins (common_systems.cpp:452-469, 723-737);
  * boss phase machine — alternating shielded (timer 180 + u*30 easy /
    u*80 hard, re-drawn every sub-step) and unshielded (300, usually cut
    short by HP loss) phases x3 rounds -> phase_index 6 = boss dead
    (common_systems.cpp:199-287, 385-386). The HP-depletion transition
    does NOT reset phase_timer (common_systems.cpp:271-282) — quirk kept;
  * weapons — 4 bullet-hell patterns while shielded (5-bullet fan;
    "rotating" cross whose k is always 8 because the timer is zeroed
    before k is read, common_systems.cpp:137-139 — faithfully a fixed
    1.75pi cross; radial 8-ring at a random offset; aimed-random) plus a
    passive drizzle while unshielded (fire_pattern,
    common_systems.cpp:103-185); hard mode doubles bullet speed;
  * player bullets — 32-ring, straight up at 0.1/dt, bounce off the
    shield with random lateral velocity for 10dt then vanish; damage HP
    when unshielded (common_systems.cpp:598-655);
  * boss bullets — 64-ring with rotation; explosions pool of 8 shows HP
    depletion damage (common_systems.cpp:70-72, 89-100, 187-197);
  * rewards — -10 agent death, +10 boss death; terminate on either
    (bossfight.cpp:309-324).

Default mode is hard (common_systems.h:63-64).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from ..core import spaces
from ..physics.aabb import check_collision
from ..render import atlas as atlas_lib
from ..render import compositor as C

NAME = "bossfight"
NUM_ACTIONS = 15
SUB_STEPS = 4  # bossfight.cpp:44
DT = 1.0 / SUB_STEPS
ZOOM = 1.0  # bossfight.cpp:32
PPU = 16.0 * ZOOM
HALF = 2.0  # screen rect (-2,-2,4,4): 64 obs px / 16 ppu / 2

# Agent (common_systems.cpp:495-501)
MOVE_MIX = 0.5
MOVE_SPEED = 0.1
A_BULLET_TIME = 5.0
A_BULLET_SPEED = 0.1
BOUNCE_SPEED = 0.05
BOUNCE_TIME = 10.0
EXPLOSION_RATE = 0.3

# Boss (common_systems.cpp:202-209)
UNSHIELDED_TIME = 300.0
ATTACK_TIME = 8.0
NUM_WEAPONS = 4
MOVE_TIME = 70.0
BOSS_HP = 3
DAMAGE_TIME = 80.0

NUM_A_BULLETS = 32
NUM_B_BULLETS = 64
# Render-only slot compaction (_cull_alive): worst sustained boss-bullet
# load is pattern 2's 8 bullets / 10 steps with ~40-step lifetimes ≈ 32
# live; the player ring turns over every 5 steps (few live). Overflow
# drops the stalest ring slots from RENDERING only (physics keeps all).
BB_CULL = 36
AB_CULL = 12
NUM_EXPLOSIONS = 8
MAX_BARRIERS = 4

NUM_BGS = 13  # bossfight.cpp:54-67


@dataclasses.dataclass(frozen=True)
class Config:
    mode: str = "hard"  # common_systems.h:64

    @property
    def bullet_speed(self):
        return 0.1 if self.mode == "hard" else 0.05  # common_systems.cpp:104

    @property
    def shield_jitter(self):
        return 80.0 if self.mode == "hard" else 30.0  # common_systems.cpp:202


@struct.dataclass
class Level:
    agent_pos0: jnp.ndarray  # f32 [2]
    barrier_pos: jnp.ndarray  # f32 [4, 2]
    barrier_exists: jnp.ndarray  # bool [4]
    barrier_tex: jnp.ndarray  # i32 [4]
    boss_tex: jnp.ndarray  # i32
    ship_tex: jnp.ndarray  # i32
    bullet_tex: jnp.ndarray  # i32
    bg_index: jnp.ndarray  # i32


@struct.dataclass
class State:
    level: Level
    pos: jnp.ndarray  # f32 [2] agent
    vel: jnp.ndarray  # f32 [2]
    alive: jnp.ndarray  # bool — System_Agent::alive is a persistent member
    #   (common_systems.h:131): boss-bullet kills set it *after* this
    #   sub-step's terminated check, so they register one sub-step late
    #   (common_systems.cpp:322-329 vs bossfight.cpp:311-320)
    a_bullet_timer: jnp.ndarray  # f32
    ab_pos: jnp.ndarray  # f32 [32, 2]
    ab_vel: jnp.ndarray  # f32 [32, 2]
    ab_frame: jnp.ndarray  # f32 [32]
    ab_bouncing: jnp.ndarray  # bool [32]
    ab_bounce_timer: jnp.ndarray  # f32 [32]
    ab_num: jnp.ndarray  # i32
    ab_next: jnp.ndarray  # i32
    boss_pos: jnp.ndarray  # f32 [2]
    boss_vel: jnp.ndarray  # f32 [2]
    phase_timer: jnp.ndarray  # f32
    phase_index: jnp.ndarray  # i32
    weapon_index: jnp.ndarray  # i32
    attack_timer: jnp.ndarray  # f32
    hp: jnp.ndarray  # i32
    move_timer: jnp.ndarray  # f32
    explosion_timer: jnp.ndarray  # f32
    damage_timer: jnp.ndarray  # f32
    bb_pos: jnp.ndarray  # f32 [64, 2]
    bb_vel: jnp.ndarray  # f32 [64, 2]
    bb_rot: jnp.ndarray  # f32 [64]
    bb_frame: jnp.ndarray  # f32 [64]
    bb_num: jnp.ndarray  # i32
    bb_next: jnp.ndarray  # i32
    ex_pos: jnp.ndarray  # f32 [8, 2]
    ex_frame: jnp.ndarray  # f32 [8]
    ex_num: jnp.ndarray  # i32
    ex_next: jnp.ndarray  # i32
    t: jnp.ndarray  # i32
    rng: jax.Array


# ---------------------------------------------------------------------------
# Assets
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _assets():
    names = []
    names += [f"boss_ship_{k}" for k in atlas_lib.BOSS_SHIP_COLORS]
    names += [f"pship_{k}" for k in atlas_lib.PLAYER_SHIP_COLORS]
    names += [f"bolt_{k}" for k in atlas_lib.LASER_COLORS]
    names += ["shield", "barrier0", "barrier1", "barrier2"]
    names += [f"explosion{i}" for i in range(5)]
    atlas, idx = atlas_lib.build_atlas(tuple(names))
    bgs = atlas_lib.build_backgrounds("space", NUM_BGS)
    return dict(
        atlas_p=atlas.transpose(3, 0, 1, 2),
        idx=idx,
        bgs_p=bgs.transpose(3, 0, 1, 2),
        boss_ships=np.array(
            [idx[f"boss_ship_{k}"] for k in atlas_lib.BOSS_SHIP_COLORS], np.int32
        ),
        pships=np.array(
            [idx[f"pship_{k}"] for k in atlas_lib.PLAYER_SHIP_COLORS], np.int32
        ),
        bolts=np.array(
            [idx[f"bolt_{k}"] for k in atlas_lib.LASER_COLORS], np.int32
        ),
        barriers=np.array([idx[f"barrier{i}"] for i in range(3)], np.int32),
        expl=np.array([idx[f"explosion{i}"] for i in range(5)], np.int32),
    )


# ---------------------------------------------------------------------------
# Generation (bossfight.cpp:426-497 reset())
# ---------------------------------------------------------------------------

def generate(cfg: Config, key) -> Level:
    k_agent, k_nbar, k_bars, k_btex, k_boss, k_ship, k_bullet, k_bg = (
        jax.random.split(key, 8)
    )
    agent_x = (jax.random.uniform(k_agent) * 2.0 - 1.0) * HALF
    agent_pos0 = jnp.stack([agent_x, jnp.float32(HALF)])

    num_barriers = jax.random.randint(k_nbar, (), 1, MAX_BARRIERS + 1)
    bkeys = jax.random.split(k_bars, MAX_BARRIERS)
    tkeys = jax.random.split(k_btex, MAX_BARRIERS)
    barrier_pos = jnp.zeros((MAX_BARRIERS, 2), jnp.float32)
    barrier_ex = jnp.zeros(MAX_BARRIERS, bool)
    barrier_tex = jnp.zeros(MAX_BARRIERS, jnp.int32)
    for i in range(MAX_BARRIERS):
        kx, ky = jax.random.split(bkeys[i])
        px = (jax.random.uniform(kx) * 2.0 - 1.0) * HALF * 0.9
        py = HALF - jax.random.uniform(ky, minval=0.7, maxval=1.2)
        want = i < num_barriers
        # skip candidates overlapping an existing barrier
        # (bossfight.cpp:462-474); barrier rects are 0.2x0.2 centered
        clash = jnp.bool_(False)
        for j in range(i):
            clash = clash | (
                barrier_ex[j]
                & check_collision(
                    px - 0.1, py - 0.1, 0.2, 0.2,
                    barrier_pos[j, 0] - 0.1, barrier_pos[j, 1] - 0.1, 0.2, 0.2,
                )
            )
        ok = want & ~clash
        barrier_pos = barrier_pos.at[i].set(jnp.stack([px, py]))
        barrier_ex = barrier_ex.at[i].set(ok)
        barrier_tex = barrier_tex.at[i].set(jax.random.randint(tkeys[i], (), 0, 3))

    return Level(
        agent_pos0=agent_pos0,
        barrier_pos=barrier_pos,
        barrier_exists=barrier_ex,
        barrier_tex=barrier_tex,
        boss_tex=jax.random.randint(k_boss, (), 0, 4),
        ship_tex=jax.random.randint(k_ship, (), 0, 4),
        bullet_tex=jax.random.randint(k_bullet, (), 0, 3),
        bg_index=jax.random.randint(k_bg, (), 0, NUM_BGS),
    )


def reset(cfg: Config, level: Level, key) -> State:
    return State(
        level=level,
        pos=level.agent_pos0,
        vel=jnp.zeros(2, jnp.float32),
        alive=jnp.bool_(True),
        a_bullet_timer=jnp.float32(0.0),
        ab_pos=jnp.zeros((NUM_A_BULLETS, 2), jnp.float32),
        ab_vel=jnp.zeros((NUM_A_BULLETS, 2), jnp.float32),
        ab_frame=jnp.full(NUM_A_BULLETS, -1.0, jnp.float32),
        ab_bouncing=jnp.zeros(NUM_A_BULLETS, bool),
        ab_bounce_timer=jnp.zeros(NUM_A_BULLETS, jnp.float32),
        ab_num=jnp.int32(0),
        ab_next=jnp.int32(0),
        boss_pos=jnp.zeros(2, jnp.float32),
        boss_vel=jnp.zeros(2, jnp.float32),
        phase_timer=jnp.float32(0.0),
        phase_index=jnp.int32(0),
        weapon_index=jnp.int32(0),
        attack_timer=jnp.float32(0.0),
        hp=jnp.int32(BOSS_HP),
        move_timer=jnp.float32(0.0),
        explosion_timer=jnp.float32(0.0),
        damage_timer=jnp.float32(0.0),
        bb_pos=jnp.zeros((NUM_B_BULLETS, 2), jnp.float32),
        bb_vel=jnp.zeros((NUM_B_BULLETS, 2), jnp.float32),
        bb_rot=jnp.zeros(NUM_B_BULLETS, jnp.float32),
        bb_frame=jnp.full(NUM_B_BULLETS, -1.0, jnp.float32),
        bb_num=jnp.int32(0),
        bb_next=jnp.int32(0),
        ex_pos=jnp.zeros((NUM_EXPLOSIONS, 2), jnp.float32),
        ex_frame=jnp.full(NUM_EXPLOSIONS, -1.0, jnp.float32),
        ex_num=jnp.int32(0),
        ex_next=jnp.int32(0),
        t=jnp.int32(0),
        rng=key,
    )


# ---------------------------------------------------------------------------
# Step (bossfight.cpp:308-325)
# ---------------------------------------------------------------------------

def _window(next_i, num, size):
    j = jnp.arange(size)
    return jnp.mod(next_i - 1 - j, size) < num


def _ring_push(pos, vel, rot, frame, num, nxt, new_pos, new_vel, new_rot, cond,
               size):
    """fire() (common_systems.cpp:75-87): append when cond & num < size.

    The slot write is a one-hot mask, not `.at[slot].set` — under vmap a
    traced-index update lowers to a batched scatter."""
    can = cond & (num < size)
    upd = can & (jnp.arange(size) == nxt)
    pos = jnp.where(upd[:, None], new_pos[None, :], pos)
    vel = jnp.where(upd[:, None], new_vel[None, :], vel)
    rot = jnp.where(upd, new_rot, rot)
    frame = jnp.where(upd, 0.0, frame)
    nxt = jnp.where(can, (nxt + 1) % size, nxt)
    num = num + can.astype(jnp.int32)
    return pos, vel, rot, frame, num, nxt


def _fire_pattern(state_tuple, boss_pos, pattern, attack_timer, key, bullet_speed):
    """fire_pattern (common_systems.cpp:103-185). Fires at most one volley
    per sub-step; returns updated ring + timer. Bullet velocity is
    (cos r, -sin r) * speed — angles are y-up (common_systems.cpp:80)."""
    bb_pos, bb_vel, bb_rot, bb_frame, bb_num, bb_next = state_tuple
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1)

    # Which rotations fire this sub-step (static 8-slot volley buffer)
    rots = jnp.zeros(8, jnp.float32)
    fires = jnp.zeros(8, bool)

    # passive (-1): p = 0.1*dt single aimed-down-random bullet
    passive_fire = (pattern == -1) & (u1 < 0.1 * DT)
    passive_rot = jnp.pi * (1.0 + jax.random.uniform(k2))

    timer_done = jnp.where(
        pattern == 0, attack_timer >= 8.0,
        jnp.where(pattern == 1, attack_timer >= 5.0,
                  jnp.where(pattern == 2, attack_timer >= 10.0,
                            attack_timer >= 4.0)),
    ) & (pattern >= 0)

    # pattern 0: 5-bullet downward fan
    fan_rots = jnp.pi * 1.5 + (jnp.arange(5) - 2) * jnp.pi * 0.125
    # pattern 1: fixed cross at 1.75pi + i*pi/2 (k always 8, see docstring)
    cross_rots = jnp.pi * (1.25 + 8 * 0.0625) + jnp.arange(4) * jnp.pi * 0.5
    # pattern 2: radial 8 at random offset
    radial_rots = jnp.pi * 0.25 * jnp.arange(8) + jax.random.uniform(k2) * 2 * jnp.pi
    # pattern 3: single aimed-random
    aimed_rot = jnp.pi * (1.0 + jax.random.uniform(k2))

    n_per = jnp.where(pattern == 0, 5,
                      jnp.where(pattern == 1, 4,
                                jnp.where(pattern == 2, 8, 1)))
    idx = jnp.arange(8)
    volley_rots = jnp.where(
        pattern == 0, jnp.pad(fan_rots, (0, 3)),
        jnp.where(pattern == 1, jnp.pad(cross_rots, (0, 4)),
                  jnp.where(pattern == 2, radial_rots,
                            jnp.full(8, aimed_rot))),
    )
    fires = (idx < n_per) & timer_done
    rots = volley_rots
    # passive single shot uses slot 0
    fires = jnp.where(pattern == -1, idx == 0, fires) & (
        (pattern >= 0) & timer_done | ((pattern == -1) & passive_fire)
    )
    rots = jnp.where(pattern == -1, passive_rot, rots)

    for i in range(8):
        v = jnp.stack([jnp.cos(rots[i]), -jnp.sin(rots[i])]) * bullet_speed
        bb_pos, bb_vel, bb_rot, bb_frame, bb_num, bb_next = _ring_push(
            bb_pos, bb_vel, bb_rot, bb_frame, bb_num, bb_next,
            boss_pos, v, rots[i], fires[i], NUM_B_BULLETS,
        )

    attack_timer = jnp.where(
        pattern >= 0, jnp.where(timer_done, 0.0, attack_timer + DT), attack_timer
    )
    return (bb_pos, bb_vel, bb_rot, bb_frame, bb_num, bb_next), attack_timer


def step(cfg: Config, state: State, action):
    level = state.level
    a = action.astype(jnp.int32)

    movement_x = (
        ((a == 6) | (a == 7) | (a == 8)).astype(jnp.float32)
        - ((a == 0) | (a == 1) | (a == 2)).astype(jnp.float32)
    )
    movement_y = (
        ((a == 2) | (a == 5) | (a == 8)).astype(jnp.float32)
        - ((a == 0) | (a == 3) | (a == 6)).astype(jnp.float32)
    )
    fire = a == 9

    s = state
    done = jnp.bool_(False)
    reward = jnp.float32(0.0)
    rng = s.rng

    alive = s.alive
    (pos, vel, a_btimer) = (s.pos, s.vel, s.a_bullet_timer)
    (ab_pos, ab_vel, ab_frame) = (s.ab_pos, s.ab_vel, s.ab_frame)
    (ab_bounc, ab_btime) = (s.ab_bouncing, s.ab_bounce_timer)
    (ab_num, ab_next) = (s.ab_num, s.ab_next)
    (boss_pos, boss_vel) = (s.boss_pos, s.boss_vel)
    (phase_timer, phase_index) = (s.phase_timer, s.phase_index)
    (weapon_index, attack_timer, hp) = (s.weapon_index, s.attack_timer, s.hp)
    (move_timer, explosion_timer, damage_timer) = (
        s.move_timer, s.explosion_timer, s.damage_timer
    )
    (bb_pos, bb_vel, bb_rot, bb_frame) = (s.bb_pos, s.bb_vel, s.bb_rot, s.bb_frame)
    (bb_num, bb_next) = (s.bb_num, s.bb_next)
    (ex_pos, ex_frame, ex_num, ex_next) = (s.ex_pos, s.ex_frame, s.ex_num, s.ex_next)

    barrier_rects = (
        level.barrier_pos[:, 0] - 0.1, level.barrier_pos[:, 1] - 0.1, 0.2, 0.2
    )

    for _ in range(SUB_STEPS):
        active = ~done
        rng, k_shield, k_weapon, k_pattern, k_move, k_damage, k_bounce = (
            jax.random.split(rng, 7)
        )

        # ================= System_Agent (common_systems.cpp:494-683) ====
        n_vel = jnp.stack([
            vel[0] + MOVE_MIX * (movement_x * MOVE_SPEED - vel[0]) * DT,
            vel[1] + MOVE_MIX * (-movement_y * MOVE_SPEED - vel[1]) * DT,
        ])
        n_pos = pos + n_vel * DT
        # screen-edge clamp, agent rect (-0.15,-0.1,0.3,0.2)
        lo_x = -HALF + 0.15
        hi_x = HALF - 0.15
        lo_y = -HALF + 0.1
        hi_y = HALF - 0.1
        clamped_x = jnp.clip(n_pos[0], lo_x, hi_x)
        clamped_y = jnp.clip(n_pos[1], lo_y, hi_y)
        n_vel = jnp.stack([
            jnp.where(clamped_x != n_pos[0], 0.0, n_vel[0]),
            jnp.where(clamped_y != n_pos[1], 0.0, n_vel[1]),
        ])
        n_pos = jnp.stack([clamped_x, clamped_y])

        # fire player bullet (timer quirk as caveflyer); one-hot slot
        # update, not a scatter (see _ring_push)
        can_spawn = fire & (a_btimer == 0.0) & (ab_num < NUM_A_BULLETS)
        upd_ab = can_spawn & (jnp.arange(NUM_A_BULLETS) == ab_next)
        ab_vel_n = jnp.where(
            upd_ab[:, None],
            jnp.array([0.0, -A_BULLET_SPEED])[None, :], ab_vel,
        )
        ab_pos_n = jnp.where(upd_ab[:, None], n_pos[None, :], ab_pos)
        ab_frame_n = jnp.where(upd_ab, 0.0, ab_frame)
        ab_bounc_n = jnp.where(upd_ab, False, ab_bounc)
        ab_btime_n = jnp.where(upd_ab, 0.0, ab_btime)
        n_ab_next = jnp.where(can_spawn, (ab_next + 1) % NUM_A_BULLETS, ab_next)
        n_ab_num = ab_num + can_spawn.astype(jnp.int32)
        n_abtimer = jnp.where(
            can_spawn, A_BULLET_TIME,
            jnp.where(fire, jnp.maximum(0.0, a_btimer - DT), a_btimer),
        )

        # agent vs hazards: boss + barriers (agent rect (-0.15,-0.1,.3,.2))
        contact = check_collision(
            n_pos[0] - 0.15, n_pos[1] - 0.1, 0.3, 0.2,
            boss_pos[0] - 0.6, boss_pos[1] - 0.4, 1.2, 0.8,
        ) | (
            level.barrier_exists & check_collision(
                n_pos[0] - 0.15, n_pos[1] - 0.1, 0.3, 0.2, *barrier_rects
            )
        ).any()
        n_alive = alive & ~contact
        # the value the terminated/reward check observes this sub-step
        agent_alive_now = n_alive

        # player bullets
        window = _window(n_ab_next, n_ab_num, NUM_A_BULLETS)
        live = window & (ab_frame_n == 0.0)
        bx, by = ab_pos_n[:, 0], ab_pos_n[:, 1]
        offscreen = live & ~check_collision(
            bx - 0.01, by - 0.01, 0.02, 0.02, -HALF, -HALF, 2 * HALF, 2 * HALF
        )
        shielded = phase_index % 2 == 0
        boss_hit = live & ~offscreen & check_collision(
            bx - 0.01, by - 0.01, 0.02, 0.02,
            boss_pos[0] - 0.6, boss_pos[1] - 0.4, 1.2, 0.8,
        )
        bounce = boss_hit & shielded
        damage = boss_hit & ~shielded
        barrier_hit = live & ~offscreen & ~boss_hit & (
            level.barrier_exists[None, :] & jax.vmap(
                lambda px, py: check_collision(
                    px - 0.01, py - 0.01, 0.02, 0.02, *barrier_rects
                )
            )(bx, by)
        ).any(axis=1)

        bkeys = jax.random.uniform(k_bounce, (NUM_A_BULLETS,), minval=-1.0, maxval=1.0)
        ab_vel_n = jnp.where(
            bounce[:, None],
            jnp.stack([bkeys * BOUNCE_SPEED,
                       jnp.full(NUM_A_BULLETS, BOUNCE_SPEED)], axis=1),
            ab_vel_n,
        )
        ab_btime_n = jnp.where(bounce, BOUNCE_TIME, ab_btime_n)
        ab_bounc_n = ab_bounc_n | bounce
        explode_now = damage | barrier_hit
        ab_vel_n = jnp.where(explode_now[:, None], 0.0, ab_vel_n)
        ab_frame_n = jnp.where(explode_now, 1.0, ab_frame_n)
        ab_frame_n = jnp.where(offscreen, 5.0, ab_frame_n)
        ab_vel_n = jnp.where(offscreen[:, None], 0.0, ab_vel_n)
        n_hp = jnp.maximum(0, hp - damage.sum())

        ab_pos_n = jnp.where(window[:, None], ab_pos_n + ab_vel_n * DT, ab_pos_n)
        expired = window & (ab_frame_n >= 5.0)
        exploding = window & (ab_frame_n >= 1.0) & (ab_frame_n < 5.0)
        ab_frame_n = jnp.where(exploding, ab_frame_n + EXPLOSION_RATE * DT, ab_frame_n)
        # bounce timeout destroys the bullet (common_systems.cpp:666-676)
        ticking = window & ab_bounc_n & (ab_btime_n > 0.0)
        ab_btime_n = jnp.where(ticking, jnp.maximum(0.0, ab_btime_n - DT), ab_btime_n)
        bounce_out = window & ab_bounc_n & (ab_btime_n == 0.0) & ~ticking
        expired = expired | bounce_out
        ab_frame_n = jnp.where(expired, -1.0, ab_frame_n)
        n_ab_num = n_ab_num - expired.sum()

        # ================= System_Mob_AI (boss) =========================
        shielded_phase_time = 180.0 + jax.random.uniform(k_shield) * cfg.shield_jitter
        # phase start re-rolls weapon + HP (common_systems.cpp:237-243)
        at_start = phase_timer == 0.0
        n_weapon = jnp.where(
            at_start, jax.random.randint(k_weapon, (), 0, NUM_WEAPONS), weapon_index
        )
        n_attack = jnp.where(at_start, 0.0, attack_timer)
        n_hp = jnp.where(at_start, BOSS_HP, n_hp)

        adv_shield = shielded & (phase_timer >= shielded_phase_time)
        adv_unshield = ~shielded & (phase_timer >= UNSHIELDED_TIME)
        n_phase_timer = jnp.where(adv_shield | adv_unshield, 0.0, phase_timer + DT)
        n_phase_index = phase_index + (adv_shield | adv_unshield).astype(jnp.int32)

        pattern = jnp.where(shielded, n_weapon, -1)
        (bb_pos, bb_vel, bb_rot, bb_frame, bb_num, bb_next), n_attack = (
            _fire_pattern(
                (bb_pos, bb_vel, bb_rot, bb_frame, bb_num, bb_next),
                boss_pos, pattern, n_attack, k_pattern, cfg.bullet_speed,
            )
        )

        # HP depleted -> damage show + extra phase advance
        # (common_systems.cpp:271-282; note phase_timer is NOT reset)
        depleted = ~shielded & (n_hp == 0)
        kx, ky = jax.random.split(k_damage)
        show = depleted & (explosion_timer >= 8.0)
        n_expl_timer = jnp.where(
            depleted, jnp.where(show, 0.0, explosion_timer + DT), explosion_timer
        )
        epos = boss_pos + jnp.stack([
            jax.random.uniform(kx, minval=-0.5, maxval=0.5),
            jax.random.uniform(ky, minval=-0.5, maxval=0.5),
        ])
        can_ex = show & (ex_num < NUM_EXPLOSIONS)
        upd_ex = can_ex & (jnp.arange(NUM_EXPLOSIONS) == ex_next)
        ex_pos_n = jnp.where(upd_ex[:, None], epos[None, :], ex_pos)
        ex_frame_n = jnp.where(upd_ex, 0.0, ex_frame)
        n_ex_next = jnp.where(can_ex, (ex_next + 1) % NUM_EXPLOSIONS, ex_next)
        n_ex_num = ex_num + can_ex.astype(jnp.int32)

        dmg_done = depleted & (damage_timer >= DAMAGE_TIME)
        n_damage_timer = jnp.where(
            depleted, jnp.where(dmg_done, 0.0, damage_timer + DT), damage_timer
        )
        n_phase_index = n_phase_index + dmg_done.astype(jnp.int32)
        n_hp = jnp.where(dmg_done, BOSS_HP, n_hp)

        # boss movement (common_systems.cpp:286-298)
        kmx, kmy = jax.random.split(k_move)
        retarget = move_timer >= MOVE_TIME
        n_move_timer = jnp.where(retarget, 0.0, move_timer + DT)
        target = jnp.stack([
            (jax.random.uniform(kmx) * 2.0 - 1.0) * 0.5 * (2 * HALF) * 0.7,
            ((jax.random.uniform(kmy) * 2.0 - 1.0) * 0.5 - 0.3) * (2 * HALF) * 0.5,
        ])
        n_boss_vel = jnp.where(
            retarget, (target - boss_pos) / MOVE_TIME, boss_vel
        )
        n_boss_pos = boss_pos + n_boss_vel * DT

        # boss bullets (common_systems.cpp:303-365)
        bwindow = _window(bb_next, bb_num, NUM_B_BULLETS)
        blive = bwindow & (bb_frame == 0.0)
        bbx, bby = bb_pos[:, 0], bb_pos[:, 1]
        boffscreen = blive & ~check_collision(
            bbx - 0.01, bby - 0.01, 0.02, 0.02, -HALF, -HALF, 2 * HALF, 2 * HALF
        )
        hit_agent = blive & ~boffscreen & check_collision(
            bbx - 0.01, bby - 0.01, 0.02, 0.02,
            n_pos[0] - 0.15, n_pos[1] - 0.1, 0.3, 0.2,
        )
        n_alive = n_alive & ~hit_agent.any()  # registers next sub-step
        hit_barrier = blive & ~boffscreen & ~hit_agent & (
            level.barrier_exists[None, :] & jax.vmap(
                lambda px, py: check_collision(
                    px - 0.01, py - 0.01, 0.02, 0.02, *barrier_rects
                )
            )(bbx, bby)
        ).any(axis=1)
        bimpact = hit_agent | hit_barrier
        bb_vel = jnp.where((bimpact | boffscreen)[:, None], 0.0, bb_vel)
        bb_frame = jnp.where(bimpact, 1.0, bb_frame)
        bb_frame = jnp.where(boffscreen, 5.0, bb_frame)
        bb_pos = jnp.where(bwindow[:, None], bb_pos + bb_vel * DT, bb_pos)
        bexpired = bwindow & (bb_frame >= 5.0)
        bexploding = bwindow & (bb_frame >= 1.0) & (bb_frame < 5.0)
        bb_frame = jnp.where(bexploding, bb_frame + EXPLOSION_RATE * DT, bb_frame)
        bb_frame = jnp.where(bexpired, -1.0, bb_frame)
        bb_num = bb_num - bexpired.sum()

        # explosion pool animation (common_systems.cpp:367-383)
        ewindow = _window(n_ex_next, n_ex_num, NUM_EXPLOSIONS)
        eexpired = ewindow & (ex_frame_n >= 4.0)
        ex_frame_n = jnp.where(
            eexpired, -1.0,
            jnp.where(ewindow & (ex_frame_n >= 0.0),
                      ex_frame_n + EXPLOSION_RATE * DT, ex_frame_n),
        )
        n_ex_num = n_ex_num - eexpired.sum()

        boss_dead = n_phase_index >= 6  # common_systems.cpp:385-386

        sub_reward = (
            (~agent_alive_now).astype(jnp.float32) * -10.0
            + boss_dead.astype(jnp.float32) * 10.0
        )

        # commit
        alive = jnp.where(active, n_alive, alive)
        pos = jnp.where(active, n_pos, pos)
        vel = jnp.where(active, n_vel, vel)
        a_btimer = jnp.where(active, n_abtimer, a_btimer)
        ab_pos = jnp.where(active, ab_pos_n, ab_pos)
        ab_vel = jnp.where(active, ab_vel_n, ab_vel)
        ab_frame = jnp.where(active, ab_frame_n, ab_frame)
        ab_bounc = jnp.where(active, ab_bounc_n, ab_bounc)
        ab_btime = jnp.where(active, ab_btime_n, ab_btime)
        ab_num = jnp.where(active, n_ab_num, ab_num)
        ab_next = jnp.where(active, n_ab_next, ab_next)
        boss_pos = jnp.where(active, n_boss_pos, boss_pos)
        boss_vel = jnp.where(active, n_boss_vel, boss_vel)
        phase_timer = jnp.where(active, n_phase_timer, phase_timer)
        phase_index = jnp.where(active, n_phase_index, phase_index)
        weapon_index = jnp.where(active, n_weapon, weapon_index)
        attack_timer = jnp.where(active, n_attack, attack_timer)
        hp = jnp.where(active, n_hp, hp)
        move_timer = jnp.where(active, n_move_timer, move_timer)
        explosion_timer = jnp.where(active, n_expl_timer, explosion_timer)
        damage_timer = jnp.where(active, n_damage_timer, damage_timer)
        ex_pos = jnp.where(active, ex_pos_n, ex_pos)
        ex_frame = jnp.where(active, ex_frame_n, ex_frame)
        ex_num = jnp.where(active, n_ex_num, ex_num)
        ex_next = jnp.where(active, n_ex_next, ex_next)
        reward = jnp.where(active, sub_reward, reward)
        done = done | (active & (~agent_alive_now | boss_dead))

    new_state = State(
        level=level, pos=pos, vel=vel, alive=alive, a_bullet_timer=a_btimer,
        ab_pos=ab_pos, ab_vel=ab_vel, ab_frame=ab_frame,
        ab_bouncing=ab_bounc, ab_bounce_timer=ab_btime,
        ab_num=ab_num, ab_next=ab_next,
        boss_pos=boss_pos, boss_vel=boss_vel,
        phase_timer=phase_timer, phase_index=phase_index,
        weapon_index=weapon_index, attack_timer=attack_timer, hp=hp,
        move_timer=move_timer, explosion_timer=explosion_timer,
        damage_timer=damage_timer,
        bb_pos=bb_pos, bb_vel=bb_vel, bb_rot=bb_rot, bb_frame=bb_frame,
        bb_num=bb_num, bb_next=bb_next,
        ex_pos=ex_pos, ex_frame=ex_frame, ex_num=ex_num, ex_next=ex_next,
        t=state.t + 1, rng=rng,
    )
    return new_state, reward, done, {}


# ---------------------------------------------------------------------------
# Rendering (bossfight.cpp:400-424)
# ---------------------------------------------------------------------------

def observe(cfg: Config, state: State):
    A = _assets()
    level = state.level
    ppu = PPU * (C.OBS / 64.0)  # window renders scale, bossfight.cpp:412
    wx, wy = C.camera_coords(ppu, jnp.float32(0.0), jnp.float32(0.0))

    img = C.clear()
    # background spans the whole screen (bossfight.cpp:416-418)
    img = C.draw_background(
        img, jnp.asarray(A["bgs_p"]), level.bg_index, wx, wy,
        origin_x=-HALF, origin_y=-HALF, size_units=2 * HALF,
    )
    # barriers (sprite offset -0.15, scale 0.3 — bossfight.cpp:480)
    bsid = jnp.asarray(A["barriers"])[level.barrier_tex]
    img = C.draw_sprites(
        img, A["atlas_p"], bsid,
        level.barrier_pos[:, 0] - 0.15, level.barrier_pos[:, 1] - 0.15,
        jnp.full(MAX_BARRIERS, 0.3), jnp.full(MAX_BARRIERS, 0.3), wx, wy,
        alives=level.barrier_exists,
    )

    # boss bullets + their explosions (size 0.1: laser ~0.3u, expl ~0.38u)
    bolt_sid = jnp.asarray(A["bolts"])[level.bullet_tex]
    bwindow = _window(state.bb_next, state.bb_num, NUM_B_BULLETS)
    for i in range(NUM_B_BULLETS):
        frame = state.bb_frame[i]
        is_live = bwindow[i] & (frame == 0.0)
        is_expl = bwindow[i] & (frame >= 1.0)
        eidx = jnp.clip(frame.astype(jnp.int32) - 1, 0, 4)
        sid = jnp.where(is_live, bolt_sid, jnp.asarray(A["expl"])[eidx])
        w = jnp.where(is_live, 0.3, 0.38)
        img = C.draw_sprite(
            img, A["atlas_p"], sid,
            state.bb_pos[i, 0] - w * 0.5, state.bb_pos[i, 1] - w * 0.5,
            w, w, wx, wy,
            rotation=state.bb_rot[i] + jnp.pi * 0.5,
            alive=is_live | is_expl,
        )

    # boss ship (size 0.25: 106x80 px -> 1.66 x 1.25 units)
    img = C.draw_sprite(
        img, A["atlas_p"], jnp.asarray(A["boss_ships"])[level.boss_tex],
        state.boss_pos[0] - 0.83, state.boss_pos[1] - 0.625, 1.66, 1.25, wx, wy,
    )
    # shield while in a shielded phase (alpha 0.7; 143x119 px * 0.25)
    img = C.draw_sprite(
        img, A["atlas_p"], A["idx"]["shield"],
        state.boss_pos[0] - 1.117, state.boss_pos[1] - 0.93, 2.234, 1.86, wx, wy,
        alive=state.phase_index % 2 == 0, alpha=0.7,
    )
    # damage explosions (size 0.3 -> ~1.1 units)
    ewindow = _window(state.ex_next, state.ex_num, NUM_EXPLOSIONS)
    for i in range(NUM_EXPLOSIONS):
        eidx = jnp.clip(state.ex_frame[i].astype(jnp.int32), 0, 4)
        img = C.draw_sprite(
            img, A["atlas_p"], jnp.asarray(A["expl"])[eidx],
            state.ex_pos[i, 0] - 0.56, state.ex_pos[i, 1] - 0.56,
            1.125, 1.125, wx, wy,
            alive=ewindow[i] & (state.ex_frame[i] >= 0.0),
        )

    # player bullets (size 0.05 -> 0.15u) + ship (0.05*99/16 = 0.31u)
    awindow = _window(state.ab_next, state.ab_num, NUM_A_BULLETS)
    for i in range(NUM_A_BULLETS):
        frame = state.ab_frame[i]
        is_live = awindow[i] & (frame == 0.0)
        is_expl = awindow[i] & (frame >= 1.0)
        eidx = jnp.clip(frame.astype(jnp.int32) - 1, 0, 4)
        sid = jnp.where(is_live, bolt_sid, jnp.asarray(A["expl"])[eidx])
        w = jnp.where(is_live, 0.15, 0.19)
        img = C.draw_sprite(
            img, A["atlas_p"], sid,
            state.ab_pos[i, 0] - w * 0.5, state.ab_pos[i, 1] - w * 0.5,
            w, w, wx, wy,
            alive=is_live | is_expl,
        )
    img = C.draw_sprite(
        img, A["atlas_p"], jnp.asarray(A["pships"])[level.ship_tex],
        state.pos[0] - 0.155, state.pos[1] - 0.117, 0.31, 0.234, wx, wy,
    )
    return C.finalize(img)


def obs_space(cfg: Config):
    return spaces.Box(0, 255, (C.OBS, C.OBS, 3))


def action_space(cfg: Config):
    return spaces.MultiDiscrete((NUM_ACTIONS,))


# ---------------------------------------------------------------------------
# Batched fast renderer: fixed camera + pixel-snapped stamp groups
# ---------------------------------------------------------------------------

ROT_BINS = 16  # boss-bullet rotation quantization for the stamp bank


@functools.lru_cache(maxsize=None)
def _stamp_banks():
    """Pre-rasterized patch banks (see compositor.composite_stamps).

    Rotated boss bullets (bossfight renders each bullet rotated to its
    heading) become 16 pre-rasterized rotation variants per bolt color —
    replacing the per-pixel rotated-gather path that needed one full
    [N, 64, 64, 4] temp per live bullet and ran the compiler out of HBM
    at batch 4096."""
    import math

    A = atlas_lib
    specs = []
    for k in A.LASER_COLORS:
        for t in range(ROT_BINS):
            specs.append(
                ("bolt_" + k, 0.3 * PPU, 0.3 * PPU, t * 2 * math.pi / ROT_BINS)
            )
    for i in range(5):
        specs.append((f"explosion{i}", 0.38 * PPU, 0.38 * PPU))
    bb_bank = A.build_pixel_bank(tuple(specs), patch=8)

    ab_specs = tuple(
        [("bolt_" + k, 0.15 * PPU, 0.15 * PPU) for k in A.LASER_COLORS]
        + [(f"explosion{i}", 0.19 * PPU, 0.19 * PPU) for i in range(5)]
    )
    # patch=8 (content is ~3 px): lets the player-bullet pool share one
    # stamp group with the P=8 ship bank (z-adjacent: the reference's
    # agent render draws bullets then the ship, common_systems.cpp:699)
    ab_bank = A.build_pixel_bank(ab_specs, patch=8)

    bar_bank = A.build_pixel_bank(
        tuple((f"barrier{i}", 0.3 * PPU, 0.3 * PPU) for i in range(3)), patch=8
    )
    boss_bank = A.build_pixel_bank(
        tuple(
            (f"boss_ship_{k}", 1.66 * PPU, 1.25 * PPU)
            for k in A.BOSS_SHIP_COLORS
        ),
        patch=28,
    )
    shield_bank = A.build_pixel_bank(
        (("shield", 2.234 * PPU, 1.86 * PPU),), patch=40
    )
    # Shield-over-boss pre-composition: the shield is always drawn
    # centered on the boss at alpha 0.7 right after the ship
    # (bossfight render order), so the two stamps collapse to ONE
    # P=40 variant per ship color — alpha compositing is associative,
    # so (shield over boss) over frame == shield over (boss over
    # frame) exactly (up to the bank's u8 rounding). Halves the
    # largest per-env stamp work and drops one stamp group.
    boss40 = A.build_pixel_bank(
        tuple(
            (f"boss_ship_{k}", 1.66 * PPU, 1.25 * PPU)
            for k in A.BOSS_SHIP_COLORS
        ),
        patch=40,
    ).astype(np.float32)
    sh = shield_bank[0].astype(np.float32)  # [4, 40, 40]
    a_s = sh[3:4] / 255.0 * 0.7
    a_b = boss40[:, 3:4] / 255.0
    out_a = a_s + a_b * (1.0 - a_s)
    out_rgb = np.where(
        out_a > 0,
        (sh[None, :3] * a_s + boss40[:, :3] * a_b * (1.0 - a_s))
        / np.maximum(out_a, 1e-6),
        0.0,
    )
    shielded40 = np.concatenate([out_rgb, out_a * 255.0], axis=1)
    bosshield_bank = np.clip(
        np.round(np.concatenate([boss40, shielded40], axis=0)), 0, 255
    ).astype(np.uint8)  # [8, 4, 40, 40]: 4 plain + 4 shielded
    dmg_bank = A.build_pixel_bank(
        tuple((f"explosion{i}", 1.125 * PPU, 1.125 * PPU) for i in range(5)),
        patch=20,
    )
    ship_bank = A.build_pixel_bank(
        tuple(
            (f"pship_{k}", 0.31 * PPU, 0.234 * PPU)
            for k in A.PLAYER_SHIP_COLORS
        ),
        patch=8,
    )
    # barriers + boss bullets composite as one z-adjacent P=8 group;
    # player bullets + ship likewise
    barbb_bank = np.concatenate([bar_bank, bb_bank], axis=0)
    abship_bank = np.concatenate([ab_bank, ship_bank], axis=0)
    return dict(bb=bb_bank, ab=ab_bank, bar=bar_bank, barbb=barbb_bank,
                boss=boss_bank, shield=shield_bank,
                bosshield=bosshield_bank, dmg=dmg_bank,
                ship=ship_bank, abship=abship_bank)


@functools.lru_cache(maxsize=None)
def _bg_bank():
    """Background bank pre-sampled at obs resolution (fixed camera);
    host-side numpy so the cached array is a constant, not a tracer."""
    A = _assets()
    bgs_p = np.asarray(A["bgs_p"])  # [3, B, H, W]
    _, B, H, W = bgs_p.shape
    c = np.arange(C.OBS) + 0.5 - C.OBS / 2
    w = c / PPU  # world coords of pixel centers
    u = (w + HALF) / (2 * HALF)
    ui = np.clip((u * W).astype(np.int32), 0, W - 1)
    vi = np.clip((u * H).astype(np.int32), 0, H - 1)
    return bgs_p[:, :, vi[:, None], ui[None, :]].transpose(1, 0, 2, 3).copy()


def _r0c0(cx, cy, P):
    """Top-left obs pixel of a P-patch centered at world (cx, cy)."""
    c0 = jnp.round((cx + HALF) * PPU - P / 2).astype(jnp.int32)
    r0 = jnp.round((cy + HALF) * PPU - P / 2).astype(jnp.int32)
    return r0, c0


def _cull_alive(k, alive, var, x, y):
    """Compact a mostly-dead slot pool to k slots that hold every alive
    one while at most k are alive (stamp cost scales with the slot
    count: bossfight's 64-slot bullet ring and 32-slot player ring
    carry ~15 live bullets). top_k on the alive mask keeps the
    lowest-index alive slots, in slot (painter) order; an overflow
    drops the highest-index ones. The slots are selected by index, so
    the f32 positions pass through exactly."""
    _, ids = jax.lax.top_k(alive.astype(jnp.float32), k)
    pick = functools.partial(jnp.take_along_axis, indices=ids, axis=1)
    return pick(alive), pick(var).astype(jnp.int32), pick(x), pick(y)


def observe_batch(cfg: Config, states: State):
    banks = _stamp_banks()
    level = states.level
    N = states.pos.shape[0]

    img = jnp.asarray(_bg_bank())[
        level.bg_index.astype(jnp.int32)
    ].astype(jnp.bfloat16)

    def blend(img, group, var, cx, cy, alives=None, alpha=None):
        P = banks[group].shape[-1]
        r0, c0 = _r0c0(cx, cy, P)
        return C.composite_stamps(
            img, banks[group], var, r0, c0, alives=alives, alpha=alpha
        )

    # barriers (bossfight.cpp:480: sprite offset -0.15, scale 0.3) and
    # boss bullets / their explosions (rotation-quantized variants):
    # adjacent in z-order and both P=8, so they share ONE stamp group
    # (each composite call costs a frame round trip, so merging
    # adjacent same-P groups is a direct save)
    blank = jnp.broadcast_to(level.barrier_tex.astype(jnp.int32), (N, 4)) \
        if level.barrier_tex.ndim == 1 else level.barrier_tex.astype(jnp.int32)
    bwin = jax.vmap(_window, in_axes=(0, 0, None))(
        states.bb_next, states.bb_num, NUM_B_BULLETS
    )
    frame = states.bb_frame
    is_live = bwin & (frame == 0.0)
    is_expl = bwin & (frame >= 1.0)
    rot = states.bb_rot + jnp.pi * 0.5
    rbin = jnp.mod(
        jnp.round(rot / (2 * jnp.pi / ROT_BINS)).astype(jnp.int32), ROT_BINS
    )
    eidx = jnp.clip(frame.astype(jnp.int32) - 1, 0, 4)
    var = jnp.where(
        is_live,
        level.bullet_tex[:, None].astype(jnp.int32) * ROT_BINS + rbin,
        3 * ROT_BINS + eidx,
    )
    n_bar = banks["bar"].shape[0]
    bb_alive, bb_var, bb_x, bb_y = _cull_alive(
        BB_CULL, is_live | is_expl, n_bar + var,
        states.bb_pos[..., 0], states.bb_pos[..., 1])
    img = blend(
        img, "barbb",
        jnp.concatenate([blank, bb_var], axis=1),
        jnp.concatenate([level.barrier_pos[..., 0], bb_x], axis=1),
        jnp.concatenate([level.barrier_pos[..., 1], bb_y], axis=1),
        alives=jnp.concatenate([level.barrier_exists, bb_alive], axis=1),
    )

    # boss ship (+ pre-composed shield variant during shielded phases:
    # one stamp + one stamp group instead of two, exact — see
    # _stamp_banks)
    bvar = (level.boss_tex.astype(jnp.int32)
            + jnp.where(states.phase_index % 2 == 0, 4, 0))[:, None]
    img = blend(img, "bosshield", bvar,
                states.boss_pos[:, None, 0], states.boss_pos[:, None, 1])

    # boss damage explosions (draw offset -0.56 vs 1.125/2: ~0.002u)
    ewin = jax.vmap(_window, in_axes=(0, 0, None))(
        states.ex_next, states.ex_num, NUM_EXPLOSIONS
    )
    img = blend(img, "dmg",
                jnp.clip(states.ex_frame.astype(jnp.int32), 0, 4),
                states.ex_pos[..., 0] - 0.0025, states.ex_pos[..., 1] - 0.0025,
                alives=ewin & (states.ex_frame >= 0.0))

    # player bullets / explosions + agent ship: one culled P=8 pass
    # (z-adjacent — the reference agent render draws bullets then the
    # ship, common_systems.cpp:695-720)
    awin = jax.vmap(_window, in_axes=(0, 0, None))(
        states.ab_next, states.ab_num, NUM_A_BULLETS
    )
    aframe = states.ab_frame
    a_live = awin & (aframe == 0.0)
    a_expl = awin & (aframe >= 1.0)
    avar = jnp.where(
        a_live,
        level.bullet_tex[:, None].astype(jnp.int32),
        3 + jnp.clip(aframe.astype(jnp.int32) - 1, 0, 4),
    )
    ab_alive, ab_var, ab_x, ab_y = _cull_alive(
        AB_CULL, a_live | a_expl, avar,
        states.ab_pos[..., 0], states.ab_pos[..., 1])
    n_ab = banks["ab"].shape[0]
    img = blend(
        img, "abship",
        jnp.concatenate(
            [ab_var, n_ab + level.ship_tex.astype(jnp.int32)[:, None]], 1),
        jnp.concatenate([ab_x, states.pos[:, None, 0]], axis=1),
        jnp.concatenate([ab_y, states.pos[:, None, 1]], axis=1),
        alives=jnp.concatenate([ab_alive, jnp.ones((N, 1), bool)], axis=1),
    )

    obs = jnp.clip(jnp.round(img), 0, 255).astype(jnp.uint8)
    return obs  # planar u8 [N, 3, OBS, OBS]; layout applied by the Environment
