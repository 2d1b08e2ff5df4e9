"""Caveflyer: Asteroids-style ship in a cave — fly to the green UFO.

JAX re-implementation of the reference's `games/caveflyer/`:
  * level generation — pure cellular-automata cave (uniform 50% seed, 2 CA
    passes, largest connected room), random distinct goal/agent cells, BFS
    path, non-memory prune to the path Moore-dilated 4x, then 3 object
    classes at |free|/80 each on distinct non-path cells: static meteor
    obstacles, destroyable red-UFO targets, moving enemy ships whose axis
    velocity avoids a head-on agent spawn collision (tilemap.cpp:118-278,
    check_neighbors tilemap.cpp:104-115). The reference's 4 extra CA
    iterations (tilemap.cpp:217-222) update only the room-generator grid,
    never the tile map — a no-op on gameplay that we (faithfully) omit.
  * ship physics — rotation via left/right (spin 0.05), thrust along the
    heading (reverse at 0.5x), velocity decay drag 0.1, tile collision
    zeroing velocity components (common_systems.cpp:90-180);
  * bullets — fire action (9) spawns from a 32-slot ring when the shared
    bullet_timer is 0; the timer only *decrements while fire is held and
    a spawn is blocked* (common_systems.cpp:131-147 — quirk kept). Live
    bullets collide with walls and hazards via a 0.02-unit probe rect;
    destroyable targets die for +3; impact plays a 5-frame explosion
    (frame += 0.5 per sub-step) then frees the slot
    (common_systems.cpp:216-280). Only the `num_bullets` most recent ring
    slots are iterated, exactly as the reference window does;
  * enemy ships — move with constant velocity, reversing (both components)
    on wall contact without position correction (common_systems.cpp:50-75);
  * thrust particles — 10-slot pool, spawn behind the ship while
    thrusting forward, drift backwards and fade
    (common_systems.cpp:329-396, offset (0, 0.3) tilemap.cpp:198);
  * rewards — +10 goal, +3 per destroyed target, recomputed per sub-step
    last-write-wins; terminate on hazard contact or goal
    (caveflyer.cpp:317-337); camera follows the ship, zoom 0.5
    (caveflyer.cpp:32).

Modes (tilemap.cpp:121-126): easy 20, hard 40, memory 45 (no prune).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from ..core import spaces
from ..gen.kruskal import masked_uniform_cell
from ..gen import rooms
from ..physics.tiles import probe_any_solid, resolve_tile_collisions, NONE, FULL
from ..physics.aabb import check_collision
from ..render import atlas as atlas_lib
from ..render import compositor as C
from ..render import phases as phases_lib
from ..render import scene as scene_lib

NAME = "caveflyer"
NUM_ACTIONS = 15
SUB_STEPS = 4  # caveflyer.cpp:44
DT = 1.0 / SUB_STEPS
ZOOM = 0.5  # caveflyer.cpp:32
PPU = 16.0 * ZOOM

# Ship physics (common_systems.cpp:95-101)
ACCEL = 0.05
SPIN_RATE = 0.05
VEL_DECAY = 0.1
REVERSE_MUL = 0.5
BULLET_TIME = 0.5
BULLET_SPEED = 1.0
EXPLOSION_RATE = 0.5

NUM_BULLETS = 32  # common_systems.cpp:87
NUM_PARTICLES = 10  # tilemap.cpp:198
PART_LIFESPAN = 5.0
PART_SPAWN_TIME = 0.5

_MODES = {"easy": 20, "hard": 40, "memory": 45}
NUM_BGS = 13  # caveflyer.cpp:59-73 (13 space backgrounds)

_LUT_WALL = np.array([NONE, FULL], np.int32)  # wall -> full


@dataclasses.dataclass(frozen=True)
class Config:
    mode: str = "easy"
    # Render-only camera phase quantization for the scene compositor
    # (render/phases.py); 0 = exact continuous camera (slow path).
    scene_phases: int = 4

    @property
    def world_dim(self):
        return _MODES[self.mode]

    @property
    def prune(self):
        return self.mode != "memory"  # tilemap.cpp:203

    @property
    def max_obj(self):
        # chunk_size = |free|/80 per class (tilemap.cpp:234-235)
        return self.world_dim * self.world_dim // 80 + 1


@struct.dataclass
class Level:
    wall: jnp.ndarray  # bool [D, D] render coords
    goal_pos: jnp.ndarray  # f32 [2]
    agent_pos: jnp.ndarray  # f32 [2]
    obst_pos: jnp.ndarray  # f32 [M, 2] meteor obstacles
    obst_exists: jnp.ndarray  # bool [M]
    target_pos: jnp.ndarray  # f32 [M, 2] destroyable red UFOs
    target_exists: jnp.ndarray  # bool [M]
    enemy_pos0: jnp.ndarray  # f32 [M, 2]
    enemy_vel0: jnp.ndarray  # f32 [M, 2]
    enemy_exists: jnp.ndarray  # bool [M]
    bg_index: jnp.ndarray  # i32
    bg_offset: jnp.ndarray  # f32


@struct.dataclass
class State:
    level: Level
    pos: jnp.ndarray  # f32 [2]
    vel: jnp.ndarray  # f32 [2]
    rot: jnp.ndarray  # f32 heading (0 = +x, screen-clockwise)
    bullet_timer: jnp.ndarray  # f32 (system-level, common_systems.h)
    b_pos: jnp.ndarray  # f32 [32, 2]
    b_vel: jnp.ndarray  # f32 [32, 2]
    b_rot: jnp.ndarray  # f32 [32]
    b_frame: jnp.ndarray  # f32 [32]: -1 dead, 0 live, [1,5) explosion
    num_bullets: jnp.ndarray  # i32
    next_bullet: jnp.ndarray  # i32
    target_alive: jnp.ndarray  # bool [M]
    enemy_pos: jnp.ndarray  # f32 [M, 2]
    enemy_vel: jnp.ndarray  # f32 [M, 2]
    part_pos: jnp.ndarray  # f32 [10, 2]
    part_life: jnp.ndarray  # f32 [10]
    part_dir: jnp.ndarray  # f32 [10, 2]
    part_rot: jnp.ndarray  # f32 [10]
    part_spawn_timer: jnp.ndarray  # f32
    t: jnp.ndarray  # i32
    rng: jax.Array


# ---------------------------------------------------------------------------
# Assets
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _assets():
    names = ["cave_wall", "ufo_green", "ufo_red", "meteor", "enemy_ship",
             "laser", "ship_red", "smoke"]
    names += [f"explosion{i}" for i in range(5)]
    atlas, idx = atlas_lib.build_atlas(tuple(names))
    bgs = atlas_lib.build_backgrounds("space", NUM_BGS)
    expl = np.array([idx[f"explosion{i}"] for i in range(5)], np.int32)
    return dict(
        atlas_p=atlas.transpose(3, 0, 1, 2),
        idx=idx,
        bgs_p=bgs.transpose(3, 0, 1, 2),
        lut=[-1, idx["cave_wall"]],
        expl=expl,
    )


# ---------------------------------------------------------------------------
# Generation (tilemap.cpp:118-278)
# ---------------------------------------------------------------------------

def generate(cfg: Config, key) -> Level:
    D = cfg.world_dim
    M = cfg.max_obj
    k_seed, k_goal, k_agent, k_obj, k_vel, k_bg, k_bgoff = jax.random.split(key, 7)

    # CA cave from a uniform 50% seed (tilemap.cpp:142-146); (x, y_up)
    wall = jax.random.uniform(k_seed, (D, D)) < 0.5
    for _ in range(2):
        wall = rooms.ca_smooth(wall)

    room = rooms.largest_room(~wall, iters=D * D // 2)

    # Goal + agent: two uniform draws over the free list; equal indices
    # resolve by advancing the agent to the next free cell in flat order
    # (tilemap.cpp:163-172)
    gx, gy = masked_uniform_cell(k_goal, room)
    ax0, ay0 = masked_uniform_cell(k_agent, room)
    same = (ax0 == gx) & (ay0 == gy)
    # next free cell after (ax0, ay0) in x-major flat order, cyclic
    flat = jnp.arange(D * D).reshape(D, D)
    aflat = ax0 * D + ay0
    open_flat = room.reshape(-1)
    after = open_flat & (jnp.arange(D * D) > aflat)
    nxt = jnp.where(
        after.any(),
        jnp.argmax(after),  # first True
        jnp.argmax(open_flat),
    )
    ax = jnp.where(same, nxt // D, ax0)
    ay = jnp.where(same, nxt % D, ay0)

    goal_pos = jnp.stack([gx + 0.5, D - 1.0 - gy + 0.5]).astype(jnp.float32)
    # Agent spawn y lacks the +0.5 (tilemap.cpp:189), like jumper's
    agent_pos = jnp.stack([ax + 0.5, (D - 1.0 - ay)]).astype(jnp.float32)

    # BFS path + prune (tilemap.cpp:200-215)
    dist = rooms.bfs_dist(room, ax, ay, iters=D * D // 2)
    path = rooms.shortest_path_mask(dist, gx, gy)
    if cfg.prune:
        open_f = rooms.dilate_in(path, room, 4)
    else:
        open_f = room
    # (The 4 extra CA iterations, tilemap.cpp:217-222, never touch the
    # tile map — no-op, omitted.)

    # Objects on distinct free non-path cells (tilemap.cpp:224-272)
    free_obj = open_f & ~path
    n_free = free_obj.sum()
    chunk = n_free // 80

    okeys = jax.random.split(k_obj, 3 * M)
    vkeys = jax.random.split(k_vel, 2 * M)
    avail = free_obj
    positions = []
    exists = []
    for i in range(3 * M):
        cls = i // M
        j = i % M
        have = j < chunk
        ox, oy = masked_uniform_cell(okeys[i], avail)
        avail = avail.at[ox, oy].set(avail[ox, oy] & ~have)
        positions.append(jnp.stack([ox + 0.5, D - 1.0 - oy + 0.5]))
        exists.append(have)
    positions = jnp.stack(positions).astype(jnp.float32)  # [3M, 2]
    exists = jnp.stack(exists)

    obst_pos, target_pos, enemy_pos = (
        positions[:M], positions[M:2 * M], positions[2 * M:]
    )
    obst_ex, target_ex, enemy_ex = exists[:M], exists[M:2 * M], exists[2 * M:]

    # Enemy velocities (tilemap.cpp:68-101): axis chosen to avoid head-on
    # collision with the agent spawn (check_neighbors, tilemap.cpp:104-115)
    def enemy_vel(i):
        kv, ks, ka = jax.random.split(vkeys[i], 3)
        comp = (0.1 * jax.random.uniform(kv) + 0.1) * jnp.where(
            jax.random.uniform(ks) < 0.5, 1.0, -1.0
        )
        p = enemy_pos[i]
        dx = jnp.abs(p[0] - agent_pos[0])
        dy = jnp.abs(p[1] - agent_pos[1])
        col = jnp.where(
            (dx <= 1e-3) & (dy <= 2.0), 1,
            jnp.where((dx <= 2.0) & (dy <= 1e-3), 2, 0),
        )
        axis_x = jnp.where(
            col == 1, True,
            jnp.where(col == 2, False, jax.random.uniform(ka) < 0.5),
        )
        return jnp.where(
            axis_x,
            jnp.stack([comp, 0.0]),
            jnp.stack([0.0, comp]),
        )

    enemy_v = jnp.stack([enemy_vel(i) for i in range(M)]).astype(jnp.float32)

    wall_f = ~open_f
    return Level(
        wall=jnp.flip(wall_f.T, axis=0),
        goal_pos=goal_pos,
        agent_pos=agent_pos,
        obst_pos=obst_pos,
        obst_exists=obst_ex,
        target_pos=target_pos,
        target_exists=target_ex,
        enemy_pos0=enemy_pos,
        enemy_vel0=enemy_v,
        enemy_exists=enemy_ex,
        bg_index=jax.random.randint(k_bg, (), 0, NUM_BGS),
        bg_offset=jax.random.uniform(k_bgoff),
    )


def reset(cfg: Config, level: Level, key) -> State:
    M = cfg.max_obj
    return State(
        level=level,
        pos=level.agent_pos,
        vel=jnp.zeros(2, jnp.float32),
        rot=jnp.float32(0.0),
        bullet_timer=jnp.float32(0.0),
        b_pos=jnp.zeros((NUM_BULLETS, 2), jnp.float32),
        b_vel=jnp.zeros((NUM_BULLETS, 2), jnp.float32),
        b_rot=jnp.zeros(NUM_BULLETS, jnp.float32),
        b_frame=jnp.full(NUM_BULLETS, -1.0, jnp.float32),
        num_bullets=jnp.int32(0),
        next_bullet=jnp.int32(0),
        target_alive=level.target_exists,
        enemy_pos=level.enemy_pos0,
        enemy_vel=level.enemy_vel0,
        part_pos=jnp.zeros((NUM_PARTICLES, 2), jnp.float32),
        part_life=jnp.zeros(NUM_PARTICLES, jnp.float32),
        part_dir=jnp.zeros((NUM_PARTICLES, 2), jnp.float32),
        part_rot=jnp.zeros(NUM_PARTICLES, jnp.float32),
        part_spawn_timer=jnp.float32(0.0),
        t=jnp.int32(0),
        rng=key,
    )


# ---------------------------------------------------------------------------
# Step (caveflyer.cpp:302-341)
# ---------------------------------------------------------------------------

def _ring_window(next_bullet, num_bullets):
    """Mask of the `num_bullets` ring slots preceding next_bullet
    (common_systems.cpp:217-218)."""
    j = jnp.arange(NUM_BULLETS)
    back = jnp.mod(next_bullet - 1 - j, NUM_BULLETS)
    return back < num_bullets


def _hazard_hit(level, target_alive, enemy_pos, rx, ry, rw, rh):
    """Agent rect vs all hazard rects (common_systems.cpp:182-195)."""
    obst = level.obst_exists & check_collision(
        rx, ry, rw, rh,
        level.obst_pos[:, 0] - 0.25, level.obst_pos[:, 1] - 0.25, 0.5, 0.5,
    )
    targ = target_alive & check_collision(
        rx, ry, rw, rh,
        level.target_pos[:, 0] - 0.25, level.target_pos[:, 1] - 0.25, 0.5, 0.5,
    )
    enem = level.enemy_exists & check_collision(
        rx, ry, rw, rh,
        enemy_pos[:, 0] - 0.4, enemy_pos[:, 1] - 0.4, 0.8, 0.8,
    )
    return obst.any() | targ.any() | enem.any()


def step(cfg: Config, state: State, action):
    level = state.level
    a = action.astype(jnp.int32)

    pos, vel, rot = state.pos, state.vel, state.rot
    bullet_timer = state.bullet_timer
    b_pos, b_vel = state.b_pos, state.b_vel
    b_rot, b_frame = state.b_rot, state.b_frame
    num_b, next_b = state.num_bullets, state.next_bullet
    target_alive = state.target_alive
    enemy_pos, enemy_vel = state.enemy_pos, state.enemy_vel
    part_pos, part_life = state.part_pos, state.part_life
    part_dir, part_rot = state.part_dir, state.part_rot
    spawn_timer = state.part_spawn_timer
    done = jnp.bool_(False)
    reward = jnp.float32(0.0)

    movement_x = (
        ((a == 6) | (a == 7) | (a == 8)).astype(jnp.float32)
        - ((a == 0) | (a == 1) | (a == 2)).astype(jnp.float32)
    )
    movement_y = (
        ((a == 2) | (a == 5) | (a == 8)).astype(jnp.float32)
        - ((a == 0) | (a == 3) | (a == 6)).astype(jnp.float32)
    )
    movement_y = jnp.where(movement_y < 0, movement_y * REVERSE_MUL, movement_y)
    fire = a == 9

    for _ in range(SUB_STEPS):
        active = ~done

        # ---- ship steering + thrust (common_systems.cpp:119-156) ----
        n_rot = rot + movement_x * SPIN_RATE * DT
        dirx, diry = jnp.cos(n_rot), jnp.sin(n_rot)

        # fire / spawn bullet (common_systems.cpp:131-147); slot update is
        # a one-hot mask, not a scatter
        can_spawn = fire & (bullet_timer == 0.0) & (num_b < NUM_BULLETS)
        upd = can_spawn & (jnp.arange(NUM_BULLETS) == next_b)
        b_rot_n = jnp.where(upd, n_rot, b_rot)
        b_vel_n = jnp.where(
            upd[:, None],
            jnp.stack([dirx * BULLET_SPEED, diry * BULLET_SPEED])[None, :],
            b_vel,
        )
        b_pos_n = jnp.where(upd[:, None], pos[None, :], b_pos)
        b_frame_n = jnp.where(upd, 0.0, b_frame)
        n_next_b = jnp.where(can_spawn, (next_b + 1) % NUM_BULLETS, next_b)
        n_num_b = num_b + can_spawn.astype(jnp.int32)
        # timer only decays when fire is held but spawn is blocked
        n_btimer = jnp.where(
            can_spawn, BULLET_TIME,
            jnp.where(fire, jnp.maximum(0.0, bullet_timer - DT), bullet_timer),
        )

        acc = jnp.stack([dirx, diry]) * movement_y * ACCEL
        n_vel = vel + (acc - vel * VEL_DECAY) * DT
        x = pos[0] + n_vel[0] * DT
        y = pos[1] + n_vel[1] * DT

        # tile collision, bounds (-0.4,-0.4,0.8,0.8) (tilemap.cpp:195)
        rx, ry, col = resolve_tile_collisions(
            level.wall.astype(jnp.int8), _LUT_WALL, x - 0.4, y - 0.4, 0.8, 0.8, 1
        )
        dx_moved = rx - (x - 0.4)
        dy_moved = ry - (y - 0.4)
        x = rx + 0.4
        y = ry + 0.4
        n_vel = jnp.stack([
            jnp.where(dx_moved != 0.0, 0.0, n_vel[0]),
            jnp.where(dy_moved != 0.0, 0.0, n_vel[1]),
        ])
        n_pos = jnp.stack([x, y])

        # hazards + goal (uses pre-move enemy positions: agent updates
        # before mob_ai, caveflyer.cpp:323-325)
        dead = _hazard_hit(level, target_alive, enemy_pos,
                           x - 0.4, y - 0.4, 0.8, 0.8)
        achieved = check_collision(
            x - 0.4, y - 0.4, 0.8, 0.8,
            level.goal_pos[0] - 0.4, level.goal_pos[1] - 0.4, 0.8, 0.8,
        )

        # ---- bullets (common_systems.cpp:216-280) ----
        window = _ring_window(n_next_b, n_num_b)
        live = window & (b_frame_n == 0.0)
        bx, by = b_pos_n[:, 0], b_pos_n[:, 1]
        # wall probe (0.02^2 rect): batched 4-corner solid test — the
        # full resolver's `collided` for small rects (probe_any_solid)
        wall_hit = probe_any_solid(
            level.wall, bx - 0.01, by - 0.01,
            jnp.full(NUM_BULLETS, 0.02), jnp.full(NUM_BULLETS, 0.02),
        ) & live

        obst_hit = live & (
            level.obst_exists[None, :] & jax.vmap(
                lambda px, py: check_collision(
                    px - 0.01, py - 0.01, 0.02, 0.02,
                    level.obst_pos[:, 0] - 0.25, level.obst_pos[:, 1] - 0.25,
                    0.5, 0.5,
                )
            )(bx, by)
        ).any(axis=1)
        targ_overlap = (
            target_alive[None, :] & jax.vmap(
                lambda px, py: check_collision(
                    px - 0.01, py - 0.01, 0.02, 0.02,
                    level.target_pos[:, 0] - 0.25, level.target_pos[:, 1] - 0.25,
                    0.5, 0.5,
                )
            )(bx, by)
        ) & live[:, None] & ~obst_hit[:, None]  # obstacles precede targets
        targ_hit = targ_overlap.any(axis=1)
        # first overlapping target per bullet (entity order = slot order);
        # one-hot reduction instead of a vmapped scatter-max
        first_targ = jnp.argmax(targ_overlap, axis=1)
        M_t = target_alive.shape[0]
        destroyed = (
            (first_targ[:, None] == jnp.arange(M_t)) & targ_hit[:, None]
        ).any(axis=0)
        n_targets_destroyed = (destroyed & target_alive).sum()
        n_target_alive = target_alive & ~destroyed

        enem_hit = live & ~obst_hit & ~targ_hit & (
            level.enemy_exists[None, :] & jax.vmap(
                lambda px, py: check_collision(
                    px - 0.01, py - 0.01, 0.02, 0.02,
                    enemy_pos[:, 0] - 0.4, enemy_pos[:, 1] - 0.4, 0.8, 0.8,
                )
            )(bx, by)
        ).any(axis=1)

        impact = wall_hit | obst_hit | targ_hit | enem_hit
        b_vel_n = jnp.where(impact[:, None], 0.0, b_vel_n)
        b_frame_n = jnp.where(impact, 1.0, b_frame_n)
        # move + animate (window slots only)
        b_pos_n = jnp.where(window[:, None], b_pos_n + b_vel_n * DT, b_pos_n)
        exploding = window & (b_frame_n >= 1.0)
        expired = window & (b_frame_n >= 5.0)
        b_frame_n = jnp.where(
            expired, -1.0,
            jnp.where(exploding, b_frame_n + EXPLOSION_RATE * DT, b_frame_n),
        )
        n_num_b = n_num_b - expired.sum()

        # ---- enemy ships (common_systems.cpp:50-75) ----
        m_np = enemy_pos + enemy_vel * DT
        m_col = probe_any_solid(
            level.wall, m_np[:, 0] - 0.4, m_np[:, 1] - 0.4,
            jnp.full(m_np.shape[0], 0.8), jnp.full(m_np.shape[0], 0.8),
        )
        m_pos = m_np
        m_vel = jnp.where(m_col[:, None], -enemy_vel, enemy_vel)
        m_pos = jnp.where(level.enemy_exists[:, None], m_pos, enemy_pos)
        m_vel = jnp.where(level.enemy_exists[:, None], m_vel, enemy_vel)

        # ---- thrust particles (common_systems.cpp:329-371) ----
        plife = part_life - DT
        dead_idx = jnp.max(jnp.where(plife <= 0.0, jnp.arange(NUM_PARTICLES), -1))
        n_ptimer = spawn_timer + DT
        enabled = movement_y > 0.0
        do = (dead_idx >= 0) & (n_ptimer >= PART_SPAWN_TIME) & enabled
        n_ptimer = jnp.where(do, jnp.mod(n_ptimer, PART_SPAWN_TIME), n_ptimer)
        pslot = jnp.clip(dead_idx, 0, NUM_PARTICLES - 1)
        prot = n_rot + jnp.pi * 0.5
        pc, ps = jnp.cos(prot), jnp.sin(prot)
        # offset (0, 0.3) rotated by prot (tilemap.cpp:198); one-hot slot
        # update instead of scatter
        off = jnp.stack([pc * 0.0 - ps * 0.3, ps * 0.0 + pc * 0.3])
        pupd = do & (jnp.arange(NUM_PARTICLES) == pslot)
        plife = jnp.where(pupd, PART_LIFESPAN, plife)
        n_ppos = jnp.where(pupd[:, None], (n_pos + off)[None, :], part_pos)
        n_pdir = jnp.where(
            pupd[:, None], jnp.stack([-dirx, -diry])[None, :], part_dir
        )
        n_prot = jnp.where(pupd, prot, part_rot)

        sub_reward = achieved * 10.0 + n_targets_destroyed.astype(jnp.float32) * 3.0

        # commit (masked by active)
        pos = jnp.where(active, n_pos, pos)
        vel = jnp.where(active, n_vel, vel)
        rot = jnp.where(active, n_rot, rot)
        bullet_timer = jnp.where(active, n_btimer, bullet_timer)
        b_pos = jnp.where(active, b_pos_n, b_pos)
        b_vel = jnp.where(active, b_vel_n, b_vel)
        b_rot = jnp.where(active, b_rot_n, b_rot)
        b_frame = jnp.where(active, b_frame_n, b_frame)
        num_b = jnp.where(active, n_num_b, num_b)
        next_b = jnp.where(active, n_next_b, next_b)
        target_alive = jnp.where(active, n_target_alive, target_alive)
        enemy_pos = jnp.where(active, m_pos, enemy_pos)
        enemy_vel = jnp.where(active, m_vel, enemy_vel)
        part_pos = jnp.where(active, n_ppos, part_pos)
        part_life = jnp.where(active, plife, part_life)
        part_dir = jnp.where(active, n_pdir, part_dir)
        part_rot = jnp.where(active, n_prot, part_rot)
        spawn_timer = jnp.where(active, n_ptimer, spawn_timer)
        reward = jnp.where(active, sub_reward, reward)
        done = done | (active & (dead | achieved))

    new_state = State(
        level=level, pos=pos, vel=vel, rot=rot, bullet_timer=bullet_timer,
        b_pos=b_pos, b_vel=b_vel, b_rot=b_rot, b_frame=b_frame,
        num_bullets=num_b, next_bullet=next_b, target_alive=target_alive,
        enemy_pos=enemy_pos, enemy_vel=enemy_vel,
        part_pos=part_pos, part_life=part_life, part_dir=part_dir,
        part_rot=part_rot, part_spawn_timer=spawn_timer,
        t=state.t + 1, rng=state.rng,
    )
    return new_state, reward, done, {}


# ---------------------------------------------------------------------------
# Rendering (caveflyer.cpp:413-441)
# ---------------------------------------------------------------------------

def observe(cfg: Config, state: State):
    A = _assets()
    level = state.level
    M = cfg.max_obj
    ppu = PPU * (C.OBS / 64.0)  # window renders scale, caveflyer.cpp render_game
    wx, wy = C.camera_coords(ppu, state.pos[0], state.pos[1])

    img = C.clear()
    img = C.draw_background(img, jnp.asarray(A["bgs_p"]), level.bg_index, wx, wy)
    img = C.draw_tiles(
        img, level.wall.astype(jnp.int8), jnp.asarray(A["lut"]),
        A["atlas_p"], wx, wy, oob_tile=0,
    )

    # thrust particles (caveflyer.cpp:437: after tiles, before sprites)
    ratio = jnp.clip((PART_LIFESPAN - state.part_life) / PART_LIFESPAN, 0.0, 1.0)
    for i in range(NUM_PARTICLES):
        sc = 1.0 * (0.4 * ratio[i] + 0.6)
        shift = ratio[i] * 2.0
        cx = state.part_pos[i, 0] + state.part_dir[i, 0] * shift
        cy = state.part_pos[i, 1] + state.part_dir[i, 1] * shift
        img = C.draw_sprite(
            img, A["atlas_p"], A["idx"]["smoke"],
            cx - 0.5 * sc, cy - 0.5 * sc, sc, sc, wx, wy,
            rotation=state.part_rot[i],
            alive=state.part_life[i] > 0.0,
            alpha=0.5 * (1.0 - ratio[i]),
        )

    # hazards + goal (0.8-unit sprites at offset -0.4)
    img = C.draw_sprites(
        img, A["atlas_p"], jnp.full(M, A["idx"]["meteor"]),
        level.obst_pos[:, 0] - 0.4, level.obst_pos[:, 1] - 0.4,
        jnp.full(M, 0.8), jnp.full(M, 0.8 * 84 / 101), wx, wy,
        alives=level.obst_exists,
    )
    img = C.draw_sprites(
        img, A["atlas_p"], jnp.full(M, A["idx"]["ufo_red"]),
        level.target_pos[:, 0] - 0.4, level.target_pos[:, 1] - 0.4,
        jnp.full(M, 0.8), jnp.full(M, 0.8), wx, wy,
        alives=state.target_alive,
    )
    img = C.draw_sprites(
        img, A["atlas_p"], jnp.full(M, A["idx"]["enemy_ship"]),
        state.enemy_pos[:, 0] - 0.4, state.enemy_pos[:, 1] - 0.4,
        jnp.full(M, 0.8), jnp.full(M, 0.8 * 84 / 82), wx, wy,
        alives=level.enemy_exists,
    )
    img = C.draw_sprite(
        img, A["atlas_p"], A["idx"]["ufo_green"],
        level.goal_pos[0] - 0.4, level.goal_pos[1] - 0.4, 0.8, 0.8, wx, wy,
    )

    # bullets + explosions (common_systems.cpp:298-317); laser 13x37 px at
    # size 0.1 -> 0.081 x 0.231 units, explosions ~0.1*60/16 = 0.375
    window = _ring_window(state.next_bullet, state.num_bullets)
    for i in range(NUM_BULLETS):
        frame = state.b_frame[i]
        is_live = window[i] & (frame == 0.0)
        is_expl = window[i] & (frame >= 1.0)
        eidx = jnp.clip(frame.astype(jnp.int32) - 1, 0, 4)
        sid = jnp.where(is_live, A["idx"]["laser"], jnp.asarray(A["expl"])[eidx])
        w = jnp.where(is_live, 0.081, 0.375)
        h = jnp.where(is_live, 0.231, 0.375)
        img = C.draw_sprite(
            img, A["atlas_p"], sid,
            state.b_pos[i, 0] - w * 0.5, state.b_pos[i, 1] - h * 0.5,
            w, h, wx, wy,
            rotation=state.b_rot[i] + jnp.pi * 0.5,
            alive=is_live | is_expl,
        )

    # ship: 99x75 px at size 0.15 -> 0.93 x 0.70 units, rotated +90deg
    img = C.draw_sprite(
        img, A["atlas_p"], A["idx"]["ship_red"],
        state.pos[0] - 0.464, state.pos[1] - 0.352, 0.928, 0.703, wx, wy,
        rotation=state.rot + jnp.pi * 0.5,
    )
    return C.finalize(img)


def obs_space(cfg: Config):
    return spaces.Box(0, 255, (C.OBS, C.OBS, 3))


def action_space(cfg: Config):
    return spaces.MultiDiscrete((NUM_ACTIONS,))


# ---------------------------------------------------------------------------
# Batched fast renderer: per-env camera + pixel-snapped stamp groups
# ---------------------------------------------------------------------------

SHIP_ROT_BINS = 32
BULLET_ROT_BINS = 16
PART_ROT_BINS = 8
PART_SCALE_BINS = 4


@functools.lru_cache(maxsize=None)
def _stamp_banks():
    """Pre-rasterized stamp banks; rotation (ship/bullets/particles)
    becomes a quantized variant index instead of the per-pixel rotated
    gather that made this game ~1000x slower than maze (see
    compositor.composite_stamps)."""
    import math

    A = atlas_lib
    # static objects: meteor, red UFO, enemy ship, green UFO goal (all
    # 0.8-unit sprites with the reference's aspect tweaks)
    obj_bank = A.build_pixel_bank(
        (
            ("meteor", 0.8 * PPU, 0.8 * 84 / 101 * PPU),
            ("ufo_red", 0.8 * PPU, 0.8 * PPU),
            ("enemy_ship", 0.8 * PPU, 0.8 * 84 / 82 * PPU),
            ("ufo_green", 0.8 * PPU, 0.8 * PPU),
        ),
        patch=8,
    )
    # bullets: rotated laser variants + explosion frames
    specs = [
        ("laser", 0.081 * PPU, 0.231 * PPU,
         t * 2 * math.pi / BULLET_ROT_BINS)
        for t in range(BULLET_ROT_BINS)
    ] + [(f"explosion{i}", 0.375 * PPU, 0.375 * PPU) for i in range(5)]
    bullet_bank = A.build_pixel_bank(tuple(specs), patch=4)
    # ship: 32 rotation bins (0.93 x 0.70 units, +90deg baked by caller)
    ship_bank = A.build_pixel_bank(
        tuple(
            ("ship_red", 0.928 * PPU, 0.703 * PPU,
             t * 2 * math.pi / SHIP_ROT_BINS)
            for t in range(SHIP_ROT_BINS)
        ),
        patch=12,
    )
    # thrust smoke: rotation x scale grid (scale 0.6..1.0)
    specs = []
    for s in range(PART_SCALE_BINS):
        sc = 0.6 + 0.4 * (s + 0.5) / PART_SCALE_BINS
        for t in range(PART_ROT_BINS):
            specs.append(
                ("smoke", sc * PPU, sc * PPU, t * 2 * math.pi / PART_ROT_BINS)
            )
    part_bank = A.build_pixel_bank(tuple(specs), patch=10)
    return dict(obj=obj_bank, bullet=bullet_bank, ship=ship_bank,
                part=part_bank)


@functools.lru_cache(maxsize=None)
def _scene_assets(qp, D):
    """Single-kind tile phase bank + padded content for the
    quantized-camera scene (render/scene.py; see coinrun._scene_assets)."""
    A = _assets()
    atlas_s = np.asarray(A["atlas_p"]).transpose(1, 0, 2, 3)
    tex = atlas_s[A["idx"]["cave_wall"]][None]
    bank = phases_lib.tile_phase_bank(tex, PPU, 64, qp)
    W = phases_lib.win(PPU, 64, qp)
    GP = D + 2 * W
    bgs = np.asarray(A["bgs_p"])  # [3, NB, 64, 64]
    bgpad = np.zeros((bgs.shape[1], 3, GP, GP), np.uint8)
    n = min(64, GP - W)
    bgpad[:, :, W:W + n, W:W + n] = bgs.transpose(1, 0, 2, 3)[:, :, :n, :n]
    return dict(bank=bank, kinds=(1,), themes=(-1,), bgpad=bgpad, win=W)


def observe_batch(cfg: Config, states: State):
    A = _assets()
    banks = _stamp_banks()
    level = states.level
    M = cfg.max_obj
    N = states.pos.shape[0]
    cam = states.pos  # camera follows the ship (caveflyer.cpp:452-453)

    use_scene = C.OBS == 64 and cfg.scene_phases > 0
    if use_scene:
        # quantized render camera (<= 0.6 px; see coinrun._observe_scene)
        qp = cfg.scene_phases
        mx = jnp.round(cam[:, 0] * qp).astype(jnp.int32)
        my = jnp.round(cam[:, 1] * qp).astype(jnp.int32)
        cam = jnp.stack([mx.astype(jnp.float32) / qp,
                         my.astype(jnp.float32) / qp], axis=-1)
        scene_groups = []

        def blend_or_queue(img, bank, var, centers, alives=None, alpha=None):
            P = bank.shape[-1]
            r0, c0 = pix(centers, P)
            K = var.shape[1]
            scale = jnp.ones((N, K), jnp.float32)
            if alives is not None:
                scale = scale * alives.astype(jnp.float32)
            if alpha is not None:
                scale = scale * jnp.asarray(alpha, jnp.float32)
            scene_groups.append(
                (C._premultiply_bank(bank), var, scale, r0, c0))
            return img
    else:
        c = jnp.arange(C.OBS, dtype=jnp.float32) + 0.5 - C.OBS / 2
        wx_b = cam[:, 0:1] + c[None, :] / PPU
        wy_b = cam[:, 1:2] + c[None, :] / PPU
        img = C.draw_background_batch(
            jnp.asarray(A["bgs_p"]), level.bg_index.astype(jnp.int32),
            wx_b, wy_b
        )
        img = C.draw_tiles_batch(
            img, level.wall.astype(jnp.int8), A["lut"], A["atlas_p"],
            wx_b, wy_b, oob_tile=0,
        )

    def pix(centers, P):
        """[N, K, 2] world centers -> (r0, c0) patch origins."""
        px = (centers[..., 0] - cam[:, None, 0]) * PPU + C.OBS / 2
        py = (centers[..., 1] - cam[:, None, 1]) * PPU + C.OBS / 2
        return (jnp.round(py - P / 2).astype(jnp.int32),
                jnp.round(px - P / 2).astype(jnp.int32))

    if use_scene:
        blend = blend_or_queue
        img = None
    else:
        def blend(img, bank, var, centers, alives=None, alpha=None):
            P = bank.shape[-1]
            r0, c0 = pix(centers, P)
            return C.composite_stamps(img, bank, var, r0, c0,
                                      alives=alives, alpha=alpha)

    # thrust particles (before sprites, caveflyer.cpp:437)
    ratio = jnp.clip(
        (PART_LIFESPAN - states.part_life) / PART_LIFESPAN, 0.0, 1.0
    )
    shift = ratio * 2.0
    pcent = states.part_pos + states.part_dir * shift[..., None]
    sc = 0.4 * ratio + 0.6
    sbin = jnp.clip(((sc - 0.6) / 0.4 * PART_SCALE_BINS).astype(jnp.int32),
                    0, PART_SCALE_BINS - 1)
    rbin = jnp.mod(
        jnp.round(states.part_rot / (2 * jnp.pi / PART_ROT_BINS))
        .astype(jnp.int32), PART_ROT_BINS,
    )
    img = blend(img, banks["part"], sbin * PART_ROT_BINS + rbin, pcent,
                alives=states.part_life > 0.0,
                alpha=0.5 * (1.0 - ratio))

    # static objects + goal in one stamp group (sprite centers are the
    # entity positions: draws at pos-0.4 with 0.8-unit rects)
    centers = jnp.concatenate(
        [level.obst_pos, level.target_pos, states.enemy_pos,
         level.goal_pos[:, None, :]], axis=1,
    )  # [N, 3M+1, 2]
    var = jnp.concatenate([
        jnp.full((N, M), 0, jnp.int32),
        jnp.full((N, M), 1, jnp.int32),
        jnp.full((N, M), 2, jnp.int32),
        jnp.full((N, 1), 3, jnp.int32),
    ], axis=1)
    alives = jnp.concatenate([
        level.obst_exists, states.target_alive, level.enemy_exists,
        jnp.ones((N, 1), bool),
    ], axis=1)
    img = blend(img, banks["obj"], var, centers, alives=alives)

    # bullets / explosions (rotation-quantized laser variants)
    window = jax.vmap(_ring_window)(states.next_bullet, states.num_bullets)
    frame = states.b_frame
    is_live = window & (frame == 0.0)
    is_expl = window & (frame >= 1.0)
    brot = states.b_rot + jnp.pi * 0.5
    bbin = jnp.mod(
        jnp.round(brot / (2 * jnp.pi / BULLET_ROT_BINS)).astype(jnp.int32),
        BULLET_ROT_BINS,
    )
    bvar = jnp.where(
        is_live, bbin,
        BULLET_ROT_BINS + jnp.clip(frame.astype(jnp.int32) - 1, 0, 4),
    )
    img = blend(img, banks["bullet"], bvar, states.b_pos,
                alives=is_live | is_expl)

    # ship (rotated +90deg like the reference draw)
    srot = states.rot + jnp.pi * 0.5
    sbin2 = jnp.mod(
        jnp.round(srot / (2 * jnp.pi / SHIP_ROT_BINS)).astype(jnp.int32),
        SHIP_ROT_BINS,
    )
    # draw offset (-0.464, -0.352) vs half-size (0.464, 0.3515): center=pos
    img = blend(img, banks["ship"], sbin2[:, None], states.pos[:, None, :])

    if use_scene:
        D = cfg.world_dim
        SA = _scene_assets(qp, D)
        W = SA["win"]
        jx = jnp.mod(mx, qp)
        jy = jnp.mod(my, qp)
        _, _, t0_off = phases_lib.phase_tables(PPU, 64, qp)
        tx0 = jnp.floor(cam[:, 0] + jnp.float32(t0_off)).astype(jnp.int32)
        ty0 = jnp.floor(cam[:, 1] + jnp.float32(t0_off)).astype(jnp.int32)
        gridp = jnp.pad(level.wall.astype(jnp.int8),
                        ((0, 0), (W, W), (W, W)), constant_values=0)
        img = scene_lib.render_scene(
            gridp, SA["bgpad"], ty0, tx0, jy, jx,
            level.bg_index.astype(jnp.int32), jnp.zeros((N,), jnp.int32),
            SA["bank"], SA["kinds"], SA["themes"], scene_groups, PPU, qp, W)

    obs = jnp.clip(jnp.round(img), 0, 255).astype(jnp.uint8)
    return obs  # planar u8 [N, 3, OBS, OBS]; layout applied by the Environment
