"""Jumper: open-world cave platformer — double-jump bunny seeks a carrot.

JAX re-implementation of the reference's `games/jumper/`:
  * level generation — no-dead-end maze upsampled x3 as a wall-probability
    prior (0.8 wall / 0.2 space), 2 cellular-automata passes, border
    walls, largest connected room, random goal cell + random ground agent
    cell, BFS path agent->goal, non-memory modes prune the world to the
    path Moore-dilated 4x, spikes on 3-wide ground runs (p=0.2), vertical
    wall breakup, wall tops (tilemap.cpp:79-253);
  * physics — platformer core with **double jump** + cooldown
    (common_systems.cpp:97-107: jumps_left=2 reset on ground, cooldown
    3.0 in dt units), full air control (air_control=1.0,
    common_systems.cpp:66), ceiling-hit vy zeroing
    (common_systems.cpp:143-144); max_jump 0.92, gravity 0.1;
  * jump dust particles — 10-slot pool, lifespan 5, spawn every 0.5,
    enabled while airborne or moving (common_systems.cpp:196-198,246-303);
  * **compass HUD** drawn in screen space over the observation: opaque
    grey circle, needle rotated toward the goal, distance bar
    (jumper.cpp:473-509). The HUD rects are sized in *pixels of the render
    target* (compass_size 200 x game_zoom 0.3 = 60 px): small on the 512px
    viewer window, but covering most of the 64px observation — and the
    bar's obs-space y lands at 69.6 px, off the frame entirely. Both
    quirks reproduced faithfully;
  * +10 carrot, terminate on spike contact or carrot
    (jumper.cpp:355-369); camera follows (x, y-0.5), zoom 0.3.

Modes (tilemap.cpp:80-87): easy 20, hard 40, memory 45 (no prune,
no spikes).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from ..core import spaces
from ..gen.kruskal import kruskal_maze, open_dead_ends, masked_uniform_cell
from ..gen import rooms
from ..physics.tiles import resolve_tile_collisions, NONE, FULL
from ..physics.aabb import check_collision
from ..render import atlas as atlas_lib
from ..render import compositor as C
from ..render import phases as phases_lib
from ..render import scene as scene_lib

NAME = "jumper"
NUM_ACTIONS = 15
SUB_STEPS = 4  # jumper.cpp:44
DT = 1.0 / SUB_STEPS
ZOOM = 0.3  # jumper.cpp:32
PPU = 16.0 * ZOOM

EMPTY, WALL_TOP, WALL_MID, SPIKE = 0, 1, 2, 3
MAZE_SCALE = 3  # tilemap.cpp:100

# Physics (common_systems.cpp:62-67)
MAX_JUMP = 0.92
GRAVITY = 0.1
MAX_SPEED = 0.5
MIX = 0.2
AIR_CONTROL = 1.0
JUMP_COOLDOWN = 3.0

NUM_PARTICLES = 10  # tilemap.cpp:236
PART_LIFESPAN = 5.0  # common_components.h:63
PART_SPAWN_TIME = 0.5  # common_components.h:65

_MODES = {"easy": 20, "hard": 40, "memory": 45}  # tilemap.cpp:80-87

NUM_BGS = 49
NUM_TILE_THEMES = 4  # tilemap.cpp:10-21 (same Blue/Green/Yellow/Brown set)

_LUT_WALL = np.array([NONE, FULL, FULL, NONE], np.int32)
#   common_systems.cpp:122-124: wall_mid|wall_top full


@dataclasses.dataclass(frozen=True)
class Config:
    mode: str = "easy"  # tilemap.h default (easy world_dim 20)
    # Render-only camera phase quantization for the scene compositor
    # (render/phases.py); 0 = exact continuous camera (slow path).
    scene_phases: int = 4

    @property
    def world_dim(self):
        return _MODES[self.mode]

    @property
    def prune(self):
        return self.mode != "memory"  # tilemap.cpp:176

    @property
    def spike_prob(self):
        return 0.0 if self.mode == "memory" else 0.2  # tilemap.cpp:205


@struct.dataclass
class Level:
    grid: jnp.ndarray  # int8 [D, D] render coords [ry, x]
    spike_grid: jnp.ndarray  # bool [D, D] render coords
    goal_pos: jnp.ndarray  # f32 [2] render units
    agent_pos: jnp.ndarray  # f32 [2]
    theme: jnp.ndarray  # i32
    bg_index: jnp.ndarray  # i32
    bg_offset: jnp.ndarray  # f32


@struct.dataclass
class State:
    level: Level
    pos: jnp.ndarray  # f32 [2]
    vel: jnp.ndarray  # f32 [2]
    on_ground: jnp.ndarray  # bool
    jumps_left: jnp.ndarray  # i32 (common_components.h:50: starts at 2)
    jump_timer: jnp.ndarray  # f32
    face_forward: jnp.ndarray  # bool
    anim_t: jnp.ndarray  # f32
    part_pos: jnp.ndarray  # f32 [NUM_PARTICLES, 2]
    part_life: jnp.ndarray  # f32 [NUM_PARTICLES]
    part_spawn_timer: jnp.ndarray  # f32
    t: jnp.ndarray  # i32
    rng: jax.Array


# ---------------------------------------------------------------------------
# Assets
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _assets():
    names = []
    for th in atlas_lib.CLIMBER_TILE_THEMES:
        names += [f"ctile_top_{th}", f"ctile_mid_{th}"]
    names += ["carrot", "spikeman", "particle_circle",
              "compass_circle", "solid_yellow"]
    names += [f"bunny_{k}" for k in ("stand", "jump", "walk1", "walk2")]
    atlas, idx = atlas_lib.build_atlas(tuple(names))
    bgs = atlas_lib.build_backgrounds("sky", NUM_BGS)
    tile_lut = np.full((NUM_TILE_THEMES, 4), -1, np.int32)
    for t, th in enumerate(atlas_lib.CLIMBER_TILE_THEMES):
        tile_lut[t, WALL_TOP] = idx[f"ctile_top_{th}"]
        tile_lut[t, WALL_MID] = idx[f"ctile_mid_{th}"]
    bunny_lut = np.array(
        [idx[f"bunny_{k}"] for k in ("stand", "jump", "walk1", "walk2")],
        np.int32,
    )
    return dict(
        atlas_p=atlas.transpose(3, 0, 1, 2),
        idx=idx,
        bgs_p=bgs.transpose(3, 0, 1, 2),
        tile_lut=tile_lut,
        bunny_lut=bunny_lut,
    )


# ---------------------------------------------------------------------------
# Generation (tilemap.cpp:79-253)
# ---------------------------------------------------------------------------

def generate(cfg: Config, key) -> Level:
    D = cfg.world_dim
    maze_dim = D // MAZE_SCALE
    (k_maze, k_de, k_fill, k_goal, k_agent, k_spike, k_break,
     k_theme, k_bg, k_bgoff) = jax.random.split(key, 10)

    # --- Maze prior: no-dead-end Kruskal, upsampled x3
    # (tilemap.cpp:103-120) ---
    mwall = kruskal_maze(k_maze, maze_dim, max_dim=maze_dim)
    mwall = open_dead_ends(k_de, mwall, maze_dim)

    xs = jnp.arange(D)
    mx = (xs // MAZE_SCALE)[:, None]  # per-x maze coord
    my = (xs // MAZE_SCALE)[None, :]
    in_maze = (mx < maze_dim) & (my < maze_dim)  # beyond -> padding wall
    prior_wall = jnp.where(
        in_maze,
        mwall[jnp.clip(mx, 0, maze_dim - 1), jnp.clip(my, 0, maze_dim - 1)],
        True,
    )
    prob = jnp.where(prior_wall, 0.8, 0.2)  # tilemap.cpp:115
    wall = jax.random.uniform(k_fill, (D, D)) < prob  # [x, y_up]

    # --- 2 CA passes + borders (tilemap.cpp:122-140) ---
    for _ in range(2):
        wall = rooms.ca_smooth(wall)
    border = (
        (jnp.arange(D)[:, None] == 0) | (jnp.arange(D)[:, None] == D - 1)
        | (jnp.arange(D)[None, :] == 0) | (jnp.arange(D)[None, :] == D - 1)
    )
    wall = wall | border

    # --- Largest connected room (tilemap.cpp:142-153) ---
    room = rooms.largest_room(~wall, iters=D * D // 2)
    open0 = room  # world is wall everywhere except the best room

    # --- Goal + agent cells (tilemap.cpp:155-171) ---
    gx, gy = masked_uniform_cell(k_goal, open0)

    # is_space_on_ground, vectorized (tilemap.cpp:54-64): open cell, open
    # head room above, wall below (world is wall outside the room here)
    xs2 = jnp.arange(D)[:, None]
    ys2 = jnp.arange(D)[None, :]
    ground = (
        open0
        & jnp.roll(open0, -1, 1).at[:, -1].set(False)  # (x, y+1) open
        & ~jnp.roll(open0, 1, 1).at[:, 0].set(False)  # (x, y-1) wall
    )
    cand = ground & ~((xs2 == gx) & (ys2 == gy))
    ax, ay = masked_uniform_cell(k_agent, cand)

    # --- BFS path + prune (tilemap.cpp:173-188) ---
    if cfg.prune:
        dist = rooms.bfs_dist(open0, ax, ay, iters=D * D // 2)
        path = rooms.shortest_path_mask(dist, gx, gy)
        open_f = rooms.dilate_in(path, open0, 4)
    else:
        open_f = open0

    grid = jnp.where(open_f, EMPTY, WALL_MID).astype(jnp.int8)  # [x, y_up]

    # --- Spikes: sequential scan, a placed spike blocks its right
    # neighbor's ground run (tilemap.cpp:205-213 reads tiles as it writes)
    def at_g(g, i, j):
        inb = (i >= 0) & (i < D) & (j >= 0) & (j < D)
        return jnp.where(
            inb, g[jnp.clip(i, 0, D - 1), jnp.clip(j, 0, D - 1)],
            jnp.int8(WALL_MID),
        )

    def sog_g(g, i, j):
        return (
            (at_g(g, i, j) == EMPTY)
            & (at_g(g, i, j + 1) == EMPTY)
            & ((at_g(g, i, j - 1) == WALL_MID) | (at_g(g, i, j - 1) == WALL_TOP))
        )

    def spike_body(i, carry):
        g, key = carry
        key, k = jax.random.split(key)
        x = i // D
        y = i % D
        ok = (
            sog_g(g, x, y) & sog_g(g, x - 1, y) & sog_g(g, x + 1, y)
            & (jax.random.uniform(k) < cfg.spike_prob)
        )
        g = g.at[jnp.clip(x, 0, D - 1), jnp.clip(y, 0, D - 1)].set(
            jnp.where(ok, jnp.int8(SPIKE), g[x, y])
        )
        return g, key

    grid, _ = jax.lax.fori_loop(0, D * D, spike_body, (grid, k_spike))

    # --- Vertical wall breakup (tilemap.cpp:215-225), also sequential ---
    def break_body(i, carry):
        g, key = carry
        key, k1, k2 = jax.random.split(key, 3)
        x = i // D
        y = i % D

        def is_lw(g, j):
            return (at_g(g, x, j) == WALL_MID) & (at_g(g, x + 1, j) == EMPTY)

        def is_rw(g, j):
            return (at_g(g, x, j) == WALL_MID) & (at_g(g, x - 1, j) == EMPTY)

        lw = is_lw(g, y) & is_lw(g, y + 1) & is_lw(g, y + 2)
        dy1 = y + jax.random.randint(k1, (), 0, 3)
        g = g.at[x, jnp.clip(dy1, 0, D - 1)].set(
            jnp.where(lw & (dy1 < D), jnp.int8(EMPTY), g[x, jnp.clip(dy1, 0, D - 1)])
        )
        rw = is_rw(g, y) & is_rw(g, y + 1) & is_rw(g, y + 2)
        dy2 = y + jax.random.randint(k2, (), 0, 3)
        g = g.at[x, jnp.clip(dy2, 0, D - 1)].set(
            jnp.where(rw & (dy2 < D), jnp.int8(EMPTY), g[x, jnp.clip(dy2, 0, D - 1)])
        )
        return g, key

    grid, _ = jax.lax.fori_loop(0, D * D, break_body, (grid, k_break))

    # --- Spike tiles -> spike mask + empty; avoid agent/goal cells
    # (tilemap.cpp:238-245) ---
    is_spike = grid == SPIKE
    is_spike = is_spike.at[ax, ay].set(False)
    is_spike = is_spike.at[gx, gy].set(False)
    grid = jnp.where(grid == SPIKE, jnp.int8(EMPTY), grid)

    # --- Wall tops (tilemap.cpp:248-252): wall_mid with empty above ---
    above_empty = jnp.roll(grid == EMPTY, -1, 1).at[:, -1].set(False)
    grid = jnp.where((grid == WALL_MID) & above_empty, jnp.int8(WALL_TOP), grid)

    # (x, y_up) -> render [ry, x]
    grid_r = jnp.flip(grid.T, axis=0)
    spike_r = jnp.flip(is_spike.T, axis=0)

    goal_pos = jnp.stack([gx + 0.5, D - 1.0 - gy + 0.5]).astype(jnp.float32)
    # Agent spawn y has no +0.5 (tilemap.cpp:227: feet on the cell's bottom)
    agent_pos = jnp.stack([ax + 0.5, D - 1.0 - ay]).astype(jnp.float32)

    return Level(
        grid=grid_r,
        spike_grid=spike_r,
        goal_pos=goal_pos,
        agent_pos=agent_pos,
        theme=jax.random.randint(k_theme, (), 0, NUM_TILE_THEMES),
        bg_index=jax.random.randint(k_bg, (), 0, NUM_BGS),
        bg_offset=jax.random.uniform(k_bgoff),
    )


def reset(cfg: Config, level: Level, key) -> State:
    return State(
        level=level,
        pos=level.agent_pos,
        vel=jnp.zeros(2, jnp.float32),
        on_ground=jnp.bool_(False),
        jumps_left=jnp.int32(2),
        jump_timer=jnp.float32(0.0),
        face_forward=jnp.bool_(True),
        anim_t=jnp.float32(0.0),
        part_pos=jnp.zeros((NUM_PARTICLES, 2), jnp.float32),
        part_life=jnp.zeros(NUM_PARTICLES, jnp.float32),
        part_spawn_timer=jnp.float32(0.0),
        t=jnp.int32(0),
        rng=key,
    )


# ---------------------------------------------------------------------------
# Step (jumper.cpp:341-375)
# ---------------------------------------------------------------------------

def _spike_hit(level, rx, ry):
    """Agent world rect vs spike rects (-0.25,-0.25,0.5,0.5)+cell center
    (common_systems.cpp:149-162).

    Expressed as separable overlap-interval masks contracted against
    the spike grid — the same f32 comparison expressions
    check_collision would evaluate per cell (the rect spans < 1 unit,
    so only the 3x3 window can overlap; testing every cell with the
    identical per-axis inequalities is exactly the reference's per-cell
    loop). It replaces a traced-index 3x3 gather window (36 batched
    scalar gathers per env step under vmap).
    """
    D = level.spike_grid.shape[0]
    t = jnp.arange(D, dtype=jnp.float32)
    bx = t + 0.25  # spike rect origins (cell + 0.25), f32-exact
    ox = (rx < bx + 0.5) & (rx + 0.5 > bx)  # [D] check_collision x-axis
    oy = (ry < bx + 0.5) & (ry + 0.8 > bx)  # [D] y-axis (same origins)
    count = jnp.einsum(
        "h,hw,w->", oy.astype(jnp.bfloat16),
        level.spike_grid.astype(jnp.bfloat16), ox.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )
    return count > 0.5


def _agent_substep(level, pos, vel, on_ground, jumps_left, jump_timer,
                   face_forward, anim_t, action):
    """System_Agent::update (common_systems.cpp:57-201)."""
    a = action
    movement_x = (
        ((a == 6) | (a == 7) | (a == 8)).astype(jnp.float32)
        - ((a == 0) | (a == 1) | (a == 2)).astype(jnp.float32)
    )
    jump = (a == 2) | (a == 5) | (a == 8)

    mix_x = jnp.where(on_ground, MIX, MIX * AIR_CONTROL)
    vx = vel[0] + mix_x * (MAX_SPEED * movement_x - vel[0]) * DT
    vx = jnp.where(jnp.abs(vx) < mix_x * MAX_SPEED * DT, 0.0, vx)

    jumps_left = jnp.where(on_ground, 2, jumps_left)
    do_jump = jump & (jumps_left > 0) & (jump_timer == 0.0)
    vy = jnp.where(do_jump, -MAX_JUMP, vel[1])
    jumps_left = jumps_left - do_jump.astype(jnp.int32)
    jump_timer = jnp.where(do_jump, JUMP_COOLDOWN, jump_timer)
    jump_timer = jnp.maximum(0.0, jump_timer - DT)

    vy = vy + GRAVITY * DT
    vy = jnp.clip(vy, -MAX_JUMP, MAX_JUMP)

    x = pos[0] + vx * DT
    y = pos[1] + vy * DT

    # Collision bounds (-0.25, -0.8, 0.5, 0.8) (tilemap.cpp:233)
    rx, ry, col = resolve_tile_collisions(
        level.grid, _LUT_WALL, x - 0.25, y - 0.8, 0.5, 0.8, WALL_MID
    )
    dx_moved = rx - (x - 0.25)
    dy_moved = ry - (y - 0.8)
    new_on_ground = (dy_moved < 0.0) & col
    hit_ceiling = (dy_moved > 0.0) & col  # common_systems.cpp:143-144
    x = rx + 0.25
    y = ry + 0.8
    vx = jnp.where(dx_moved != 0.0, 0.0, vx)
    vy = jnp.where(hit_ceiling | new_on_ground, 0.0, vy)

    dead = _spike_hit(level, x - 0.25, y - 0.8)
    achieved = check_collision(
        x - 0.25, y - 0.8, 0.5, 0.8,
        level.goal_pos[0] - 0.5, level.goal_pos[1] - 0.5, 1.0, 1.0,
    )

    anim_t = jnp.mod(anim_t + 0.1 * DT, 1.0)
    face_forward = jnp.where(
        movement_x > 0, True, jnp.where(movement_x < 0, False, face_forward)
    )
    return (jnp.stack([x, y]), jnp.stack([vx, vy]), new_on_ground, jumps_left,
            jump_timer, face_forward, anim_t, dead, achieved)


def _particles_substep(pos, part_pos, part_life, spawn_timer, enabled):
    """System_Particles::update (common_systems.cpp:250-279)."""
    life = part_life - DT
    dead = life <= 0.0
    # dead_index = LAST dead slot (loop keeps overwriting)
    idxs = jnp.arange(NUM_PARTICLES)
    dead_idx = jnp.max(jnp.where(dead, idxs, -1))
    spawn_timer = spawn_timer + DT
    do = (dead_idx >= 0) & (spawn_timer >= PART_SPAWN_TIME) & enabled
    spawn_timer = jnp.where(do, jnp.mod(spawn_timer, PART_SPAWN_TIME), spawn_timer)
    slot = jnp.clip(dead_idx, 0, NUM_PARTICLES - 1)
    # offset (0, -0.2) (tilemap.cpp:236); one-hot slot update — a
    # traced-index .at[].set lowers to a batched scatter under vmap
    upd = do & (jnp.arange(NUM_PARTICLES) == slot)
    life = jnp.where(upd, PART_LIFESPAN, life)
    part_pos = jnp.where(
        upd[:, None], jnp.stack([pos[0], pos[1] - 0.2])[None, :], part_pos
    )
    return part_pos, life, spawn_timer


def step(cfg: Config, state: State, action):
    level = state.level
    a = action.astype(jnp.int32)

    pos, vel = state.pos, state.vel
    on_ground = state.on_ground
    jumps_left, jump_timer = state.jumps_left, state.jump_timer
    face_forward, anim_t = state.face_forward, state.anim_t
    part_pos, part_life = state.part_pos, state.part_life
    spawn_timer = state.part_spawn_timer
    done = jnp.bool_(False)
    reward = jnp.float32(0.0)

    for _ in range(SUB_STEPS):  # jumper.cpp:355-369
        active = ~done
        (n_pos, n_vel, n_og, n_jl, n_jt, n_ff, n_anim, dead, achieved) = (
            _agent_substep(level, pos, vel, on_ground, jumps_left, jump_timer,
                           face_forward, anim_t, a)
        )
        # common_systems.cpp:198: `!on_ground || abs(velocity.x) > 0.01f`
        # — but that abs is the int-bound global ::abs (no float
        # overload in scope), so the |vx| < 1 argument truncates to 0
        # and the second clause is ALWAYS FALSE: the reference only
        # emits dust while airborne (same binding as chaser's
        # centering gates, see games/chaser.py:_agent_substep).
        enabled = ~n_og
        n_ppos, n_plife, n_ptimer = _particles_substep(
            n_pos, part_pos, part_life, spawn_timer, enabled
        )

        pos = jnp.where(active, n_pos, pos)
        vel = jnp.where(active, n_vel, vel)
        on_ground = jnp.where(active, n_og, on_ground)
        jumps_left = jnp.where(active, n_jl, jumps_left)
        jump_timer = jnp.where(active, n_jt, jump_timer)
        face_forward = jnp.where(active, n_ff, face_forward)
        anim_t = jnp.where(active, n_anim, anim_t)
        part_pos = jnp.where(active, n_ppos, part_pos)
        part_life = jnp.where(active, n_plife, part_life)
        spawn_timer = jnp.where(active, n_ptimer, spawn_timer)
        reward = jnp.where(active, achieved.astype(jnp.float32) * 10.0, reward)
        done = done | (active & (dead | achieved))

    to_goal = level.goal_pos - pos  # info vector (common_systems.cpp:193)
    new_state = State(
        level=level, pos=pos, vel=vel, on_ground=on_ground,
        jumps_left=jumps_left, jump_timer=jump_timer,
        face_forward=face_forward, anim_t=anim_t,
        part_pos=part_pos, part_life=part_life, part_spawn_timer=spawn_timer,
        t=state.t + 1, rng=state.rng,
    )
    return new_state, reward, done, {"to_goal": to_goal}


# ---------------------------------------------------------------------------
# Rendering (jumper.cpp:445-509)
# ---------------------------------------------------------------------------

def observe(cfg: Config, state: State):
    A = _assets()
    level = state.level
    cam_x = state.pos[0]
    cam_y = state.pos[1] - 0.5  # common_systems.cpp:180-181
    ppu = PPU * (C.OBS / 64.0)  # window renders scale (render_game)
    wx, wy = C.camera_coords(ppu, cam_x, cam_y)

    img = C.clear()
    img = C.draw_background(img, jnp.asarray(A["bgs_p"]), level.bg_index, wx, wy)
    lut = jnp.asarray(A["tile_lut"])[level.theme]
    img = C.draw_tiles(img, level.grid, lut, A["atlas_p"], wx, wy,
                       oob_tile=WALL_MID)  # tilemap.h:84-87: OOB is wall

    # Jump-dust particles (rendered after tilemap, before sprites —
    # jumper.cpp:470-472; fading alpha + shrink, common_systems.cpp:281-303)
    ratio = jnp.clip((PART_LIFESPAN - state.part_life) / PART_LIFESPAN, 0.0, 1.0)
    for i in range(NUM_PARTICLES):
        sc = 0.45 * (0.4 * ratio[i] + 0.6)
        img = C.draw_sprite(
            img, A["atlas_p"], A["idx"]["particle_circle"],
            state.part_pos[i, 0] - 0.5 * sc,
            state.part_pos[i, 1] - ratio[i] * 0.17 - 0.5 * sc,
            sc, sc, wx, wy,
            alive=state.part_life[i] > 0.0,
            alpha=0.5 * (1.0 - ratio[i]),
        )

    # Spikes (z=1, tilemap.cpp:49: sub-cell placement baked into the art)
    spike_layer = jnp.where(level.spike_grid, 0, -1)
    img = C.draw_tiles(
        img, spike_layer, jnp.asarray([A["idx"]["spikeman"]]),
        A["atlas_p"], wx, wy, oob_tile=-1,
    )
    # Carrot goal
    img = C.draw_sprite(
        img, A["atlas_p"], A["idx"]["carrot"],
        level.goal_pos[0] - 0.5, level.goal_pos[1] - 0.5, 1.0, 1.0, wx, wy,
    )
    # Bunny (common_systems.cpp:204-243: per-pose scale/offset)
    pose = jnp.where(
        (jnp.abs(state.vel[0]) < 0.01) & state.on_ground, 0,
        jnp.where(~state.on_ground, 1, jnp.where(state.anim_t > 0.5, 3, 2)),
    )
    sid = jnp.asarray(A["bunny_lut"])[pose]
    scale = jnp.where(pose == 1, 0.6, 0.5)
    off_x = jnp.where(pose == 1, -0.05, 0.0)
    off_y = jnp.where(pose == 1, 0.25, 0.2)
    img = C.draw_sprite(
        img, A["atlas_p"], sid,
        state.pos[0] - 0.25 + off_x, state.pos[1] - 1.0 + off_y,
        scale, scale * 1.33, wx, wy,
        flip_x=~state.face_forward,
    )

    # --- Compass HUD, screen space (jumper.cpp:473-509) ---
    px, py = C.pixel_coords()
    # HUD pixel sizes do NOT scale with the target: the reference sizes
    # the compass by game_zoom alone (jumper.cpp:487: compass_size *
    # game_zoom = 60 px on any surface — most of the 64-px obs, a corner
    # widget on a 512-px window)
    cs = 200.0 * ZOOM
    offx, offy = -32.0 * ZOOM, 32.0 * ZOOM
    to_goal = level.goal_pos - state.pos
    dist = jnp.sqrt(to_goal[0] ** 2 + to_goal[1] ** 2)
    inv = 1.0 / jnp.maximum(1e-4, dist)
    dirx, diry = to_goal[0] * inv, to_goal[1] * inv
    angle = jnp.arctan2(to_goal[1], to_goal[0])
    D = cfg.world_dim
    ratio_bar = jnp.minimum(1.0, dist / (D * 1.414))

    # circle
    img = C.draw_sprite(
        img, A["atlas_p"], A["idx"]["compass_circle"],
        C.OBS - cs + offx, offy, cs, cs, px, py,
    )
    # needle (rotated about its center by `angle`)
    img = C.draw_sprite(
        img, A["atlas_p"], A["idx"]["solid_yellow"],
        C.OBS - cs * 0.75 + offx + cs * 0.25 * dirx,
        cs * 0.5 + offy + cs * 0.25 * diry,
        cs * 0.5, cs * 0.1, px, py,
        rotation=angle,
    )
    # bar (lands below the 64-px obs -> invisible, kept for parity with the
    # window-size render path)
    img = C.draw_sprite(
        img, A["atlas_p"], A["idx"]["solid_yellow"],
        C.OBS - cs + offx, cs + offy, cs * ratio_bar, cs * 0.15, px, py,
        alive=ratio_bar > 0.0,
    )
    return C.finalize(img)


def obs_space(cfg: Config):
    return spaces.Box(0, 255, (C.OBS, C.OBS, 3))


def action_space(cfg: Config):
    return spaces.MultiDiscrete((NUM_ACTIONS,))

# ---------------------------------------------------------------------------
# Batched fast renderer: per-env camera, themed tiles, quantized stamps
# ---------------------------------------------------------------------------

PART_BINS = 6  # particle shrink quantization (max size err < 0.1 px)
NEEDLE_BINS = 64  # compass-needle rotation quantization (~2.8 deg)


@functools.lru_cache(maxsize=None)
def _stamp_banks():
    """Pixel-snapped patch banks (compositor.composite_stamps)."""
    A = atlas_lib
    u = PPU  # 1 world unit in obs pixels (4.8 at zoom 0.3)
    # jump-dust circles at PART_BINS quantized shrink ratios
    # (common_systems.cpp:281-303: scale 0.45*(0.4*ratio+0.6))
    specs = [("carrot", u, u)]
    for q in range(PART_BINS):
        r = (q + 0.5) / PART_BINS
        sc = 0.45 * (0.4 * r + 0.6)
        specs.append(("particle_circle", sc * u, sc * u))
    moving = A.build_pixel_bank(tuple(specs), patch=8)
    # bunny: per-pose scale (common_systems.cpp:204-243) x flip
    bspecs = []
    for i, k in enumerate(("stand", "jump", "walk1", "walk2")):
        scale = 0.6 if k == "jump" else 0.5
        for fl in (False, True):
            bspecs.append((f"bunny_{k}", scale * u, scale * 1.33 * u, 0.0, fl))
    bunny = A.build_pixel_bank(tuple(bspecs), patch=8)
    # compass needle: solid_yellow cs*0.5 x cs*0.1 px, rotation baked as
    # NEEDLE_BINS variants (jumper.cpp:497-502)
    cs = 200.0 * ZOOM
    nspecs = tuple(
        ("solid_yellow", cs * 0.5, cs * 0.1, 2 * np.pi * q / NEEDLE_BINS)
        for q in range(NEEDLE_BINS)
    )
    needle = A.build_pixel_bank(nspecs, patch=32)
    return dict(moving=moving, bunny=bunny, needle=needle)


@functools.lru_cache(maxsize=None)
def _compass_overlay(obs: int):
    """Constant premultiplied compass-circle overlay at obs resolution.

    The circle sits at a fixed screen position (jumper.cpp:487-495:
    compass_size 200 * game_zoom 0.3 = 60 px regardless of target size),
    so it is identical across envs — sampled host-side once, exactly as
    compositor._rect_onehots would (nearest, pixel centers), and blended
    as one constant."""
    cs = 200.0 * ZOOM
    offx, offy = -32.0 * ZOOM, 32.0 * ZOOM
    x0, y0 = obs - cs + offx, offy
    # prefer the overlay PNG decoded at display resolution: the 60 px
    # circle upsampled from the 32 px atlas entry smears its rim
    # (~14/255 mean frame error vs the executed reference)
    from ..render import png_assets

    sp = png_assets.source_path("compass_circle")
    if sp is not None:
        src = png_assets.load_png(sp, size=max(64, obs)) * 255.0
    else:
        src = atlas_lib.sprite_rgba("compass_circle").astype(np.float32)
    S = src.shape[0]
    c = np.arange(obs) + 0.5
    u_f = (c - x0) / cs
    v_f = (c - y0) / cs
    in_u = (u_f >= 0) & (u_f < 1)
    in_v = (v_f >= 0) & (v_f < 1)
    ui = np.clip((u_f * S).astype(np.int32), 0, S - 1)
    vi = np.clip((v_f * S).astype(np.int32), 0, S - 1)
    tex = src[vi[:, None], ui[None, :]]  # [obs, obs, 4]
    tex *= (in_v[:, None] & in_u[None, :])[..., None]
    a = tex[..., 3:4] / 255.0
    rgbp = tex[..., :3] * a
    # numpy out (the cache must never hold tracers: jnp.asarray inside a
    # jit trace stages a constant and returns a Tracer)
    return rgbp.transpose(2, 0, 1)[None], a.transpose(2, 0, 1)[None]


@functools.lru_cache(maxsize=None)
def _scene_assets(qp, D):
    """Tile-entry phase bank + padded content for the quantized-camera
    scene (render/scene.py; see coinrun._scene_assets)."""
    A = _assets()
    atlas_s = np.asarray(A["atlas_p"]).transpose(1, 0, 2, 3)
    idx = A["idx"]
    texs, kinds, themes = [], [], []
    for t, th in enumerate(atlas_lib.CLIMBER_TILE_THEMES):
        texs += [atlas_s[idx[f"ctile_top_{th}"]],
                 atlas_s[idx[f"ctile_mid_{th}"]]]
        kinds += [WALL_TOP, WALL_MID]
        themes += [t, t]
    texs.append(atlas_s[idx["spikeman"]])
    kinds.append(SPIKE)
    themes.append(-1)
    bank = phases_lib.tile_phase_bank(np.stack(texs), PPU, 64, qp)
    P = phases_lib.WIN
    GP = D + 2 * P
    bgs = np.asarray(A["bgs_p"])  # [3, NB, 64, 64]
    bgpad = np.zeros((NUM_BGS, 3, GP, GP), np.uint8)
    n = min(64, GP - P)
    bgpad[:, :, P:P + n, P:P + n] = bgs.transpose(1, 0, 2, 3)[:, :, :n, :n]
    return dict(bank=bank, kinds=tuple(kinds), themes=tuple(themes),
                bgpad=bgpad)


def _observe_scene(cfg: Config, states: State):
    """Quantized-camera scene path (see coinrun._observe_scene): bg +
    themed walls + spikes + particle/carrot and bunny stamp groups run
    in one scene pass; the compass overlay + rotated needle follow as
    frame-space blends. One z deviation vs the exact path: spikes
    come from the tile layer, so dust particles draw OVER spike cells
    instead of under (visible only when dust drifts onto a spike)."""
    A = _assets()
    banks = _stamp_banks()
    qp = cfg.scene_phases
    D = cfg.world_dim
    SA = _scene_assets(qp, D)
    level = states.level
    N = states.pos.shape[0]
    W = phases_lib.WIN

    mx = jnp.round(states.pos[:, 0] * qp).astype(jnp.int32)
    my = jnp.round((states.pos[:, 1] - 0.5) * qp).astype(jnp.int32)
    cam_x = mx.astype(jnp.float32) / qp
    cam_y = my.astype(jnp.float32) / qp
    jx = jnp.mod(mx, qp)
    jy = jnp.mod(my, qp)
    _, _, t0_off = phases_lib.phase_tables(PPU, 64, qp)
    tx0 = jnp.floor(cam_x + jnp.float32(t0_off)).astype(jnp.int32)
    ty0 = jnp.floor(cam_y + jnp.float32(t0_off)).astype(jnp.int32)

    merged = jnp.where(level.spike_grid, jnp.int8(SPIKE), level.grid)
    gridp = jnp.pad(merged, ((0, 0), (W, W), (W, W)),
                    constant_values=WALL_MID)  # OOB is wall, tilemap.h:84-87

    def pix(centers, P):
        px = (centers[..., 0] - cam_x[:, None]) * PPU + C.OBS / 2
        py = (centers[..., 1] - cam_y[:, None]) * PPU + C.OBS / 2
        return (jnp.round(py - P / 2).astype(jnp.int32),
                jnp.round(px - P / 2).astype(jnp.int32))

    # particles + carrot share the "moving" bank and are z-adjacent
    ratio = jnp.clip(
        (PART_LIFESPAN - states.part_life) / PART_LIFESPAN, 0.0, 1.0)
    pvar = 1 + jnp.clip(
        (ratio * PART_BINS).astype(jnp.int32), 0, PART_BINS - 1)
    pcenter = jnp.stack(
        [states.part_pos[..., 0], states.part_pos[..., 1] - ratio * 0.17],
        axis=-1)
    pscale = (states.part_life > 0.0) * (0.5 * (1.0 - ratio))
    centers = jnp.concatenate([pcenter, level.goal_pos[:, None, :]], axis=1)
    vars_ = jnp.concatenate([pvar, jnp.zeros((N, 1), jnp.int32)], axis=1)
    scales = jnp.concatenate(
        [pscale.astype(jnp.float32), jnp.ones((N, 1), jnp.float32)], axis=1)
    r0, c0 = pix(centers, 8)

    pose = jnp.where(
        (jnp.abs(states.vel[:, 0]) < 0.01) & states.on_ground, 0,
        jnp.where(~states.on_ground, 1,
                  jnp.where(states.anim_t > 0.5, 3, 2)),
    ).astype(jnp.int32)
    bvar = (pose * 2 + (~states.face_forward).astype(jnp.int32))[:, None]
    bscale = jnp.where(pose == 1, 0.6, 0.5)
    off_x = jnp.where(pose == 1, -0.05, 0.0)
    off_y = jnp.where(pose == 1, 0.25, 0.2)
    bcenter = jnp.stack(
        [states.pos[:, 0] - 0.25 + off_x + bscale * 0.5,
         states.pos[:, 1] - 1.0 + off_y + bscale * 1.33 * 0.5], axis=-1
    )[:, None, :]
    br0, bc0 = pix(bcenter, 8)

    groups = [
        (C._premultiply_bank(banks["moving"]), vars_, scales, r0, c0),
        (C._premultiply_bank(banks["bunny"]), bvar,
         jnp.ones((N, 1), jnp.float32), br0, bc0),
    ]
    img = scene_lib.render_scene(
        gridp, SA["bgpad"], ty0, tx0, jy, jx,
        level.bg_index.astype(jnp.int32), level.theme.astype(jnp.int32),
        SA["bank"], SA["kinds"], SA["themes"], groups, PPU, qp, W)

    # ---- compass HUD (screen space, jumper.cpp:473-509) ----
    crgb_np, ca_np = _compass_overlay(C.OBS)
    img = img * (1.0 - jnp.asarray(ca_np, jnp.bfloat16)) \
        + jnp.asarray(crgb_np, jnp.bfloat16)

    cs = 200.0 * ZOOM
    offx, offy = -32.0 * ZOOM, 32.0 * ZOOM
    to_goal = level.goal_pos - states.pos
    dist = jnp.sqrt(to_goal[:, 0] ** 2 + to_goal[:, 1] ** 2)
    dinv = 1.0 / jnp.maximum(1e-4, dist)
    dirx, diry = to_goal[:, 0] * dinv, to_goal[:, 1] * dinv
    angle = jnp.arctan2(to_goal[:, 1], to_goal[:, 0])
    nvar = jnp.mod(
        jnp.round(angle * (NEEDLE_BINS / (2 * np.pi))).astype(jnp.int32),
        NEEDLE_BINS,
    )[:, None]
    ncx = C.OBS - cs * 0.75 + offx + cs * 0.25 * dirx + cs * 0.25
    ncy = cs * 0.5 + offy + cs * 0.25 * diry + cs * 0.05
    nr0 = jnp.round(ncy - 16.0).astype(jnp.int32)[:, None]
    nc0 = jnp.round(ncx - 16.0).astype(jnp.int32)[:, None]
    img = C.composite_stamps(img, banks["needle"], nvar, nr0, nc0)

    obs = jnp.clip(jnp.round(img), 0, 255).astype(jnp.uint8)
    return obs  # planar u8 [N, 3, OBS, OBS]


def observe_batch(cfg: Config, states: State):
    """Batched renderer: same scene as `observe` via the scene
    compositor at obs resolution (quantized render camera), or shared
    batched matmuls + pixel-snapped stamps otherwise. Approximations vs
    the per-env path: stamp pixel snapping (<=1 px), particle size /
    needle angle quantization (PART_BINS / NEEDLE_BINS), additive
    blending of overlapping stamps. The distance bar is omitted: its
    obs-space y (69.6 px) is off the 64-px frame entirely
    (jumper.cpp:503-509 quirk; the window-size path goes through
    `observe`)."""
    if C.OBS == 64 and cfg.scene_phases > 0:
        return _observe_scene(cfg, states)
    return _observe_exact(cfg, states)


def _observe_exact(cfg: Config, states: State):
    A = _assets()
    banks = _stamp_banks()
    level = states.level
    N = states.pos.shape[0]
    D = cfg.world_dim
    cam_x = states.pos[:, 0]
    cam_y = states.pos[:, 1] - 0.5  # common_systems.cpp:180-181

    c = jnp.arange(C.OBS, dtype=jnp.float32) + 0.5 - C.OBS / 2
    wx_b = cam_x[:, None] + c[None, :] / PPU
    wy_b = cam_y[:, None] + c[None, :] / PPU

    img = C.draw_background_batch(
        jnp.asarray(A["bgs_p"]), level.bg_index.astype(jnp.int32), wx_b, wy_b
    )

    # ---- tiles: themed walls + shared spike kind ----
    ohy, ohx, ohv, ohu, inb = C.tile_onehots(wx_b, wy_b, D, D)
    merged = jnp.where(level.spike_grid, jnp.int8(SPIKE), level.grid)
    G = jnp.einsum("nrh,nhw->nrw", ohy, merged.astype(jnp.bfloat16),
                   preferred_element_type=jnp.bfloat16)
    G = jnp.einsum("nrw,nuw->nru", G, ohx,
                   preferred_element_type=jnp.bfloat16)
    G = jnp.where(inb, jnp.round(G),
                  jnp.float32(WALL_MID)).astype(jnp.int8)[:, None]
    # tilemap.h:84-87: "Out of bounds is a wall" — the renderer's tile
    # loop reads get() past the map edges, so the reference paints
    # themed wall_mid beyond the level borders (visible when the camera
    # nears a corner; rendering it EMPTY measured ~10/255 mean frame
    # error against the executed binary on edge-adjacent spawns)

    atlas_s = jnp.asarray(A["atlas_p"]).transpose(1, 0, 2, 3)  # [A, 4, S, S]
    tl = jnp.asarray(A["tile_lut"])
    th = level.theme.astype(jnp.int32)
    themed = jnp.stack(
        [atlas_s[tl[th, WALL_TOP]], atlas_s[tl[th, WALL_MID]]], axis=1
    ).astype(jnp.bfloat16)  # [N, 2, 4, S, S]
    t1 = jnp.einsum("nrh,nkchw->nkcrw", ohv, themed,
                    preferred_element_type=jnp.bfloat16)
    themed_img = jnp.einsum("nkcrw,nuw->nkcru", t1, ohu,
                            preferred_element_type=jnp.bfloat16)
    spike_tex = atlas_s[A["idx"]["spikeman"]].astype(jnp.bfloat16)
    s1 = jnp.einsum("nrh,chw->ncrw", ohv, spike_tex,
                    preferred_element_type=jnp.bfloat16)
    spike_img = jnp.einsum("ncrw,nuw->ncru", s1, ohu,
                           preferred_element_type=jnp.bfloat16)

    inv = jnp.bfloat16(1 / 255.0)

    def blend_kind(img, mask, kimg):
        a = mask.astype(jnp.bfloat16) * (kimg[:, 3:4] * inv)
        return img + a * (kimg[:, :3] - img)

    img = blend_kind(img, G == WALL_TOP, themed_img[:, 0])
    img = blend_kind(img, G == WALL_MID, themed_img[:, 1])

    def pix(centers, P):
        px = (centers[..., 0] - cam_x[:, None]) * PPU + C.OBS / 2
        py = (centers[..., 1] - cam_y[:, None]) * PPU + C.OBS / 2
        return (jnp.round(py - P / 2).astype(jnp.int32),
                jnp.round(px - P / 2).astype(jnp.int32))

    # ---- dust particles (jumper.cpp:470-472: after tilemap) ----
    ratio = jnp.clip(
        (PART_LIFESPAN - states.part_life) / PART_LIFESPAN, 0.0, 1.0
    )  # [N, NUM_PARTICLES]
    pvar = 1 + jnp.clip(
        (ratio * PART_BINS).astype(jnp.int32), 0, PART_BINS - 1
    )
    pcenter = jnp.stack(
        [states.part_pos[..., 0], states.part_pos[..., 1] - ratio * 0.17],
        axis=-1,
    )
    r0, c0 = pix(pcenter, 8)
    img = C.composite_stamps(
        img, banks["moving"], pvar, r0, c0,
        alives=states.part_life > 0.0, alpha=0.5 * (1.0 - ratio),
    )

    # spikes render above particles in class z-order (z=1, jumper.cpp:471)
    img = blend_kind(img, G == SPIKE, spike_img)

    # ---- carrot goal + bunny ----
    r0, c0 = pix(level.goal_pos[:, None, :], 8)
    img = C.composite_stamps(
        img, banks["moving"], jnp.zeros((N, 1), jnp.int32), r0, c0
    )

    pose = jnp.where(
        (jnp.abs(states.vel[:, 0]) < 0.01) & states.on_ground, 0,
        jnp.where(~states.on_ground, 1,
                  jnp.where(states.anim_t > 0.5, 3, 2)),
    ).astype(jnp.int32)
    bvar = (pose * 2 + (~states.face_forward).astype(jnp.int32))[:, None]
    scale = jnp.where(pose == 1, 0.6, 0.5)
    off_x = jnp.where(pose == 1, -0.05, 0.0)
    off_y = jnp.where(pose == 1, 0.25, 0.2)
    bcenter = jnp.stack(
        [states.pos[:, 0] - 0.25 + off_x + scale * 0.5,
         states.pos[:, 1] - 1.0 + off_y + scale * 1.33 * 0.5], axis=-1
    )[:, None, :]
    r0, c0 = pix(bcenter, 8)
    img = C.composite_stamps(img, banks["bunny"], bvar, r0, c0)

    # ---- compass HUD (screen space, jumper.cpp:473-509) ----
    crgb_np, ca_np = _compass_overlay(C.OBS)
    crgb = jnp.asarray(crgb_np, jnp.bfloat16)
    ca = jnp.asarray(ca_np, jnp.bfloat16)
    img = img * (1.0 - ca) + crgb

    cs = 200.0 * ZOOM
    offx, offy = -32.0 * ZOOM, 32.0 * ZOOM
    to_goal = level.goal_pos - states.pos  # [N, 2]
    dist = jnp.sqrt(to_goal[:, 0] ** 2 + to_goal[:, 1] ** 2)
    dinv = 1.0 / jnp.maximum(1e-4, dist)
    dirx, diry = to_goal[:, 0] * dinv, to_goal[:, 1] * dinv
    angle = jnp.arctan2(to_goal[:, 1], to_goal[:, 0])
    nvar = jnp.mod(
        jnp.round(angle * (NEEDLE_BINS / (2 * np.pi))).astype(jnp.int32),
        NEEDLE_BINS,
    )[:, None]
    # needle center in screen px: top-left + (cs*0.25, cs*0.05)
    ncx = C.OBS - cs * 0.75 + offx + cs * 0.25 * dirx + cs * 0.25
    ncy = cs * 0.5 + offy + cs * 0.25 * diry + cs * 0.05
    r0 = jnp.round(ncy - 16.0).astype(jnp.int32)[:, None]
    c0 = jnp.round(ncx - 16.0).astype(jnp.int32)[:, None]
    img = C.composite_stamps(img, banks["needle"], nvar, r0, c0)

    obs = jnp.clip(jnp.round(img), 0, 255).astype(jnp.uint8)
    return obs  # planar u8 [N, 3, OBS, OBS]; layout applied by the Environment
