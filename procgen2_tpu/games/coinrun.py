"""Coinrun: procedurally-generated platformer with pits, hazards and a coin.

JAX re-implementation of the reference's `games/coinrun/`:
  * level generation — difficulty-scaled platform sections with elevation
    deltas bounded by jump physics, pits filled with lava/saws/mobs, crate
    piles, coin goal, wall close-off (tilemap.cpp:97-292);
  * platformer physics — velocity mixing with air control, jump, gravity,
    fall-speed clamp, two-pass tile collision with one-way crates
    (common_systems.cpp:121-252);
  * walking-mob AI — patrol with wall/ledge rebound via two tile sensors
    (common_systems.cpp:65-105);
  * 4 physics sub-steps per env step with early exit on termination
    (coinrun.cpp:44-45, 357-371); zoom 0.3 camera following the agent
    (coinrun.cpp:32, common_systems.cpp:238-239).

Note on particles: the reference registers System_Particles but never
attaches Component_Particles to any coinrun entity (the agent spawn at
coinrun.cpp:489-495 omits it), so coinrun renders no particles — matched
here by having none.

State is structure-of-arrays with fixed-capacity mob/saw slots (SURVEY.md
§7.3); everything jits and vmaps over the env batch.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from ..core import spaces
from ..physics.tiles import (
    fetch_window_patch, resolve_from_patch, resolve_tile_collisions,
    NONE, FULL, DOWN_ONLY,
)
from ..physics.aabb import check_collision
from ..render import atlas as atlas_lib
from ..render import compositor as C
from ..render import phases as phases_lib
from ..render import scene as scene_lib

NAME = "coinrun"
NUM_ACTIONS = 15
WORLD = 64  # map is 64x64 tiles, tilemap.cpp:98-99
SUB_STEPS = 4  # coinrun.cpp:44
DT = 1.0 / SUB_STEPS
ZOOM = 0.3  # coinrun.cpp:32
PPU = 16.0 * ZOOM  # obs pixels per world unit (render_game, coinrun.cpp:454)

# Tile ids (tilemap.h:13-21)
EMPTY, WALL_TOP, WALL_MID, LAVA_TOP, LAVA_MID, CRATE = 0, 1, 2, 3, 4, 5
NUM_TILE_IDS = 6

# Agent physics (common_systems.cpp:126-130)
MAX_JUMP = 1.55
GRAVITY = 0.2
MAX_SPEED = 0.5
MIX = 0.2
AIR_CONTROL = 0.15

# Generation physics bounds (tilemap.cpp:100-146; gen uses max_jump=1.5)
GEN_MAX_DX = int(0.5 * 2.0 * 1.5 / 0.2 - 0.5)  # = 7
GEN_MAX_DY = int(1.5 * 1.5 / (2.0 * 0.2) - 0.5)  # = 5

MAX_SAWS = 40
MAX_MOBS = 40
MAX_SECTIONS = 5  # num_sections <= 2*difficulty - 1 <= 5 (tilemap.cpp:126)

NUM_BGS = 49  # coinrun.cpp:60-110
NUM_WALL_THEMES = len(atlas_lib.WALL_THEMES)
NUM_AGENT_THEMES = len(atlas_lib.AGENT_THEMES)
NUM_ENEMY_KINDS = len(atlas_lib.WALKING_ENEMIES)
NUM_CRATE_TYPES = len(atlas_lib.CRATE_TYPES)

# Collision LUTs (indexed by tile id)
_LUT_AGENT = np.array([NONE, FULL, FULL, NONE, NONE, DOWN_ONLY], np.int32)
#             common_systems.cpp:176-178: walls full, crates down_only
_LUT_WALL = np.array([NONE, FULL, FULL, NONE, NONE, NONE], np.int32)
#             mob wall sensor, common_systems.cpp:80-82
_LUT_EMPTY = np.array([FULL, NONE, NONE, NONE, NONE, NONE], np.int32)
#             mob ledge sensor "collides with empty", common_systems.cpp:84-86
_LUT_LAVA = np.array([NONE, NONE, NONE, FULL, FULL, NONE], np.int32)
#             common_systems.cpp:215-217


@dataclasses.dataclass(frozen=True)
class Config:
    # Runtime-exposed version of the compile-time Config struct
    # (tilemap.h:40-46).
    easy_mode: bool = False
    allow_pit: bool = True
    allow_crate: bool = True
    allow_dy: bool = True
    allow_mobs: bool = True
    # Render-only: camera phase quantization for the scene compositor
    # (render/phases.py); 0 = exact continuous camera (slow path).
    scene_phases: int = 4


@struct.dataclass
class Level:
    grid: jnp.ndarray  # int8 [64, 64] render coords [y, x]
    crate_variant: jnp.ndarray  # int8 [64, 64]
    coin_pos: jnp.ndarray  # f32 [2]
    saw_pos: jnp.ndarray  # f32 [MAX_SAWS, 2]
    saw_alive: jnp.ndarray  # bool [MAX_SAWS]
    mob_pos0: jnp.ndarray  # f32 [MAX_MOBS, 2]
    mob_vx0: jnp.ndarray  # f32 [MAX_MOBS]
    mob_variant: jnp.ndarray  # int8 [MAX_MOBS]
    mob_alive: jnp.ndarray  # bool [MAX_MOBS]
    theme: jnp.ndarray  # i32 wall theme
    agent_theme: jnp.ndarray  # i32
    bg_index: jnp.ndarray  # i32
    difficulty: jnp.ndarray  # i32


@struct.dataclass
class State:
    level: Level
    pos: jnp.ndarray  # f32 [2]
    vel: jnp.ndarray  # f32 [2]
    on_ground: jnp.ndarray  # bool
    face_forward: jnp.ndarray  # bool (defaults true, common_components.h:57)
    anim_t: jnp.ndarray  # f32, agent walk cycle (common_systems.cpp:242-243)
    mob_pos: jnp.ndarray  # f32 [MAX_MOBS, 2]
    mob_vx: jnp.ndarray  # f32 [MAX_MOBS]
    t: jnp.ndarray  # i32 env steps this episode
    rng: jax.Array


# ---------------------------------------------------------------------------
# Assets
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _assets():
    names = []
    for th in atlas_lib.WALL_THEMES:
        names += [f"wall_top_{th}", f"wall_mid_{th}"]
    names += ["lava_top", "lava_mid"]
    names += list(atlas_lib.CRATE_TYPES)
    names += ["saw", "saw_move", "coin", "particle_circle"]
    for e in atlas_lib.WALKING_ENEMIES:
        names += [e, f"{e}_move"]
    for th in atlas_lib.AGENT_THEMES:
        names += [f"alien_{th}_{k}" for k in ("stand", "jump", "walk1", "walk2")]
    atlas, idx = atlas_lib.build_atlas(tuple(names))
    bgs = atlas_lib.build_backgrounds("sky", NUM_BGS)

    # LUT [theme, tile_id] -> atlas sprite (crate drawn by its own layer)
    tile_lut = np.full((NUM_WALL_THEMES, NUM_TILE_IDS), -1, np.int32)
    for t, th in enumerate(atlas_lib.WALL_THEMES):
        tile_lut[t, WALL_TOP] = idx[f"wall_top_{th}"]
        tile_lut[t, WALL_MID] = idx[f"wall_mid_{th}"]
        tile_lut[t, LAVA_TOP] = idx["lava_top"]
        tile_lut[t, LAVA_MID] = idx["lava_mid"]
    crate_lut = np.array([idx[c] for c in atlas_lib.CRATE_TYPES], np.int32)
    enemy_lut = np.array(
        [[idx[e], idx[f"{e}_move"]] for e in atlas_lib.WALKING_ENEMIES], np.int32
    )
    saw_frames = np.array([idx["saw"], idx["saw_move"]], np.int32)
    agent_lut = np.array(
        [
            [idx[f"alien_{th}_{k}"] for k in ("stand", "jump", "walk1", "walk2")]
            for th in atlas_lib.AGENT_THEMES
        ],
        np.int32,
    )
    return dict(
        atlas_p=atlas.transpose(3, 0, 1, 2),
        idx=idx,
        bgs_p=bgs.transpose(3, 0, 1, 2),
        tile_lut=tile_lut,
        crate_lut=crate_lut,
        enemy_lut=enemy_lut,
        saw_frames=saw_frames,
        agent_lut=agent_lut,
    )


# ---------------------------------------------------------------------------
# Generation (tilemap.cpp:97-292)
# ---------------------------------------------------------------------------

def _set_area(grid, x0, y0, w, h, tile_id):
    """Masked rectangular fill in y-up coords; grid is [x, y_up]
    (set_area, tilemap.cpp:40-44; OOB writes are dropped, tilemap.h:67-72)."""
    xs = jnp.arange(WORLD)[:, None]
    ys = jnp.arange(WORLD)[None, :]
    m = (xs >= x0) & (xs < x0 + w) & (ys >= y0) & (ys < y0 + h)
    return jnp.where(m, tile_id, grid)


def _set_area_with_top(grid, x0, y0, w, h, mid_id, top_id):
    """tilemap.cpp:46-49: body fill + distinct top row."""
    grid = _set_area(grid, x0, y0, w, h - 1, mid_id)
    grid = _set_area(grid, x0, y0 + h - 1, w, 1, top_id)
    return grid


def generate(cfg: Config, key) -> Level:
    keys = jax.random.split(key, 8)
    grid = jnp.zeros((WORLD, WORLD), jnp.int8)  # [x, y_up]
    crate_g = jnp.zeros((WORLD, WORLD), jnp.int8)

    # Floors and walls (tilemap.cpp:113-117)
    grid = _set_area(grid, 0, 0, WORLD, 1, WALL_TOP)
    grid = _set_area(grid, 0, 0, 1, WORLD, WALL_MID)
    grid = _set_area(grid, WORLD - 1, 0, 1, WORLD, WALL_MID)
    grid = _set_area(grid, 0, WORLD - 1, WORLD, 1, WALL_MID)

    difficulty = jax.random.randint(keys[0], (), 1, 4)  # tilemap.cpp:122-124
    num_sections = jax.random.randint(
        keys[1], (), difficulty, 2 * difficulty
    )  # section_dist(difficulty, 2*difficulty-1), tilemap.cpp:126-128
    danger_type = jax.random.randint(keys[2], (), 0, 3)  # tilemap.cpp:135-137
    pit_thresh = difficulty

    saw_pos = jnp.zeros((MAX_SAWS, 2), jnp.float32)
    saw_n = jnp.int32(0)
    mob_pos = jnp.zeros((MAX_MOBS, 2), jnp.float32)
    mob_vx = jnp.zeros(MAX_MOBS, jnp.float32)
    mob_var = jnp.zeros(MAX_MOBS, jnp.int8)
    mob_n = jnp.int32(0)

    def spawn_saw(carry, x, y, cond):
        saw_pos, saw_n = carry
        p = jnp.stack([x + 0.5, WORLD - 1.0 - y + 0.5])
        saw_pos = saw_pos.at[saw_n].set(jnp.where(cond, p, saw_pos[saw_n]))
        return saw_pos, saw_n + cond.astype(jnp.int32)

    def spawn_mob(carry, x, y, cond, k):
        # spawn_enemy_mob, tilemap.cpp:70-94: random kind, +-0.15 start dir
        mob_pos, mob_vx, mob_var, mob_n = carry
        kv, kd = jax.random.split(k)
        p = jnp.stack([x + 0.5, WORLD - 1.0 - y + 0.5])
        var = jax.random.randint(kv, (), 0, NUM_ENEMY_KINDS).astype(jnp.int8)
        vx = 0.15 * jnp.where(jax.random.uniform(kd) < 0.5, 1.0, -1.0)
        mob_pos = mob_pos.at[mob_n].set(jnp.where(cond, p, mob_pos[mob_n]))
        mob_vx = mob_vx.at[mob_n].set(jnp.where(cond, vx, mob_vx[mob_n]))
        mob_var = mob_var.at[mob_n].set(jnp.where(cond, var, mob_var[mob_n]))
        return mob_pos, mob_vx, mob_var, mob_n + cond.astype(jnp.int32)

    def section(i, carry):
        (grid, crate_g, curr_x, curr_y, saw_pos, saw_n,
         mob_pos, mob_vx, mob_var, mob_n, key) = carry
        key, *sk = jax.random.split(key, 17)
        act = (i < num_sections) & (curr_x + 15 < WORLD)  # tilemap.cpp:150-152

        do = difficulty // 3  # difficult_offset, tilemap.cpp:154
        dy = jax.random.randint(sk[0], (), 1 + do, 5 + do)
        dy = jnp.where(cfg.allow_dy, dy, 0)
        dy = jnp.minimum(dy, GEN_MAX_DY)
        flip = (curr_y >= 20) | (
            (curr_y >= 5) & (jax.random.uniform(sk[1]) < 0.5)
        )  # tilemap.cpp:163
        dy = jnp.where(flip, -dy, dy)
        dx = jax.random.randint(sk[2], (), 3 + do, 2 * difficulty + 3 + do)
        new_y = jnp.maximum(1, curr_y + dy)

        use_pit = (
            cfg.allow_pit
            & (dx > 7)
            & (new_y > 3)
            & (jax.random.randint(sk[3], (), 0, 20) >= pit_thresh)
        )  # tilemap.cpp:174

        # ---- pit branch (tilemap.cpp:178-233) ----
        x1 = jax.random.randint(sk[4], (), 1, 4)
        x2 = jax.random.randint(sk[5], (), 1, 4)
        pit_w0 = dx - x1 - x2
        pit_w = jnp.minimum(pit_w0, GEN_MAX_DX)
        x2 = jnp.where(pit_w0 > GEN_MAX_DX, dx - x1 - pit_w, x2)

        pit_grid = grid
        pit_grid = _set_area_with_top(pit_grid, curr_x, 0, x1, new_y, WALL_MID, WALL_TOP)
        pit_grid = _set_area_with_top(
            pit_grid, curr_x + dx - x2, 0, x2, new_y, WALL_MID, WALL_TOP
        )
        lava_h = jax.random.randint(sk[6], (), 1, jnp.maximum(new_y - 3, 1) + 1)
        pit_grid = jnp.where(
            use_pit & (danger_type == 0),
            _set_area_with_top(pit_grid, curr_x + x1, 1, pit_w, lava_h, LAVA_MID, LAVA_TOP),
            pit_grid,
        )
        # saws / mobs across the pit floor (tilemap.cpp:201-209)
        mobkeys = jax.random.split(sk[7], GEN_MAX_DX)
        for pi in range(GEN_MAX_DX):
            in_pit = act & use_pit & (pi < pit_w)
            saw_pos, saw_n = spawn_saw(
                (saw_pos, saw_n), (curr_x + x1 + pi).astype(jnp.float32), 1.0,
                in_pit & (danger_type == 1),
            )
            mob_pos, mob_vx, mob_var, mob_n = spawn_mob(
                (mob_pos, mob_vx, mob_var, mob_n),
                (curr_x + x1 + pi).astype(jnp.float32), 1.0,
                in_pit & (danger_type == 2), mobkeys[pi],
            )
        # mid-pit rescue platform (tilemap.cpp:212-232)
        d2a = jax.random.randint(sk[8], (), 1, 3)
        d2b = jax.random.randint(sk[9], (), 1, 3)
        x3 = jnp.where(pit_w == 5, d2a, d2a + 1)
        w1 = jnp.where(pit_w <= 6, d2b, pit_w - x3 - (d2b + 1))
        pit_grid = jnp.where(
            use_pit & (pit_w > 4),
            _set_area_with_top(pit_grid, curr_x + x1 + x3, new_y - 1, w1, 1, WALL_MID, WALL_TOP),
            pit_grid,
        )

        # ---- flat branch (tilemap.cpp:234-274) ----
        flat_grid = _set_area_with_top(grid, curr_x, 0, dx, new_y, WALL_MID, WALL_TOP)
        saw_here = (jax.random.randint(sk[10], (), 0, 10) < 2 * difficulty) & (dx > 3)
        saw_x = curr_x + jax.random.randint(sk[11], (), 1, jnp.maximum(dx - 1, 2))
        saw_pos, saw_n = spawn_saw(
            (saw_pos, saw_n), saw_x.astype(jnp.float32), new_y.astype(jnp.float32),
            act & ~use_pit & saw_here,
        )
        mob_here = (
            cfg.allow_mobs
            & (jax.random.randint(sk[12], (), 0, 10) < difficulty)
            & (dx > 3)
        )
        mob_x = curr_x + jax.random.randint(sk[13], (), 1, jnp.maximum(dx - 1, 2))
        mob_pos, mob_vx, mob_var, mob_n = spawn_mob(
            (mob_pos, mob_vx, mob_var, mob_n),
            mob_x.astype(jnp.float32), new_y.astype(jnp.float32),
            act & ~use_pit & mob_here, sk[14],
        )
        ob1_x = jnp.where(mob_here, mob_x, jnp.where(saw_here, saw_x, -1))

        # crate piles (tilemap.cpp:258-273)
        ckeys = jax.random.split(sk[15], 2)
        for ci in range(2):
            k1, k2, k3, k4 = jax.random.split(ckeys[ci], 4)
            crate_x = curr_x + jax.random.randint(k1, (), 1, jnp.maximum(dx - 1, 2))
            ok = (
                act & ~use_pit & cfg.allow_crate
                & (jax.random.uniform(k2) < 0.5) & (crate_x != ob1_x)
            )
            pile_h = jax.random.randint(k3, (), 1, 4)
            vkeys = jax.random.split(k4, 3)
            for j in range(3):
                put = ok & (j < pile_h)
                flat_grid = jnp.where(
                    put,
                    _set_area(flat_grid, crate_x, new_y + j, 1, 1, CRATE),
                    flat_grid,
                )
                crate_g = jnp.where(
                    put,
                    _set_area(
                        crate_g, crate_x, new_y + j, 1, 1,
                        jax.random.randint(vkeys[j], (), 0, NUM_CRATE_TYPES).astype(jnp.int8),
                    ),
                    crate_g,
                )

        new_grid = jnp.where(act, jnp.where(use_pit, pit_grid, flat_grid), grid)
        curr_x = jnp.where(act, curr_x + dx, curr_x)
        curr_y = jnp.where(act, new_y, curr_y)
        return (new_grid, crate_g, curr_x, curr_y, saw_pos, saw_n,
                mob_pos, mob_vx, mob_var, mob_n, key)

    carry = (grid, crate_g, jnp.int32(5), jnp.int32(1), saw_pos, saw_n,
             mob_pos, mob_vx, mob_var, mob_n, keys[3])
    carry = jax.lax.fori_loop(0, MAX_SECTIONS, section, carry)
    (grid, crate_g, curr_x, curr_y, saw_pos, saw_n,
     mob_pos, mob_vx, mob_var, mob_n, _) = carry

    # Coin + wall close-off (tilemap.cpp:279-291)
    coin_pos = jnp.stack(
        [curr_x + 0.5, WORLD - 1.0 - curr_y + 0.5]
    ).astype(jnp.float32)
    grid = _set_area_with_top(grid, curr_x, 0, 1, curr_y, WALL_MID, WALL_TOP)
    grid = _set_area(grid, curr_x + 1, 0, WORLD - curr_x, WORLD, WALL_MID)

    # y-up [x, y] -> render rows [ry, x] (see compositor.py convention)
    grid_r = jnp.flip(grid.T, axis=0)
    crate_r = jnp.flip(crate_g.T, axis=0)

    idxs = jnp.arange(MAX_SAWS)
    midxs = jnp.arange(MAX_MOBS)
    return Level(
        grid=grid_r,
        crate_variant=crate_r,
        coin_pos=coin_pos,
        saw_pos=saw_pos,
        saw_alive=idxs < saw_n,
        mob_pos0=mob_pos,
        mob_vx0=mob_vx,
        mob_variant=mob_var,
        mob_alive=midxs < mob_n,
        theme=jax.random.randint(keys[4], (), 0, NUM_WALL_THEMES),
        agent_theme=jax.random.randint(keys[5], (), 0, NUM_AGENT_THEMES),
        bg_index=jax.random.randint(keys[6], (), 0, NUM_BGS),
        difficulty=difficulty,
    )


def reset(cfg: Config, level: Level, key) -> State:
    return State(
        level=level,
        pos=jnp.array([1.5, WORLD - 2.0], jnp.float32),  # coinrun.cpp:489
        vel=jnp.zeros(2, jnp.float32),
        on_ground=jnp.bool_(False),
        face_forward=jnp.bool_(True),
        anim_t=jnp.float32(0.0),
        mob_pos=level.mob_pos0,
        mob_vx=level.mob_vx0,
        t=jnp.int32(0),
        rng=key,
    )


# ---------------------------------------------------------------------------
# Step (coinrun.cpp:341-391)
# ---------------------------------------------------------------------------

def _mob_substep(patches, mob_pos, mob_vx, alive, active):
    """System_Mob_AI::update (common_systems.cpp:65-105).

    Mob y never changes and x moves <= 0.15 units per env step, so both
    sensors' 3x5 window patches are prefetched once per env step (see
    step()); each sub-step resolve is a 5-wide elementwise selection —
    no grid reads in the sub-step loop at all."""
    patch_wall, patch_ledge, lx0 = patches
    x = mob_pos[:, 0] + mob_vx * DT
    y = mob_pos[:, 1]
    # wall sensor: full vs walls
    wx, _, wcol = resolve_from_patch(
        patch_wall, lx0, _LUT_WALL, x - 0.5, y - 0.6, 1.0, 0.5, WALL_MID
    )
    # floor (ledge) sensor: "collides with empty"
    fx, _, fcol = resolve_from_patch(
        patch_ledge, lx0, _LUT_EMPTY, x - 0.5, y + 0.6, 1.0, 0.5, WALL_MID
    )
    new_x = jnp.where(fcol, fx + 0.5, wx + 0.5)
    new_vx = jnp.where(wcol | fcol, -mob_vx, mob_vx)
    new_pos = jnp.stack([new_x, y], axis=-1)
    upd = (alive & active)[:, None]
    return (
        jnp.where(upd, new_pos, mob_pos),
        jnp.where(alive & active, new_vx, mob_vx),
    )


def _agent_substep(cfg, level, pos, vel, on_ground, face_forward, action):
    """System_Agent::update (common_systems.cpp:121-252)."""
    a = action
    movement_x = (
        ((a == 6) | (a == 7) | (a == 8)).astype(jnp.float32)
        - ((a == 0) | (a == 1) | (a == 2)).astype(jnp.float32)
    )
    jump = (a == 2) | (a == 5) | (a == 8)
    fallthrough = (a == 0) | (a == 3) | (a == 6)

    mix_x = jnp.where(on_ground, MIX, MIX * AIR_CONTROL)
    vx = vel[0] + mix_x * (MAX_SPEED * movement_x - vel[0]) * DT
    vx = jnp.where(jnp.abs(vx) < mix_x * MAX_SPEED * DT, 0.0, vx)
    vy = jnp.where(jump & on_ground, -MAX_JUMP, vel[1])
    vy = vy + GRAVITY * DT
    vy = jnp.clip(vy, -MAX_JUMP, MAX_JUMP)  # common_systems.cpp:166-167

    x = pos[0] + vx * DT
    y = pos[1] + vy * DT

    # Collision box (-0.5, -1, 1, 1) (coinrun.cpp:492)
    rx, ry, col = resolve_tile_collisions(
        level.grid, _LUT_AGENT, x - 0.5, y - 1.0, 1.0, 1.0, WALL_MID,
        fallthrough=fallthrough, step_y=vy * DT,
    )
    dx_moved = rx - (x - 0.5)
    dy_moved = ry - (y - 1.0)
    new_on_ground = (dy_moved < 0.0) & col
    x = rx + 0.5
    y = ry + 1.0
    vx = jnp.where(dx_moved != 0.0, 0.0, vx)
    vy = jnp.where(new_on_ground, 0.0, vy)

    # Hazards: saws + mobs (common_systems.cpp:199-212); agent box 1x1 above
    # feet; saw bounds (-0.5,-0.5,1,1), mob bounds (-0.5,-0.48,1,0.98)
    ax, ay = x - 0.5, y - 1.0
    saw_hit = (
        level.saw_alive
        & check_collision(
            ax, ay, 1.0, 1.0,
            level.saw_pos[:, 0] - 0.5, level.saw_pos[:, 1] - 0.5, 1.0, 1.0,
        )
    ).any()
    dead = saw_hit

    # Lava (common_systems.cpp:215-220)
    _, _, lava = resolve_tile_collisions(
        level.grid, _LUT_LAVA, ax, ay, 1.0, 1.0, WALL_MID
    )
    dead = dead | lava

    # Coin (common_systems.cpp:223-235)
    achieved = check_collision(
        ax, ay, 1.0, 1.0,
        level.coin_pos[0] - 0.5, level.coin_pos[1] - 0.5, 1.0, 1.0,
    )

    face_forward = jnp.where(
        movement_x > 0, True, jnp.where(movement_x < 0, False, face_forward)
    )
    return (
        jnp.stack([x, y]), jnp.stack([vx, vy]), new_on_ground, face_forward,
        dead, achieved,
    )


def step(cfg: Config, state: State, action):
    level = state.level
    a = action.astype(jnp.int32)

    pos, vel = state.pos, state.vel
    on_ground, face_forward = state.on_ground, state.face_forward
    anim_t = state.anim_t
    mob_pos, mob_vx = state.mob_pos, state.mob_vx
    done = jnp.bool_(False)
    reward = jnp.float32(0.0)

    # Mob sensor patches: y is constant all step and x moves <= 0.15
    # units, so fetch both sensors' 3x5 windows once (margin 1 column
    # each side of the start window) instead of per sub-step.
    lx0 = jnp.floor(mob_pos[:, 0] - 0.5).astype(jnp.int32) - 1
    patch_wall = fetch_window_patch(
        level.grid, lx0,
        jnp.floor(mob_pos[:, 1] - 0.6).astype(jnp.int32), WALL_MID,
    )
    patch_ledge = fetch_window_patch(
        level.grid, lx0,
        jnp.floor(mob_pos[:, 1] + 0.6).astype(jnp.int32), WALL_MID,
    )
    patches = (patch_wall, patch_ledge, lx0)

    for _ in range(SUB_STEPS):  # sub-step loop with early exit via masking,
        #                          coinrun.cpp:357-371
        active = ~done
        mob_pos, mob_vx = _mob_substep(patches, mob_pos, mob_vx,
                                       level.mob_alive, active)
        (n_pos, n_vel, n_og, n_ff, dead, achieved) = _agent_substep(
            cfg, level, pos, vel, on_ground, face_forward, a
        )
        # mob contact check after mobs moved (mob_ai updates first,
        # coinrun.cpp:359-360)
        mob_hit = (
            level.mob_alive
            & check_collision(
                n_pos[0] - 0.5, n_pos[1] - 1.0, 1.0, 1.0,
                mob_pos[:, 0] - 0.5, mob_pos[:, 1] - 0.48, 1.0, 0.98,
            )
        ).any()
        dead = dead | mob_hit

        pos = jnp.where(active, n_pos, pos)
        vel = jnp.where(active, n_vel, vel)
        on_ground = jnp.where(active, n_og, on_ground)
        face_forward = jnp.where(active, n_ff, face_forward)
        anim_t = jnp.where(active, jnp.mod(anim_t + 0.1 * DT, 1.0), anim_t)
        reward = jnp.where(active, achieved.astype(jnp.float32) * 10.0, reward)
        done = done | (active & (dead | achieved))

    new_state = State(
        level=level, pos=pos, vel=vel, on_ground=on_ground,
        face_forward=face_forward, anim_t=anim_t,
        mob_pos=mob_pos, mob_vx=mob_vx, t=state.t + 1, rng=state.rng,
    )
    return new_state, reward, done, {}


# ---------------------------------------------------------------------------
# Rendering (coinrun.cpp:443-470)
# ---------------------------------------------------------------------------

def observe(cfg: Config, state: State):
    A = _assets()
    level = state.level
    cam_x = state.pos[0]
    cam_y = state.pos[1] - 0.5  # common_systems.cpp:238-239
    ppu = PPU * (C.OBS / 64.0)  # window renders scale, coinrun.cpp:412
    wx, wy = C.camera_coords(ppu, cam_x, cam_y)

    img = C.clear()
    img = C.draw_background(img, jnp.asarray(A["bgs_p"]), level.bg_index, wx, wy)
    # Tilemap (walls/lava themed per level; crates drawn from variant layer)
    lut = jnp.asarray(A["tile_lut"])[level.theme]
    img = C.draw_tiles(img, level.grid, lut, A["atlas_p"], wx, wy, oob_tile=WALL_MID)
    crate_layer = jnp.where(
        level.grid == CRATE, level.crate_variant.astype(jnp.int32), -1
    )
    img = C.draw_tiles(
        img, crate_layer, jnp.asarray(A["crate_lut"]),
        A["atlas_p"], wx, wy, oob_tile=-1,
    )

    # Saws (z=1, animated every step: anim rate 1.0, tilemap.cpp:61)
    saw_frame = state.t % 2
    saw_sid = jnp.asarray(A["saw_frames"])[saw_frame]
    img = C.draw_sprites(
        img, A["atlas_p"],
        jnp.full(MAX_SAWS, saw_sid),
        level.saw_pos[:, 0] - 0.5, level.saw_pos[:, 1] - 0.5,
        jnp.ones(MAX_SAWS), jnp.ones(MAX_SAWS), wx, wy,
        alives=level.saw_alive,
    )
    # Mobs (anim rate 0.2 -> toggle every 5 steps, tilemap.cpp:85)
    mob_frame = (state.t // 5) % 2
    mob_sid = jnp.asarray(A["enemy_lut"])[level.mob_variant.astype(jnp.int32), mob_frame]
    img = C.draw_sprites(
        img, A["atlas_p"], mob_sid,
        state.mob_pos[:, 0] - 0.5, state.mob_pos[:, 1] - 0.5,
        jnp.ones(MAX_MOBS), jnp.ones(MAX_MOBS), wx, wy,
        flips=state.mob_vx > 0.0,  # common_systems.cpp:100-103
        alives=level.mob_alive,
    )
    # Coin
    img = C.draw_sprite(
        img, A["atlas_p"], A["idx"]["coin"],
        level.coin_pos[0] - 0.5, level.coin_pos[1] - 0.5, 1.0, 1.0, wx, wy,
    )
    # Agent: 1x2 units at (x-0.5, y-2), pose select common_systems.cpp:263-272
    pose = jnp.where(
        ~state.on_ground, 1,
        jnp.where(
            (jnp.abs(state.vel[0]) < 0.01), 0,
            jnp.where(state.anim_t > 0.5, 3, 2),
        ),
    )
    sid = jnp.asarray(A["agent_lut"])[level.agent_theme, pose]
    img = C.draw_sprite(
        img, A["atlas_p"], sid,
        state.pos[0] - 0.5, state.pos[1] - 2.0, 1.0, 2.0, wx, wy,
        flip_x=~state.face_forward,  # common_systems.cpp:276
    )
    return C.finalize(img)


def obs_space(cfg: Config):
    return spaces.Box(0, 255, (C.OBS, C.OBS, 3))


def action_space(cfg: Config):
    return spaces.MultiDiscrete((NUM_ACTIONS,))


# ---------------------------------------------------------------------------
# Batched fast renderer: per-env camera, themed tile stack, culled stamps
# ---------------------------------------------------------------------------

HAZARD_CULL = 16  # joint saw+mob cull: the 13.3-unit visible window holds
#                   at most one 7-wide danger pit plus a few flat-section
#                   hazards (tilemap.cpp:174-257)


@functools.lru_cache(maxsize=None)
def _stamp_banks():
    """Pixel-snapped patch banks (compositor.composite_stamps)."""
    A = atlas_lib
    u = PPU  # 1 world unit in obs pixels (4.8)
    specs = [("saw", u, u), ("saw_move", u, u), ("coin", u, u)]
    for e in A.WALKING_ENEMIES:
        for f in (e, f"{e}_move"):
            specs.append((f, u, u))
            specs.append((f, u, u, 0.0, True))  # flipped
    moving = A.build_pixel_bank(tuple(specs), patch=8)
    aspecs = []
    for th in A.AGENT_THEMES:
        for k in ("stand", "jump", "walk1", "walk2"):
            aspecs.append((f"alien_{th}_{k}", u, 2 * u))
            aspecs.append((f"alien_{th}_{k}", u, 2 * u, 0.0, True))
    agent = A.build_pixel_bank(tuple(aspecs), patch=12)
    return dict(moving=moving, agent=agent)


def _cull(cam_x, pos, alive, var, k):
    """The k alive entities nearest the camera in x: their (pos [N, k, 2],
    alive [N, k], var [N, k]), selected by index so f32 positions pass
    through exactly."""
    score = jnp.where(alive, -jnp.abs(pos[..., 0] - cam_x[:, None]), -1e30)
    _, ids = jax.lax.top_k(score, k)
    return (jnp.take_along_axis(pos, ids[..., None], axis=1),
            jnp.take_along_axis(alive, ids, axis=1),
            jnp.take_along_axis(var, ids, axis=1))


def observe_batch(cfg: Config, states: State):
    """Dispatch: quantized-phase scene renderer at obs resolution (the
    throughput path), exact per-env-camera renderer otherwise (window
    resolution, or `scene_phases=0`)."""
    if C.OBS == 64 and cfg.scene_phases > 0:
        return _observe_scene(cfg, states)
    return _observe_exact(cfg, states)


@functools.lru_cache(maxsize=None)
def _scene_assets(qp):
    """Tile-entry phase bank + padded tile-resolution content textures
    for the quantized-camera scene (render/scene.py)."""
    A = _assets()
    atlas_s = np.asarray(A["atlas_p"]).transpose(1, 0, 2, 3)  # [A, 4, S, S]
    idx = A["idx"]
    texs, kinds, themes = [], [], []
    for t, th in enumerate(atlas_lib.WALL_THEMES):
        texs += [atlas_s[idx[f"wall_top_{th}"]], atlas_s[idx[f"wall_mid_{th}"]]]
        kinds += [WALL_TOP, WALL_MID]
        themes += [t, t]
    texs += [atlas_s[idx["lava_top"]], atlas_s[idx["lava_mid"]]]
    kinds += [LAVA_TOP, LAVA_MID]
    themes += [-1, -1]
    for v, cname in enumerate(atlas_lib.CRATE_TYPES):
        texs.append(atlas_s[np.asarray(A["crate_lut"])[v]])
        # crate cells carry CRATE + 8*variant in the packed kind field
        kinds.append(CRATE + v * 8)
        themes.append(-1)
    bank = phases_lib.tile_phase_bank(np.stack(texs), PPU, 64, qp)
    # backgrounds cover 64 world units with 64 texels (atlas.BG_SIZE), so
    # the bg texel under a pixel is exactly its tile coordinate — the bg
    # is tile-resolution content, window-sliced and phase-expanded like
    # the kind field. Zero padding = out-of-level black (maze.cpp:403-408
    # clip semantics).
    bgs = np.asarray(A["bgs_p"])  # [3, NB, 64, 64] u8
    P = phases_lib.WIN
    bgpad = np.zeros((NUM_BGS, 3, 64 + 2 * P, 64 + 2 * P), np.uint8)
    bgpad[:, :, P:P + 64, P:P + 64] = bgs.transpose(1, 0, 2, 3)
    return dict(bank=bank, kinds=tuple(kinds), themes=tuple(themes),
                bgpad=bgpad)


def _observe_scene(cfg: Config, states: State):
    """Quantized-camera scene path: the render camera snaps to 1/QP world
    units (<= PPU/(2*QP) = 0.6 obs px at QP=4 — render-only; physics is
    untouched), collapsing tile/bg sampling into QP^2 shared phases:
    the tile stack + background become per-pixel selects from a phase
    bank, followed by the stamps (render/phases.py, render/scene.py)."""
    A = _assets()
    banks = _stamp_banks()
    qp = cfg.scene_phases
    SA = _scene_assets(qp)
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

    # --- tile-resolution content windows: packed kind field + bg rgb ---
    packed = jnp.where(
        level.grid == CRATE,
        (CRATE + level.crate_variant.astype(jnp.int32) * 8).astype(jnp.int8),
        level.grid,
    )
    gridp = jnp.pad(packed, ((0, 0), (W, W), (W, W)),
                    constant_values=WALL_MID)  # OOB is wall, tilemap.h:82-87

    # --- stamps (same culls as the exact path, quantized camera) ---
    def pix(centers, P):
        px = (centers[..., 0] - cam_x[:, None]) * PPU + C.OBS / 2
        py = (centers[..., 1] - cam_y[:, None]) * PPU + C.OBS / 2
        return (jnp.round(py - P / 2).astype(jnp.int32),
                jnp.round(px - P / 2).astype(jnp.int32))

    saw_frame = (states.t % 2).astype(jnp.int32)
    mob_frame = ((states.t // 5) % 2).astype(jnp.int32)
    saw_var_full = jnp.broadcast_to(
        saw_frame[:, None], (N, MAX_SAWS)).astype(jnp.int32)
    mob_var_full = (
        3 + level.mob_variant.astype(jnp.int32) * 4
        + mob_frame[:, None] * 2 + (states.mob_vx > 0.0)
    )
    all_pos = jnp.concatenate([level.saw_pos, states.mob_pos], axis=1)
    all_alive = jnp.concatenate([level.saw_alive, level.mob_alive], axis=1)
    all_var = jnp.concatenate([saw_var_full, mob_var_full], axis=1)
    hz_pos, hz_alive, hz_var = _cull(cam_x, all_pos, all_alive, all_var,
                                     HAZARD_CULL)

    coin_var = jnp.full((N, 1), 2, jnp.int32)
    centers = jnp.concatenate([hz_pos, level.coin_pos[:, None, :]], axis=1)
    vars_ = jnp.concatenate([hz_var, coin_var], axis=1)
    scale = jnp.concatenate(
        [hz_alive.astype(jnp.float32), jnp.ones((N, 1), jnp.float32)], axis=1)
    r0, c0 = pix(centers, 8)

    pose = jnp.where(
        ~states.on_ground, 1,
        jnp.where(jnp.abs(states.vel[:, 0]) < 0.01, 0,
                  jnp.where(states.anim_t > 0.5, 3, 2)),
    ).astype(jnp.int32)
    avar = (level.agent_theme.astype(jnp.int32) * 8 + pose * 2
            + (~states.face_forward).astype(jnp.int32))[:, None]
    acenter = jnp.stack(
        [states.pos[:, 0], states.pos[:, 1] - 1.0], axis=-1
    )[:, None, :]
    ar0, ac0 = pix(acenter, 12)

    groups = [
        (C._premultiply_bank(banks["moving"]), vars_, scale, r0, c0),
        (C._premultiply_bank(banks["agent"]), avar,
         jnp.ones((N, 1), jnp.float32), ar0, ac0),
    ]
    img = scene_lib.render_scene(
        gridp, SA["bgpad"], ty0, tx0, jy, jx,
        level.bg_index.astype(jnp.int32), level.theme.astype(jnp.int32),
        SA["bank"], SA["kinds"], SA["themes"], groups, PPU, qp, W)
    return jnp.clip(jnp.round(img), 0, 255).astype(jnp.uint8)


def _observe_exact(cfg: Config, states: State):
    A = _assets()
    banks = _stamp_banks()
    level = states.level
    N = states.pos.shape[0]
    cam_x = states.pos[:, 0]
    cam_y = states.pos[:, 1] - 0.5  # common_systems.cpp:238-239

    c = jnp.arange(C.OBS, dtype=jnp.float32) + 0.5 - C.OBS / 2
    wx_b = cam_x[:, None] + c[None, :] / PPU
    wy_b = cam_y[:, None] + c[None, :] / PPU

    img = C.draw_background_batch(
        jnp.asarray(A["bgs_p"]), level.bg_index.astype(jnp.int32), wx_b, wy_b
    )

    # ---- tile stack: main grid (themed walls + lava) and crate layer ----
    ohy, ohx, ohv, ohu, inb = C.tile_onehots(wx_b, wy_b, WORLD, WORLD)

    def field(grids, oob):
        G = jnp.einsum("nrh,nhw->nrw", ohy, grids.astype(jnp.bfloat16),
                       preferred_element_type=jnp.bfloat16)
        G = jnp.einsum("nrw,nuw->nru", G, ohx,
                       preferred_element_type=jnp.bfloat16)
        return jnp.where(inb, jnp.round(G),
                         jnp.float32(oob)).astype(jnp.int8)[:, None]

    # ONE packed field instead of separate tile-id and crate-variant
    # fields (two one-hot dot pairs -> one): crate cells encode their
    # variant as CRATE + 8*v (5/13/21/29 — distinct from ids 0..4 and
    # bf16-exact; the one-hot rows have a single nonzero so the dot
    # reproduces the packed value exactly).
    packed = jnp.where(
        level.grid == CRATE,
        (CRATE + level.crate_variant.astype(jnp.int32) * 8).astype(jnp.int8),
        level.grid,
    )
    G = field(packed, WALL_MID)

    atlas_s = jnp.asarray(A["atlas_p"]).transpose(1, 0, 2, 3)  # [A, 4, S, S]
    tl = jnp.asarray(A["tile_lut"])  # [themes, ids]
    th = level.theme.astype(jnp.int32)

    # themed kinds (per-env texture row gathers)
    themed = [atlas_s[tl[th, WALL_TOP]], atlas_s[tl[th, WALL_MID]]]

    # shared kinds: lava pair + 4 crate types
    shared_sids = [A["idx"]["lava_top"], A["idx"]["lava_mid"]] + list(
        np.asarray(A["crate_lut"])
    )
    shared = atlas_s[jnp.asarray(shared_sids)].astype(jnp.bfloat16)

    inv = jnp.bfloat16(1 / 255.0)

    # Kind-at-a-time sampling, BOTH stages, fused with the blend: a
    # monolithic [N, K, 4, OBS, OBS] einsum materializes K frames, and a
    # shared batched first stage [N, K, 4, OBS, S] can force a relayout
    # copy of every per-kind slice before its second-stage dot;
    # producing each kind's rows immediately before its dot lets XLA
    # assign agreeing layouts.
    def blend_kind(img, mask, tex_k):
        if tex_k.ndim == 4:  # [N, 4, S, S] per-env themed texture
            rows_k = jnp.einsum("nrh,nchw->ncrw", ohv,
                                tex_k.astype(jnp.bfloat16),
                                preferred_element_type=jnp.bfloat16)
        else:  # [4, S, S] shared texture
            rows_k = jnp.einsum("nrh,chw->ncrw", ohv,
                                tex_k.astype(jnp.bfloat16),
                                preferred_element_type=jnp.bfloat16)
        kimg = jnp.einsum("ncrw,nuw->ncru", rows_k, ohu,
                          preferred_element_type=jnp.bfloat16)
        a = mask.astype(jnp.bfloat16) * (kimg[:, 3:4] * inv)
        return img + a * (kimg[:, :3] - img)

    img = blend_kind(img, G == WALL_TOP, themed[0])
    img = blend_kind(img, G == WALL_MID, themed[1])
    img = blend_kind(img, G == LAVA_TOP, shared[0])
    img = blend_kind(img, G == LAVA_MID, shared[1])
    for v in range(4):
        img = blend_kind(img, G == CRATE + v * 8, shared[2 + v])

    # ---- moving stamps: saws + coin + culled mobs ----
    def pix(centers, P):
        px = (centers[..., 0] - cam_x[:, None]) * PPU + C.OBS / 2
        py = (centers[..., 1] - cam_y[:, None]) * PPU + C.OBS / 2
        return (jnp.round(py - P / 2).astype(jnp.int32),
                jnp.round(px - P / 2).astype(jnp.int32))

    # Joint saw+mob cull: the visible window spans 13.3 units, a level
    # holds at most one 7-wide danger pit (tilemap.cpp:201-209) plus
    # scattered single flat-section hazards, so 16 joint slots always
    # cover the on-screen set — and the stamp cost scales with the slot
    # count (the separate 12+12 culls carried 8 always-dead slots).
    saw_frame = (states.t % 2).astype(jnp.int32)  # anim rate 1.0
    mob_frame = ((states.t // 5) % 2).astype(jnp.int32)  # anim rate 0.2
    saw_var_full = jnp.broadcast_to(
        saw_frame[:, None], (N, MAX_SAWS)).astype(jnp.int32)
    mob_var_full = (
        3 + level.mob_variant.astype(jnp.int32) * 4
        + mob_frame[:, None] * 2 + (states.mob_vx > 0.0)
    )
    all_pos = jnp.concatenate([level.saw_pos, states.mob_pos], axis=1)
    all_alive = jnp.concatenate([level.saw_alive, level.mob_alive], axis=1)
    all_var = jnp.concatenate([saw_var_full, mob_var_full], axis=1)

    hz_pos, hz_alive, hz_var = _cull(cam_x, all_pos, all_alive, all_var,
                                     HAZARD_CULL)

    # slot order follows observe's draw order: hazards first, coin last
    # (observe draws saws, mobs, then the coin)
    coin_var = jnp.full((N, 1), 2, jnp.int32)
    centers = jnp.concatenate([hz_pos, level.coin_pos[:, None, :]], axis=1)
    vars_ = jnp.concatenate([hz_var, coin_var], axis=1)
    alives = jnp.concatenate([hz_alive, jnp.ones((N, 1), bool)], axis=1)
    r0, c0 = pix(centers, 8)
    img = C.composite_stamps(img, banks["moving"], vars_, r0, c0,
                             alives=alives)

    # ---- agent (1x2 units; center is pos - (0, 1)) ----
    pose = jnp.where(
        ~states.on_ground, 1,
        jnp.where(jnp.abs(states.vel[:, 0]) < 0.01, 0,
                  jnp.where(states.anim_t > 0.5, 3, 2)),
    ).astype(jnp.int32)
    avar = (level.agent_theme.astype(jnp.int32) * 8 + pose * 2
            + (~states.face_forward).astype(jnp.int32))[:, None]
    acenter = jnp.stack(
        [states.pos[:, 0], states.pos[:, 1] - 1.0], axis=-1
    )[:, None, :]
    r0, c0 = pix(acenter, 12)
    img = C.composite_stamps(img, banks["agent"], avar, r0, c0)

    obs = jnp.clip(jnp.round(img), 0, 255).astype(jnp.uint8)
    return obs  # planar u8 [N, 3, OBS, OBS]; layout applied by the Environment
