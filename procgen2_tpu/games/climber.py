"""Climber: vertical platformer — climb platforms, collect crystals.

JAX re-implementation of the reference's `games/climber/`:
  * level generation — 20x64 vertical world, difficulty-scaled platform
    ladder walked upward with physics-bounded dy, crystals on ~50% of
    platforms (always the topmost), flying patrol enemies
    (tilemap.cpp:75-172);
  * platformer physics — same core as coinrun (velocity mixing, jump,
    gravity, fall clamp, two-pass tile collision; walls only, no crates)
    (common_systems.cpp:184-269);
  * flying-mob AI — horizontal patrol +-4 tiles around spawn_x, rebound on
    wall or patrol end (common_systems.cpp:109-168, patrol_range
    common_systems.h:53);
  * points — +1 per crystal, +10 on collecting all; terminate on enemy
    contact or completion (climber.cpp:339-355). Reward is recomputed each
    of the 4 sub-steps last-write-wins with early exit on terminal,
    reproducing climber.cpp:339-355 faithfully (a crystal collected in a
    non-final sub-step scores only via num_points_collected, not reward —
    a reference quirk we keep). The stray debug print at climber.cpp:357 is
    (obviously) not reproduced.
  * camera: x fixed at map-center, y follows agent - 8.5 units
    (climber.cpp:464, common_systems.cpp:259); zoom 0.2 (climber.cpp:32).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from ..core import spaces
from ..physics.tiles import resolve_tile_collisions, NONE, FULL
from ..physics.aabb import check_collision
from ..render import atlas as atlas_lib
from ..render import compositor as C
from ..render import phases as phases_lib
from ..render import scene as scene_lib

NAME = "climber"
NUM_ACTIONS = 15
MAP_W = 20  # tilemap.cpp:76
MAP_H = 64  # tilemap.cpp:77
SUB_STEPS = 4  # climber.cpp:44
DT = 1.0 / SUB_STEPS
ZOOM = 0.2  # climber.cpp:32
PPU = 16.0 * ZOOM

EMPTY, WALL_TOP, WALL_MID = 0, 1, 2  # tilemap.h Tile_ID order
NUM_TILE_IDS = 3

# Agent physics (common_systems.cpp:185-190) — identical to coinrun's
MAX_JUMP = 1.55
GRAVITY = 0.2
MAX_SPEED = 0.5
MIX = 0.2
AIR_CONTROL = 0.15
PATROL_RANGE = 4.0  # common_systems.h:53

# Generation bound (tilemap.cpp:79-80,120-123: gen max_jump=1.5):
# max_dy = int(1.5^2 / (2*0.2) - 0.5) = 5; init_y_dist(3, max_dy-1)
GEN_MAX_DY = 5

MAX_PLATFORMS = 17  # (3+1)^2 + 1, tilemap.cpp:103-104
MAX_CAND = 11  # platform length 2..11, tilemap.cpp:139-140
MAX_MOBS = MAX_PLATFORMS
MAX_POINTS = MAX_PLATFORMS

NUM_BGS = 49  # climber.cpp:58-108
NUM_TILE_THEMES = len(atlas_lib.CLIMBER_TILE_THEMES)  # 4, tilemap.cpp:10-18
NUM_AGENT_THEMES = len(atlas_lib.CLIMBER_AGENT_THEMES)  # common_systems.h:61

_LUT_WALL = np.array([NONE, FULL, FULL], np.int32)
#   common_systems.cpp:138-140 / 235-237: wall_mid|wall_top full, else none


@dataclasses.dataclass(frozen=True)
class Config:
    easy_mode: bool = False  # enemy_prob .2 vs .5, tilemap.cpp:118
    # Render-only camera phase quantization for the scene compositor
    # (render/phases.py); 0 = exact continuous camera (slow path).
    scene_phases: int = 4


@struct.dataclass
class Level:
    grid: jnp.ndarray  # int8 [MAP_H, MAP_W] render coords [y, x]
    mob_pos0: jnp.ndarray  # f32 [MAX_MOBS, 2]
    mob_spawn_x: jnp.ndarray  # f32 [MAX_MOBS] patrol anchor (tile x)
    mob_vx0: jnp.ndarray  # f32 [MAX_MOBS]
    mob_alive: jnp.ndarray  # bool [MAX_MOBS]
    point_pos: jnp.ndarray  # f32 [MAX_POINTS, 2]
    point_exists: jnp.ndarray  # bool [MAX_POINTS]
    theme: jnp.ndarray  # i32 tile theme (0..3)
    agent_theme: jnp.ndarray  # i32
    bg_index: jnp.ndarray  # i32
    difficulty: jnp.ndarray  # i32


@struct.dataclass
class State:
    level: Level
    pos: jnp.ndarray  # f32 [2]
    vel: jnp.ndarray  # f32 [2]
    on_ground: jnp.ndarray  # bool
    face_forward: jnp.ndarray  # bool
    anim_t: jnp.ndarray  # f32 (agent.t, rate 0.1 — common_components.h:61)
    mob_pos: jnp.ndarray  # f32 [MAX_MOBS, 2]
    mob_vx: jnp.ndarray  # f32 [MAX_MOBS]
    point_taken: jnp.ndarray  # bool [MAX_POINTS]
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
    names += ["crystal", "swimmer", "swimmer_move"]
    for th in atlas_lib.CLIMBER_AGENT_THEMES:
        names += [f"climber_{th}_{k}" for k in ("stand", "jump", "walk1", "walk2")]
    atlas, idx = atlas_lib.build_atlas(tuple(names))
    bgs = atlas_lib.build_backgrounds("sky", NUM_BGS)

    tile_lut = np.full((NUM_TILE_THEMES, NUM_TILE_IDS), -1, np.int32)
    for t, th in enumerate(atlas_lib.CLIMBER_TILE_THEMES):
        tile_lut[t, WALL_TOP] = idx[f"ctile_top_{th}"]
        tile_lut[t, WALL_MID] = idx[f"ctile_mid_{th}"]
    swim_frames = np.array([idx["swimmer"], idx["swimmer_move"]], np.int32)
    agent_lut = np.array(
        [
            [idx[f"climber_{th}_{k}"] for k in ("stand", "jump", "walk1", "walk2")]
            for th in atlas_lib.CLIMBER_AGENT_THEMES
        ],
        np.int32,
    )
    return dict(
        atlas_p=atlas.transpose(3, 0, 1, 2),
        idx=idx,
        bgs_p=bgs.transpose(3, 0, 1, 2),
        tile_lut=tile_lut,
        swim_frames=swim_frames,
        agent_lut=agent_lut,
    )


# ---------------------------------------------------------------------------
# Generation (tilemap.cpp:75-172)
# ---------------------------------------------------------------------------

def _ry(y_up):
    """y-up tile coord -> render-unit center y (tilemap.cpp:45,64)."""
    return MAP_H - 1.0 - y_up + 0.5


def generate(cfg: Config, key) -> Level:
    k_diff, k_nplat, k_x0, k_loop, k_theme, k_ag, k_bg = jax.random.split(key, 7)

    # Border walls + floor (tilemap.cpp:90-93); grid held [x, y_up] during
    # gen, flipped to render coords at the end.
    grid = jnp.zeros((MAP_W, MAP_H), jnp.int8)
    xs = jnp.arange(MAP_W)[:, None]
    ys = jnp.arange(MAP_H)[None, :]
    grid = jnp.where((xs == 0) | (xs == MAP_W - 1) | (ys == MAP_H - 1), WALL_MID, grid)
    grid = jnp.where((ys == 0), WALL_TOP, grid)  # set_area_with_top h=1 -> top

    difficulty = jax.random.randint(k_diff, (), 1, 4)  # tilemap.cpp:99-101
    min_p = difficulty * difficulty + 1
    max_p = (difficulty + 1) * (difficulty + 1) + 1
    num_platforms = jax.random.randint(k_nplat, (), min_p, max_p + 1)

    curr_x = jax.random.randint(k_x0, (), 2, MAP_W - 2)  # init_x_dist(2, 17)
    curr_y = jnp.int32(1)
    enemy_prob = 0.2 if cfg.easy_mode else 0.5  # tilemap.cpp:118

    mob_pos = jnp.zeros((MAX_MOBS, 2), jnp.float32)
    mob_sx = jnp.zeros(MAX_MOBS, jnp.float32)
    mob_vx = jnp.zeros(MAX_MOBS, jnp.float32)
    mob_n = jnp.int32(0)
    pt_pos = jnp.zeros((MAX_POINTS, 2), jnp.float32)
    pt_n = jnp.int32(0)

    def body(i, carry):
        (grid, curr_x, curr_y, mob_pos, mob_sx, mob_vx, mob_n,
         pt_pos, pt_n, key) = carry
        key, k_dy, k_es, k_ey, k_ev, k_len, k_vx, k_pt, k_px, k_nx = (
            jax.random.split(key, 10)
        )
        act = i < num_platforms

        delta_y = jax.random.randint(k_dy, (), 3, GEN_MAX_DY)  # init_y_dist(3,4)

        # Enemy spawn at the *pre-advance* height (tilemap.cpp:131-135)
        can_spawn = (curr_x >= 3) & (curr_x <= MAP_W - 4)
        do_mob = act & can_spawn & (jax.random.uniform(k_es) < enemy_prob)
        mob_y = curr_y + jax.random.randint(k_ey, (), 0, 2) + 2
        mpos = jnp.stack([curr_x + 0.5, _ry(mob_y)])
        mvx = 0.15 * (jax.random.randint(k_ev, (), 0, 2) * 2 - 1).astype(jnp.float32)
        mob_pos = mob_pos.at[mob_n].set(jnp.where(do_mob, mpos, mob_pos[mob_n]))
        mob_sx = mob_sx.at[mob_n].set(
            jnp.where(do_mob, curr_x.astype(jnp.float32), mob_sx[mob_n])
        )
        mob_vx = mob_vx.at[mob_n].set(jnp.where(do_mob, mvx, mob_vx[mob_n]))
        mob_n = mob_n + do_mob.astype(jnp.int32)

        curr_y = jnp.where(act, curr_y + delta_y, curr_y)

        plat_len = 2 + jax.random.randint(k_len, (), 0, 10)  # tilemap.cpp:139-140
        vx = jax.random.randint(k_vx, (), 0, 2) * 2 - 1
        vx = jnp.where(curr_x < 3, 1, jnp.where(curr_x > MAP_W - 3, -1, vx))

        # Candidate cells nx_j = curr_x + (j+1)*vx while strictly inside
        # (tilemap.cpp:149-158). nx is monotonic in j so the in-bounds test
        # is exactly the loop-break prefix.
        j = jnp.arange(MAX_CAND)
        nx = curr_x + (j + 1) * vx
        valid = (j < plat_len) & (nx > 0) & (nx < MAP_W - 1)
        n_cand = valid.sum()

        # Platform tiles: wall_top at (nx, curr_y), OOB-y writes dropped
        # (tilemap.h set() guard; curr_y can exceed the map for high
        # platform counts).
        put = valid & act & (curr_y < MAP_H)
        grid = grid.at[jnp.clip(nx, 0, MAP_W - 1), jnp.clip(curr_y, 0, MAP_H - 1)].set(
            jnp.where(put, jnp.int8(WALL_TOP),
                      grid[jnp.clip(nx, 0, MAP_W - 1), jnp.clip(curr_y, 0, MAP_H - 1)]),
        )

        # Crystal with p=.5, always on the final platform (tilemap.cpp:163-165)
        is_last = i == (num_platforms - 1)
        do_pt = act & ((jax.random.uniform(k_pt) < 0.5) | is_last)
        pt_i = jax.random.randint(k_px, (), 0, jnp.maximum(n_cand, 1))
        pt_x = nx[jnp.clip(pt_i, 0, MAX_CAND - 1)]
        ppos = jnp.stack([pt_x + 0.5, _ry(curr_y + 1)])
        pt_pos = pt_pos.at[pt_n].set(jnp.where(do_pt, ppos, pt_pos[pt_n]))
        pt_n = pt_n + do_pt.astype(jnp.int32)

        #

        nxt_i = jax.random.randint(k_nx, (), 0, jnp.maximum(n_cand, 1))
        curr_x = jnp.where(act, nx[jnp.clip(nxt_i, 0, MAX_CAND - 1)], curr_x)
        return (grid, curr_x, curr_y, mob_pos, mob_sx, mob_vx, mob_n,
                pt_pos, pt_n, key)

    carry = (grid, curr_x, curr_y, mob_pos, mob_sx, mob_vx, mob_n,
             pt_pos, pt_n, k_loop)
    carry = jax.lax.fori_loop(0, MAX_PLATFORMS, body, carry)
    (grid, curr_x, curr_y, mob_pos, mob_sx, mob_vx, mob_n, pt_pos, pt_n, _) = carry

    # [x, y_up] -> render rows [ry, x]
    grid_r = jnp.flip(grid.T, axis=0)
    return Level(
        grid=grid_r,
        mob_pos0=mob_pos,
        mob_spawn_x=mob_sx,
        mob_vx0=mob_vx,
        mob_alive=jnp.arange(MAX_MOBS) < mob_n,
        point_pos=pt_pos,
        point_exists=jnp.arange(MAX_POINTS) < pt_n,
        theme=jax.random.randint(k_theme, (), 0, NUM_TILE_THEMES),  # climber.cpp:490-492
        agent_theme=jax.random.randint(k_ag, (), 0, NUM_AGENT_THEMES),
        bg_index=jax.random.randint(k_bg, (), 0, NUM_BGS),
        difficulty=difficulty,
    )


def reset(cfg: Config, level: Level, key) -> State:
    return State(
        level=level,
        pos=jnp.array([1.5, MAP_H - 1.0], jnp.float32),  # climber.cpp:478
        vel=jnp.zeros(2, jnp.float32),
        on_ground=jnp.bool_(False),
        face_forward=jnp.bool_(True),
        anim_t=jnp.float32(0.0),
        mob_pos=level.mob_pos0,
        mob_vx=level.mob_vx0,
        point_taken=jnp.zeros(MAX_POINTS, bool),
        t=jnp.int32(0),
        rng=key,
    )


# ---------------------------------------------------------------------------
# Step (climber.cpp:323-376)
# ---------------------------------------------------------------------------

def _agent_substep(level, pos, vel, on_ground, face_forward, anim_t, action):
    """System_Agent::update (common_systems.cpp:184-269)."""
    a = action
    movement_x = (
        ((a == 6) | (a == 7) | (a == 8)).astype(jnp.float32)
        - ((a == 0) | (a == 1) | (a == 2)).astype(jnp.float32)
    )
    jump = (a == 2) | (a == 5) | (a == 8)

    mix_x = jnp.where(on_ground, MIX, MIX * AIR_CONTROL)
    vx = vel[0] + mix_x * (MAX_SPEED * movement_x - vel[0]) * DT
    vx = jnp.where(jnp.abs(vx) < mix_x * MAX_SPEED * DT, 0.0, vx)
    vy = jnp.where(jump & on_ground, -MAX_JUMP, vel[1])
    vy = vy + GRAVITY * DT
    vy = jnp.clip(vy, -MAX_JUMP, MAX_JUMP)

    x = pos[0] + vx * DT
    y = pos[1] + vy * DT

    # Collision bounds (-0.5, -1, 1, 1) (climber.cpp:481)
    rx, ry, col = resolve_tile_collisions(
        level.grid, _LUT_WALL, x - 0.5, y - 1.0, 1.0, 1.0, WALL_MID
    )
    dx_moved = rx - (x - 0.5)
    dy_moved = ry - (y - 1.0)
    new_on_ground = (dy_moved < 0.0) & col
    x = rx + 0.5
    y = ry + 1.0
    vx = jnp.where(dx_moved != 0.0, 0.0, vx)
    vy = jnp.where(new_on_ground, 0.0, vy)

    anim_t = jnp.mod(anim_t + 0.1 * DT, 1.0)  # common_systems.cpp:262-263
    face_forward = jnp.where(
        movement_x > 0, True, jnp.where(movement_x < 0, False, face_forward)
    )
    return jnp.stack([x, y]), jnp.stack([vx, vy]), new_on_ground, face_forward, anim_t


def _mob_substep(level, mob_pos, mob_vx, agent_pos):
    """System_Mob_AI::update (common_systems.cpp:109-168). Returns hit flag."""

    def one(p, vx, sx):
        x = p[0] + vx * DT
        y = p[1]
        rx, _, wcol = resolve_tile_collisions(
            level.grid, _LUT_WALL, x - 0.5, y - 0.6, 1.0, 0.5, WALL_MID
        )
        new_x = rx + 0.5
        end_patrol = (new_x > sx + PATROL_RANGE) | (new_x < sx - PATROL_RANGE)
        new_vx = jnp.where(wcol | end_patrol, -vx, vx)
        return jnp.stack([new_x, y]), new_vx

    new_pos, new_vx = jax.vmap(one)(mob_pos, mob_vx, level.mob_spawn_x)
    alive = level.mob_alive
    new_pos = jnp.where(alive[:, None], new_pos, mob_pos)
    new_vx = jnp.where(alive, new_vx, mob_vx)

    # Contact test vs agent rect (-0.5,-1,1,1)+pos against mob bounds
    # (-0.4,-0.4,0.8,0.8)+pos (tilemap.cpp:55, common_systems.cpp:146-153)
    hit = (
        alive
        & check_collision(
            agent_pos[0] - 0.5, agent_pos[1] - 1.0, 1.0, 1.0,
            new_pos[:, 0] - 0.4, new_pos[:, 1] - 0.4, 0.8, 0.8,
        )
    ).any()
    return new_pos, new_vx, hit


def step(cfg: Config, state: State, action):
    level = state.level
    a = action.astype(jnp.int32)

    pos, vel = state.pos, state.vel
    on_ground, face_forward = state.on_ground, state.face_forward
    anim_t = state.anim_t
    mob_pos, mob_vx = state.mob_pos, state.mob_vx
    taken = state.point_taken
    done = jnp.bool_(False)
    reward = jnp.float32(0.0)

    for _ in range(SUB_STEPS):  # climber.cpp:339-355, break on terminal
        active = ~done
        n_pos, n_vel, n_og, n_ff, n_anim = _agent_substep(
            level, pos, vel, on_ground, face_forward, anim_t, a
        )
        n_mob_pos, n_mob_vx, dead = _mob_substep(level, mob_pos, mob_vx, n_pos)

        # System_Point::update (common_systems.cpp:66-107): 1x1 crystal rects
        # vs the agent rect; collect, count remaining.
        live_pts = level.point_exists & ~taken
        got = live_pts & check_collision(
            n_pos[0] - 0.5, n_pos[1] - 1.0, 1.0, 1.0,
            level.point_pos[:, 0] - 0.5, level.point_pos[:, 1] - 0.5, 1.0, 1.0,
        )
        point_delta = got.sum().astype(jnp.float32)
        n_taken = taken | got
        available = (level.point_exists & ~n_taken).sum()
        sub_reward = point_delta + (available == 0) * 10.0  # climber.cpp:348

        pos = jnp.where(active, n_pos, pos)
        vel = jnp.where(active, n_vel, vel)
        on_ground = jnp.where(active, n_og, on_ground)
        face_forward = jnp.where(active, n_ff, face_forward)
        anim_t = jnp.where(active, n_anim, anim_t)
        mob_pos = jnp.where(active, n_mob_pos, mob_pos)
        mob_vx = jnp.where(active, n_mob_vx, mob_vx)
        taken = jnp.where(active, n_taken, taken)
        reward = jnp.where(active, sub_reward, reward)  # last-write-wins
        done = done | (active & (dead | (available == 0)))

    new_state = State(
        level=level, pos=pos, vel=vel, on_ground=on_ground,
        face_forward=face_forward, anim_t=anim_t,
        mob_pos=mob_pos, mob_vx=mob_vx, point_taken=taken,
        t=state.t + 1, rng=state.rng,
    )
    return new_state, reward, done, {}


# ---------------------------------------------------------------------------
# Rendering (climber.cpp:431-457)
# ---------------------------------------------------------------------------

def observe(cfg: Config, state: State):
    A = _assets()
    level = state.level
    cam_x = jnp.float32(MAP_W / 2.0)  # climber.cpp:464
    cam_y = state.pos[1] - 8.5  # common_systems.cpp:259
    ppu = PPU * (C.OBS / 64.0)  # window renders scale (render_game)
    wx, wy = C.camera_coords(ppu, cam_x, cam_y)

    img = C.clear()
    img = C.draw_background(img, jnp.asarray(A["bgs_p"]), level.bg_index, wx, wy)
    lut = jnp.asarray(A["tile_lut"])[level.theme]
    img = C.draw_tiles(img, level.grid, lut, A["atlas_p"], wx, wy,
                       oob_tile=WALL_MID)  # tilemap.h:66-69: OOB is wall

    # Crystals (z=1, offset (-0.5,-0.5), 1x1 — tilemap.cpp:68-69)
    live = level.point_exists & ~state.point_taken
    img = C.draw_sprites(
        img, A["atlas_p"],
        jnp.full(MAX_POINTS, A["idx"]["crystal"]),
        level.point_pos[:, 0] - 0.5, level.point_pos[:, 1] - 0.5,
        jnp.ones(MAX_POINTS), jnp.ones(MAX_POINTS), wx, wy,
        alives=live,
    )
    # Swimming mobs (offset (-0.4,-0.4), anim rate 0.2 — tilemap.cpp:47-54)
    mob_frame = (state.t // 5) % 2
    mob_sid = jnp.asarray(A["swim_frames"])[mob_frame]
    img = C.draw_sprites(
        img, A["atlas_p"], jnp.full(MAX_MOBS, mob_sid),
        state.mob_pos[:, 0] - 0.4, state.mob_pos[:, 1] - 0.4,
        jnp.ones(MAX_MOBS), jnp.ones(MAX_MOBS), wx, wy,
        flips=state.mob_vx < 0.0,  # common_systems.cpp:164
        alives=level.mob_alive,
    )
    # Agent: scale 0.8 at (x-0.5, y-1) (common_systems.cpp:292-294)
    pose = jnp.where(
        (jnp.abs(state.vel[0]) < 0.01) & state.on_ground, 0,
        jnp.where(~state.on_ground, 1, jnp.where(state.anim_t > 0.5, 3, 2)),
    )
    sid = jnp.asarray(A["agent_lut"])[level.agent_theme, pose]
    img = C.draw_sprite(
        img, A["atlas_p"], sid,
        state.pos[0] - 0.5, state.pos[1] - 1.0, 0.8, 1.1, wx, wy,
        flip_x=~state.face_forward,
    )
    return C.finalize(img)


def obs_space(cfg: Config):
    return spaces.Box(0, 255, (C.OBS, C.OBS, 3))


def action_space(cfg: Config):
    return spaces.MultiDiscrete((NUM_ACTIONS,))

# ---------------------------------------------------------------------------
# Batched fast renderer: per-env y camera, themed tile stack, pixel stamps
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _stamp_banks():
    """Pixel-snapped patch banks (compositor.composite_stamps)."""
    A = atlas_lib
    u = PPU  # 1 world unit in obs pixels (3.2 at zoom 0.2)
    specs = [("crystal", u, u)]
    for f in ("swimmer", "swimmer_move"):
        specs.append((f, u, u))
        specs.append((f, u, u, 0.0, True))  # flipped
    moving = A.build_pixel_bank(tuple(specs), patch=8)
    aspecs = []
    for th in A.CLIMBER_AGENT_THEMES:
        for k in ("stand", "jump", "walk1", "walk2"):
            # 0.8 x 1.1 units (common_systems.cpp:292-294)
            aspecs.append((f"climber_{th}_{k}", 0.8 * u, 1.1 * u))
            aspecs.append((f"climber_{th}_{k}", 0.8 * u, 1.1 * u, 0.0, True))
    agent = A.build_pixel_bank(tuple(aspecs), patch=8)
    return dict(moving=moving, agent=agent)


@functools.lru_cache(maxsize=None)
def _scene_assets(qp):
    """Tile-entry phase bank + padded content for the quantized-camera
    scene (render/scene.py; see coinrun._scene_assets). The
    0.2-zoom camera shows ~20 tiles, so the window span comes from
    phases.win (21 at qp=4) rather than the default 16."""
    A = _assets()
    atlas_s = np.asarray(A["atlas_p"]).transpose(1, 0, 2, 3)
    idx = A["idx"]
    texs, kinds, themes = [], [], []
    for t, th in enumerate(atlas_lib.CLIMBER_TILE_THEMES):
        texs += [atlas_s[idx[f"ctile_top_{th}"]],
                 atlas_s[idx[f"ctile_mid_{th}"]]]
        kinds += [WALL_TOP, WALL_MID]
        themes += [t, t]
    bank = phases_lib.tile_phase_bank(np.stack(texs), PPU, 64, qp)
    W = phases_lib.win(PPU, 64, qp)
    GP = MAP_H + 2 * W  # square pad covers the tall axis; x never OOB
    bgs = np.asarray(A["bgs_p"])  # [3, NB, 64, 64]
    bgpad = np.zeros((NUM_BGS, 3, GP, GP), np.uint8)
    n = min(64, GP - W)
    bgpad[:, :, W:W + n, W:W + n] = bgs.transpose(1, 0, 2, 3)[:, :, :n, :n]
    return dict(bank=bank, kinds=tuple(kinds), themes=tuple(themes),
                bgpad=bgpad, win=W)


def _observe_scene(cfg: Config, states: State):
    """Quantized-camera scene path (see coinrun._observe_scene): bg +
    themed walls + one merged crystal/mob/agent stamp group in a single
    scene pass. The x camera is FIXED at map center (climber.cpp:464),
    so only the y phase varies per env."""
    A = _assets()
    banks = _stamp_banks()
    qp = cfg.scene_phases
    SA = _scene_assets(qp)
    level = states.level
    N = states.pos.shape[0]
    W = SA["win"]

    cam_x = jnp.full((N,), MAP_W / 2.0, jnp.float32)  # climber.cpp:464
    my = jnp.round((states.pos[:, 1] - 8.5) * qp).astype(jnp.int32)
    cam_y = my.astype(jnp.float32) / qp
    mx = jnp.round(cam_x * qp).astype(jnp.int32)
    jx = jnp.mod(mx, qp)
    jy = jnp.mod(my, qp)
    _, _, t0_off = phases_lib.phase_tables(PPU, 64, qp)
    tx0 = jnp.floor(cam_x + jnp.float32(t0_off)).astype(jnp.int32)
    ty0 = jnp.floor(cam_y + jnp.float32(t0_off)).astype(jnp.int32)

    GP = MAP_H + 2 * W
    gridp = jnp.pad(
        level.grid, ((0, 0), (W, W), (W, GP - W - MAP_W)),
        constant_values=WALL_MID)  # tilemap.h:66-69: OOB is wall

    def pix(centers, P):
        px = (centers[..., 0] - cam_x[:, None]) * PPU + C.OBS / 2
        py = (centers[..., 1] - cam_y[:, None]) * PPU + C.OBS / 2
        return (jnp.round(py - P / 2).astype(jnp.int32),
                jnp.round(px - P / 2).astype(jnp.int32))

    live = level.point_exists & ~states.point_taken
    mob_frame = ((states.t // 5) % 2).astype(jnp.int32)
    mob_flip = (states.mob_vx < 0.0).astype(jnp.int32)
    mob_var = 1 + mob_frame[:, None] * 2 + mob_flip
    crys_var = jnp.zeros((N, MAX_POINTS), jnp.int32)
    pose = jnp.where(
        (jnp.abs(states.vel[:, 0]) < 0.01) & states.on_ground, 0,
        jnp.where(~states.on_ground, 1,
                  jnp.where(states.anim_t > 0.5, 3, 2)),
    ).astype(jnp.int32)
    n_mv = banks["moving"].shape[0]
    avar = (n_mv + level.agent_theme.astype(jnp.int32) * 8 + pose * 2
            + (~states.face_forward).astype(jnp.int32))[:, None]
    acenter = jnp.stack(
        [states.pos[:, 0] - 0.1, states.pos[:, 1] - 0.45], axis=-1
    )[:, None, :]
    centers = jnp.concatenate(
        [level.point_pos, states.mob_pos + 0.1, acenter], axis=1)
    vars_ = jnp.concatenate([crys_var, mob_var, avar], axis=1)
    alives = jnp.concatenate(
        [live, level.mob_alive, jnp.ones((N, 1), bool)], axis=1)
    r0, c0 = pix(centers, 8)

    merged_bank = np.concatenate(
        [np.asarray(banks["moving"]), np.asarray(banks["agent"])], axis=0)
    groups = [(C._premultiply_bank(merged_bank), vars_,
               alives.astype(jnp.float32), r0, c0)]
    img = scene_lib.render_scene(
        gridp, SA["bgpad"], ty0, tx0, jy, jx,
        level.bg_index.astype(jnp.int32), level.theme.astype(jnp.int32),
        SA["bank"], SA["kinds"], SA["themes"], groups, PPU, qp, W)
    return jnp.clip(jnp.round(img), 0, 255).astype(jnp.uint8)


def observe_batch(cfg: Config, states: State):
    """Batched renderer: same scene as `observe` via the scene
    compositor at obs resolution (quantized render camera), or shared
    batched matmuls + pixel-snapped stamps otherwise. Differences vs the
    per-env path are stamp pixel snapping (<=1 px), additive blending of
    overlapping stamps, and the <= 0.6 px camera quantization.
    """
    if C.OBS == 64 and cfg.scene_phases > 0:
        return _observe_scene(cfg, states)
    return _observe_exact(cfg, states)


def _observe_exact(cfg: Config, states: State):
    A = _assets()
    banks = _stamp_banks()
    level = states.level
    N = states.pos.shape[0]
    cam_x = jnp.full((N,), MAP_W / 2.0, jnp.float32)  # climber.cpp:464
    cam_y = states.pos[:, 1] - 8.5  # common_systems.cpp:259

    c = jnp.arange(C.OBS, dtype=jnp.float32) + 0.5 - C.OBS / 2
    wx_b = cam_x[:, None] + c[None, :] / PPU
    wy_b = cam_y[:, None] + c[None, :] / PPU

    img = C.draw_background_batch(
        jnp.asarray(A["bgs_p"]), level.bg_index.astype(jnp.int32), wx_b, wy_b
    )

    # ---- themed wall tiles (per-env texture rows, shared sampling) ----
    ohy, ohx, ohv, ohu, inb = C.tile_onehots(wx_b, wy_b, MAP_H, MAP_W)
    G = jnp.einsum("nrh,nhw->nrw", ohy, level.grid.astype(jnp.bfloat16),
                   preferred_element_type=jnp.bfloat16)
    G = jnp.einsum("nrw,nuw->nru", G, ohx,
                   preferred_element_type=jnp.bfloat16)
    G = jnp.where(inb, jnp.round(G),
                  jnp.float32(WALL_MID)).astype(jnp.int8)[:, None]
    # tilemap.h:66-69: "Out of bounds is a wall" — the reference paints
    # themed wall_mid above/below the 64-row map (the fixed-x camera
    # keeps the sides in bounds; the same rule fixed jumper's frame
    # parity, games/jumper.py)

    atlas_s = jnp.asarray(A["atlas_p"]).transpose(1, 0, 2, 3)  # [A, 4, S, S]
    tl = jnp.asarray(A["tile_lut"])
    th = level.theme.astype(jnp.int32)
    themed = jnp.stack(
        [atlas_s[tl[th, WALL_TOP]], atlas_s[tl[th, WALL_MID]]], axis=1
    ).astype(jnp.bfloat16)  # [N, 2, 4, S, S]
    t1 = jnp.einsum("nrh,nkchw->nkcrw", ohv, themed,
                    preferred_element_type=jnp.bfloat16)

    inv = jnp.bfloat16(1 / 255.0)

    # kind-at-a-time second stage (see games/coinrun.py observe_batch)
    def blend_kind(img, mask, rows_k):
        kimg = jnp.einsum("ncrw,nuw->ncru", rows_k, ohu,
                          preferred_element_type=jnp.bfloat16)
        a = mask.astype(jnp.bfloat16) * (kimg[:, 3:4] * inv)
        return img + a * (kimg[:, :3] - img)

    img = blend_kind(img, G == WALL_TOP, t1[:, 0])
    img = blend_kind(img, G == WALL_MID, t1[:, 1])

    # ---- stamps: crystals + swimming mobs, then the agent ----
    def pix(centers, P):
        px = (centers[..., 0] - cam_x[:, None]) * PPU + C.OBS / 2
        py = (centers[..., 1] - cam_y[:, None]) * PPU + C.OBS / 2
        return (jnp.round(py - P / 2).astype(jnp.int32),
                jnp.round(px - P / 2).astype(jnp.int32))

    live = level.point_exists & ~states.point_taken  # [N, MAX_POINTS]
    mob_frame = ((states.t // 5) % 2).astype(jnp.int32)  # anim rate 0.2
    mob_flip = (states.mob_vx < 0.0).astype(jnp.int32)
    mob_var = 1 + mob_frame[:, None] * 2 + mob_flip
    crys_var = jnp.zeros((N, MAX_POINTS), jnp.int32)

    # crystal center = point_pos (1x1 at offset -0.5); mob center =
    # mob_pos + 0.1 (1x1 at offset -0.4, tilemap.cpp:47-54)
    centers = jnp.concatenate(
        [level.point_pos, states.mob_pos + 0.1], axis=1
    )
    vars_ = jnp.concatenate([crys_var, mob_var], axis=1)
    alives = jnp.concatenate([live, level.mob_alive], axis=1)
    r0, c0 = pix(centers, 8)
    img = C.composite_stamps(img, banks["moving"], vars_, r0, c0,
                             alives=alives)

    # agent: 0.8 x 1.1 at (x-0.5, y-1.0) -> center (x-0.1, y-0.45)
    pose = jnp.where(
        (jnp.abs(states.vel[:, 0]) < 0.01) & states.on_ground, 0,
        jnp.where(~states.on_ground, 1,
                  jnp.where(states.anim_t > 0.5, 3, 2)),
    ).astype(jnp.int32)
    avar = (level.agent_theme.astype(jnp.int32) * 8 + pose * 2
            + (~states.face_forward).astype(jnp.int32))[:, None]
    acenter = jnp.stack(
        [states.pos[:, 0] - 0.1, states.pos[:, 1] - 0.45], axis=-1
    )[:, None, :]
    r0, c0 = pix(acenter, 8)
    img = C.composite_stamps(img, banks["agent"], avar, r0, c0)

    obs = jnp.clip(jnp.round(img), 0, 255).astype(jnp.uint8)
    return obs  # planar u8 [N, 3, OBS, OBS]; layout applied by the Environment
