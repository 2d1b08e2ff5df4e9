"""Maze: Kruskal-carved grid world, discrete cell-snapped movement.

JAX re-implementation of the reference maze engine
(the reference's `games/maze/`): level generation (tilemap.cpp:31-109),
movement + goal check (common_systems.cpp:69-136), timeout termination
(maze.cpp:45-50,295-310) and rendering order (maze.cpp:386-414). Behavior
parity notes are cited inline.

Mode table (tilemap.cpp:35-47): easy 15x15 view 15; hard 25x25 view 25
(the reference's default config, tilemap.h:41); memory 31x31 view 8 with an
agent-centered camera.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from ..utils import struct

from ..core import spaces
from ..gen.kruskal import kruskal_maze, masked_uniform_cell
from ..render import atlas as atlas_lib
from ..render import compositor as C

NAME = "maze"
NUM_ACTIONS = 15  # maze.cpp:28
TIMEOUT = 500  # maze.cpp:49

_MODES = {  # world_dim, visibility, agent_centered — tilemap.cpp:35-47
    "easy": (15, 15, False),
    "hard": (25, 25, False),
    "memory": (31, 8, True),
}

EMPTY, WALL = 0, 1  # tilemap.h Tile_ID: empty=0, wall=1


@dataclasses.dataclass(frozen=True)
class Config:
    mode: str = "hard"  # reference default, games/maze/tilemap.h:41
    timeout: int = TIMEOUT

    @property
    def world_dim(self):
        return _MODES[self.mode][0]

    @property
    def visibility(self):
        return _MODES[self.mode][1]

    @property
    def agent_centered(self):
        return _MODES[self.mode][2]


@struct.dataclass
class Level:
    grid: jnp.ndarray  # int8 [world_dim, world_dim], render coords [y, x]
    goal_pos: jnp.ndarray  # f32 [2], cell center, render units
    agent_pos: jnp.ndarray  # f32 [2]
    maze_dim: jnp.ndarray  # i32
    bg_index: jnp.ndarray  # i32
    bg_offset: jnp.ndarray  # f32


@struct.dataclass
class State:
    level: Level
    pos: jnp.ndarray  # f32 [2]
    face_forward: jnp.ndarray  # bool — flips agent sprite,
    #                            common_systems.cpp:129-132
    t: jnp.ndarray  # i32 step counter (maze.cpp:50)
    rng: jax.Array


# ---------------------------------------------------------------------------
# Assets
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _assets():
    atlas, idx = atlas_lib.build_atlas(("maze_wall", "cheese", "mouse"))
    bgs = atlas_lib.build_backgrounds("topdown", 9)  # maze.cpp:62-72
    lut = [-1, idx["maze_wall"]]  # empty -> transparent, wall -> sand tile
    # Planar (channel-leading) layouts for the compositor.
    return atlas.transpose(3, 0, 1, 2), idx, bgs.transpose(3, 0, 1, 2), lut


# ---------------------------------------------------------------------------
# Generation (tilemap.cpp:31-109)
# ---------------------------------------------------------------------------

def generate(cfg: Config, key) -> Level:
    wd = cfg.world_dim
    k_dim, k_maze, k_goal, k_bg, k_bgoff = jax.random.split(key, 5)

    # maze_dim = random odd in [3, world_dim] (tilemap.cpp:62-63)
    n = jax.random.randint(k_dim, (), 0, (wd - 1) // 2)  # [0, (wd-1)/2 - 1]
    maze_dim = n * 2 + 3
    margin = (wd - maze_dim) // 2

    wall = kruskal_maze(k_maze, maze_dim, max_dim=wd)  # bool [wd, wd], [i, j]

    # Goal: uniform over free cells excluding the agent start (0, 0)
    # (maze_generator.cpp:183-195 place_object with START_CELL exclusion).
    free = ~wall
    free = free.at[0, 0].set(False)
    gi, gj = masked_uniform_cell(k_goal, free)

    # Embed maze into the all-wall world, converting maze coords (i, j) to
    # render coords: x = i + margin, row = wd-1 - (j + margin)
    # (tilemap.cpp:78-87 with the storage flip folded in; see compositor.py).
    xs = jnp.arange(wd)
    i = xs[None, :] - margin  # per column
    j = (wd - 1 - xs)[:, None] - margin  # per row
    in_maze = (i >= 0) & (i < maze_dim) & (j >= 0) & (j < maze_dim)
    val = wall[jnp.clip(i, 0, wd - 1), jnp.clip(j, 0, wd - 1)]
    grid = jnp.where(in_maze & ~val, EMPTY, WALL).astype(jnp.int8)

    goal_pos = jnp.stack(
        [gi + margin + 0.5, wd - 1 - (gj + margin) + 0.5]
    ).astype(jnp.float32)  # tilemap.cpp:92
    agent_pos = jnp.stack(
        [margin + 0.5, wd - 1 - margin + 0.5]
    ).astype(jnp.float32)  # tilemap.cpp:99-101

    return Level(
        grid=grid,
        goal_pos=goal_pos,
        agent_pos=agent_pos,
        maze_dim=maze_dim,
        bg_index=jax.random.randint(k_bg, (), 0, 9),  # maze.cpp:424-426
        bg_offset=jax.random.uniform(k_bgoff),  # maze.cpp:428-430
    )


def reset(cfg: Config, level: Level, key) -> State:
    return State(
        level=level,
        pos=level.agent_pos,
        face_forward=jnp.bool_(False),
        t=jnp.int32(0),
        rng=key,
    )


# ---------------------------------------------------------------------------
# Step (maze.cpp:279-310 + common_systems.cpp:69-136)
# ---------------------------------------------------------------------------

def step(cfg: Config, state: State, action):
    level = state.level
    wd = cfg.world_dim
    grid = level.grid
    px, py = state.pos[0], state.pos[1]

    # 15-action grid movement (common_systems.cpp:88-89). Note the reference
    # computes movement_x = action/3 - 1 without range-clamping, so actions
    # 9-14 probe 2-3 cells over; reproduced faithfully.
    a = action.astype(jnp.int32)
    mx = a // 3 - 1
    my = jnp.where(mx != 0, 0, -(a % 3 - 1))  # render-y: negative = up-screen

    def tile(tx, ty):
        inb = (tx >= 0) & (tx < wd) & (ty >= 0) & (ty < wd)
        return jnp.where(
            inb, grid[jnp.clip(ty, 0, wd - 1), jnp.clip(tx, 0, wd - 1)], WALL
        )

    # C-style truncation toward zero (int casts, common_systems.cpp:92-99)
    tx = (px + mx).astype(jnp.int32)
    ty = (py + my).astype(jnp.int32)
    can_x = (mx != 0) & (tile(tx, py.astype(jnp.int32)) == EMPTY)
    can_y = (mx == 0) & (my != 0) & (tile(px.astype(jnp.int32), ty) == EMPTY)
    px = jnp.where(can_x, tx.astype(jnp.float32) + 0.5, px)
    py = jnp.where(can_y, ty.astype(jnp.float32) + 0.5, py)
    pos = jnp.stack([px, py])

    face_forward = jnp.where(
        mx > 0, True, jnp.where(mx < 0, False, state.face_forward)
    )  # common_systems.cpp:129-132

    # Goal AABB overlap, both 1x1 boxes centered on cell centers
    # (common_systems.cpp:103-117, helpers check_collision).
    reached = jnp.all(jnp.abs(pos - level.goal_pos) < 1.0)

    reward = reached.astype(jnp.float32) * 10.0  # maze.cpp:300
    t = state.t + 1
    # Timeout flagged as `terminated`, not truncated — reference quirk,
    # maze.cpp:308-310.
    terminated = reached | (t >= cfg.timeout)

    new_state = State(
        level=level, pos=pos, face_forward=face_forward, t=t, rng=state.rng
    )
    return new_state, reward, terminated, {}


# ---------------------------------------------------------------------------
# Rendering (maze.cpp:386-414)
# ---------------------------------------------------------------------------

def observe(cfg: Config, state: State):
    atlas, idx, bgs, lut = _assets()
    wd = cfg.world_dim
    ppu = C.OBS / cfg.visibility  # maze.cpp:397: zoom fits visible width
    center = jnp.float32(wd / 2.0)
    if cfg.agent_centered:
        # Camera follows agent once stepping begins (common_systems.cpp:120-123)
        # but the very first frame after reset() uses the map center
        # (maze.cpp:436-437).
        cam_x = jnp.where(state.t > 0, state.pos[0], center)
        cam_y = jnp.where(state.t > 0, state.pos[1], center)
    else:
        cam_x = cam_y = center
    wx, wy = C.camera_coords(ppu, cam_x, cam_y)

    img = C.clear()
    # Background spans 64 world units from origin (maze.cpp:403-408); our
    # procedural backgrounds are square so the aspect offset term vanishes.
    img = C.draw_background(img, jnp.asarray(bgs), state.level.bg_index, wx, wy)
    img = C.draw_tiles(img, state.level.grid, jnp.asarray(lut), atlas, wx, wy,
                       oob_tile=WALL)
    # Cheese: offset (-0.48, -0.5), scale 0.95, z=+1 (tilemap.cpp:95)
    img = C.draw_sprite(
        img, atlas, idx["cheese"],
        state.level.goal_pos[0] - 0.48, state.level.goal_pos[1] - 0.5,
        0.95, 0.95, wx, wy,
    )
    # Agent: 1x1 at pos, flip when facing forward (common_systems.cpp:138-149)
    img = C.draw_sprite(
        img, atlas, idx["mouse"],
        state.pos[0] - 0.5, state.pos[1] - 0.5, 1.0, 1.0, wx, wy,
        flip_x=state.face_forward,
    )
    return C.finalize(img)


def observe_batch(cfg: Config, states: State):
    """Batched renderer exploiting maze's fixed camera (easy/hard modes).

    The camera never moves (maze.cpp:397: zoom fits the whole maze) and
    *all* scene objects sit on cell-snapped positions — the mouse spans
    exactly its cell, the cheese's offset/scale rect (tilemap.cpp:95)
    stays inside its cell. So sprites are just extra *tile kinds*: the
    intra-cell texel image of each kind is a shared separable field
    (one pair of one-hot matmuls, no batch dim), and the only per-env
    data are a small augmented kind-grid and the background index. The
    whole frame then composites in one fused XLA elementwise chain with
    zero full-frame per-layer intermediates:

        kinds: 0 empty, 1 wall, 2 cheese, 3 mouse, 4 mouse(flip),
               5 mouse-on-cheese, 6 mouse(flip)-on-cheese
    """
    if cfg.agent_centered:  # memory mode: camera follows the agent
        return _observe_batch_memory(cfg, states)

    atlas, idx, bgs, _lut = _assets()
    atlas_j = jnp.asarray(atlas)
    wd = cfg.world_dim
    ppu = C.OBS / cfg.visibility
    center = jnp.float32(wd / 2.0)
    wx, wy = C.camera_coords(ppu, center, center)

    # --- shared pieces (no batch dim; XLA hoists them) ---
    tx = jnp.floor(wx).astype(jnp.int32)
    ty = jnp.floor(wy).astype(jnp.int32)
    in_x = (tx >= 0) & (tx < wd)
    in_y = (ty >= 0) & (ty < wd)
    ohx = C._onehot(jnp.clip(tx, 0, wd - 1), wd)
    ohy = C._onehot(jnp.clip(ty, 0, wd - 1), wd)
    fx = wx - tx  # intra-cell fractional coords, [0, 1)
    fy = wy - ty
    u = jnp.clip((fx * C.S).astype(jnp.int32), 0, C.S - 1)
    v = jnp.clip((fy * C.S).astype(jnp.int32), 0, C.S - 1)
    ohu_t = C._onehot(u, C.S)
    ohv_t = C._onehot(v, C.S)

    # Cheese rect: top-left = cell + (0.02, 0.0), size 0.95 (draw offset
    # (-0.48, -0.5) from the cell-center goal_pos, tilemap.cpp:95).
    cu = (fx - 0.02) / 0.95
    cv = fy / 0.95
    ohu_c = C._onehot(jnp.clip((cu * C.S).astype(jnp.int32), 0, C.S - 1),
                      C.S, (cu >= 0) & (cu < 1))
    ohv_c = C._onehot(jnp.clip((cv * C.S).astype(jnp.int32), 0, C.S - 1),
                      C.S, (cv >= 0) & (cv < 1))

    wall_img = C._sep_sample(atlas_j[:, idx["maze_wall"]], ohv_t, ohu_t)
    cheese_img = C._sep_sample(atlas_j[:, idx["cheese"]], ohv_c, ohu_c)
    mouse_img = C._sep_sample(atlas_j[:, idx["mouse"]], ohv_t, ohu_t)
    mouse_flip = C._sep_sample(atlas_j[:, idx["mouse"]], ohv_t, ohu_t[:, ::-1])

    # pre-sampled background bank, kept u8 (bg spans 64 units from the
    # origin, maze.cpp:403-408); the row gather below reads u8 rows.
    ub = wx / 64.0
    vb = wy / 64.0
    H = W = atlas_lib.BG_SIZE
    ohu_b = C._onehot(jnp.clip((ub * W).astype(jnp.int32), 0, W - 1),
                      W, (ub >= 0) & (ub < 1))
    ohv_b = C._onehot(jnp.clip((vb * H).astype(jnp.int32), 0, H - 1),
                      H, (vb >= 0) & (vb < 1))
    bgs_j = jnp.asarray(bgs)  # [3, B, H, W]
    bg_bank = jnp.clip(jnp.round(jax.vmap(
        lambda b: C._sep_sample(bgs_j[:, b], ohv_b, ohu_b)
    )(jnp.arange(bgs_j.shape[1]))), 0, 255).astype(jnp.uint8)  # [B,3,64,64]

    # --- per-env pieces ---
    # augmented kind grid: scatter cheese/mouse kinds into the tiny grid
    def aug_one(grid, goal_pos, pos, flip):
        gx = goal_pos[0].astype(jnp.int32)
        gy = goal_pos[1].astype(jnp.int32)
        mx = pos[0].astype(jnp.int32)
        my = pos[1].astype(jnp.int32)
        on_cheese = (mx == gx) & (my == gy)
        mval = jnp.where(on_cheese,
                         jnp.where(flip, 6, 5),
                         jnp.where(flip, 4, 3)).astype(jnp.int8)
        g = grid.at[gy, gx].set(jnp.int8(2))
        return g.at[my, mx].set(mval)

    aug = jax.vmap(aug_one)(
        states.level.grid, states.level.goal_pos, states.pos,
        states.face_forward,
    )  # [N, wd, wd] int8, values 0..6

    # kind-under-pixel field G: two batched one-hot matmuls
    G = jnp.einsum("rh,nhw->nrw", ohy, aug.astype(jnp.bfloat16),
                   preferred_element_type=jnp.bfloat16)
    G = jnp.einsum("nrw,uw->nru", G, ohx,
                   preferred_element_type=jnp.bfloat16)
    inb = (in_y[:, None] & in_x[None, :])[None]
    Gi = jnp.where(inb, jnp.round(G), jnp.float32(WALL)).astype(jnp.int8)
    Gi = Gi[:, None]  # [N, 1, 64, 64]

    # --- fused compose: bg row-gather + 4 shared-image masked blends ---
    inv = jnp.bfloat16(1 / 255.0)
    img = bg_bank[states.level.bg_index.astype(jnp.int32)].astype(jnp.bfloat16)

    def blend(img, mask, kimg):
        a = mask.astype(jnp.bfloat16) * (kimg[3][None, None] * inv)
        return img + a * (kimg[:3][None] - img)

    img = blend(img, Gi == 1, wall_img)
    img = blend(img, (Gi == 2) | (Gi >= 5), cheese_img)
    img = blend(img, (Gi == 3) | (Gi == 5), mouse_img)
    img = blend(img, (Gi == 4) | (Gi == 6), mouse_flip)
    obs = jnp.clip(jnp.round(img), 0, 255).astype(jnp.uint8)
    return obs  # planar u8 [N, 3, OBS, OBS]; layout applied by the Environment


def _observe_batch_memory(cfg: Config, states: State):
    """Batched memory-mode renderer (agent-centered camera).

    The agent only ever sits on cell centers (one cell per step,
    common_systems.cpp:69-101), so the camera position is always
    half-integer and the pixel->texel FRACTIONAL pattern is identical
    across envs — per-env cameras differ only by an INTEGER tile shift.
    The expensive pieces of the fixed-camera path therefore stay
    shared (intra-cell texel one-hots and the sampled wall / cheese /
    mouse kind images); the per-env work is the augmented kind grid,
    a shifted tile one-hot pair for the G field, and the scrolling
    background (the PERF.md roadmap's "quantized camera-relative
    shared sampling", exact here because the quantum is a whole cell).
    First frame after reset uses the map center (maze.cpp:436-437),
    also half-integer (wd = 31).
    """
    atlas, idx, bgs, _lut = _assets()
    atlas_j = jnp.asarray(atlas)
    wd = cfg.world_dim
    ppu = C.OBS / cfg.visibility
    center = jnp.float32(wd / 2.0)
    N = states.pos.shape[0]

    cam_x = jnp.where(states.t > 0, states.pos[:, 0], center)
    cam_y = jnp.where(states.t > 0, states.pos[:, 1], center)
    kx = jnp.round(cam_x - 0.5).astype(jnp.int32)  # camera cell
    ky = jnp.round(cam_y - 0.5).astype(jnp.int32)

    # Shared fractional machinery: trace the pattern with the camera at
    # cell 0 (world 0.5); every env's maps are this plus an integer.
    wx0, wy0 = C.camera_coords(ppu, jnp.float32(0.5), jnp.float32(0.5))
    sx = jnp.floor(wx0).astype(jnp.int32)  # [64] shared tile offsets
    sy = jnp.floor(wy0).astype(jnp.int32)
    u = jnp.clip(((wx0 - sx) * C.S).astype(jnp.int32), 0, C.S - 1)
    v = jnp.clip(((wy0 - sy) * C.S).astype(jnp.int32), 0, C.S - 1)
    ohu_t = C._onehot(u, C.S)
    ohv_t = C._onehot(v, C.S)
    cu = ((wx0 - sx) - 0.02) / 0.95  # cheese rect (tilemap.cpp:95)
    cv = (wy0 - sy) / 0.95
    ohu_c = C._onehot(jnp.clip((cu * C.S).astype(jnp.int32), 0, C.S - 1),
                      C.S, (cu >= 0) & (cu < 1))
    ohv_c = C._onehot(jnp.clip((cv * C.S).astype(jnp.int32), 0, C.S - 1),
                      C.S, (cv >= 0) & (cv < 1))

    wall_img = C._sep_sample(atlas_j[:, idx["maze_wall"]], ohv_t, ohu_t)
    cheese_img = C._sep_sample(atlas_j[:, idx["cheese"]], ohv_c, ohu_c)
    mouse_img = C._sep_sample(atlas_j[:, idx["mouse"]], ohv_t, ohu_t)
    mouse_flip = C._sep_sample(atlas_j[:, idx["mouse"]], ohv_t, ohu_t[:, ::-1])

    # per-env augmented kind grid (same kinds as the fixed-camera path)
    def aug_one(grid, goal_pos, pos, flip):
        gx = goal_pos[0].astype(jnp.int32)
        gy = goal_pos[1].astype(jnp.int32)
        mx = pos[0].astype(jnp.int32)
        my = pos[1].astype(jnp.int32)
        on_cheese = (mx == gx) & (my == gy)
        mval = jnp.where(on_cheese,
                         jnp.where(flip, 6, 5),
                         jnp.where(flip, 4, 3)).astype(jnp.int8)
        g = grid.at[gy, gx].set(jnp.int8(2))
        return g.at[my, mx].set(mval)

    aug = jax.vmap(aug_one)(
        states.level.grid, states.level.goal_pos, states.pos,
        states.face_forward,
    )

    # shifted tile one-hots: tile index = camera cell + shared offset
    tX = kx[:, None] + sx[None, :]  # [N, 64]
    tY = ky[:, None] + sy[None, :]
    in_x = (tX >= 0) & (tX < wd)
    in_y = (tY >= 0) & (tY < wd)
    ohx = (jnp.clip(tX, 0, wd - 1)[..., None]
           == jnp.arange(wd)).astype(jnp.bfloat16)
    ohy = (jnp.clip(tY, 0, wd - 1)[..., None]
           == jnp.arange(wd)).astype(jnp.bfloat16)
    G = jnp.einsum("nrh,nhw->nrw", ohy, aug.astype(jnp.bfloat16),
                   preferred_element_type=jnp.bfloat16)
    G = jnp.einsum("nrw,nuw->nru", G, ohx,
                   preferred_element_type=jnp.bfloat16)
    inb = in_y[:, :, None] & in_x[:, None, :]
    Gi = jnp.where(inb, jnp.round(G), jnp.float32(WALL)).astype(jnp.int8)
    Gi = Gi[:, None]  # [N, 1, 64, 64]

    # scrolling background (origin 0, 64 units — maze.cpp:403-408)
    c = jnp.arange(C.OBS, dtype=jnp.float32) + 0.5 - C.OBS / 2
    wx_b = cam_x[:, None] + c[None, :] / ppu
    wy_b = cam_y[:, None] + c[None, :] / ppu
    img = C.draw_background_batch(
        jnp.asarray(bgs), states.level.bg_index.astype(jnp.int32),
        wx_b, wy_b,
    )

    inv = jnp.bfloat16(1 / 255.0)

    def blend(img, mask, kimg):
        a = mask.astype(jnp.bfloat16) * (kimg[3][None, None] * inv)
        return img + a * (kimg[:3][None] - img)

    img = blend(img, Gi == 1, wall_img)
    img = blend(img, (Gi == 2) | (Gi >= 5), cheese_img)
    img = blend(img, (Gi == 3) | (Gi == 5), mouse_img)
    img = blend(img, (Gi == 4) | (Gi == 6), mouse_flip)
    obs = jnp.clip(jnp.round(img), 0, 255).astype(jnp.uint8)
    return obs  # planar u8 [N, 3, OBS, OBS]


def obs_space(cfg: Config):
    return spaces.Box(0, 255, (C.OBS, C.OBS, 3))  # maze.cpp:117-125


def action_space(cfg: Config):
    return spaces.MultiDiscrete((NUM_ACTIONS,))  # maze.cpp:127-135
