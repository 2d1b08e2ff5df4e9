"""Chaser: Pac-Man-style maze — eat pellets, dodge enemies, orbs flip the hunt.

JAX re-implementation of the reference's `games/chaser/`:
  * level generation — Kruskal maze (set-merge variant, equivalent to the
    union-find Kruskal in gen/kruskal.py), 4 quadrants with 1 orb each
    (+-1 extra in extreme/hard), 3-5 enemy eggs + agent start on distinct
    free cells, a pellet on every remaining free cell
    (tilemap.cpp:80-243); modes easy 11x11/3 enemies, hard 13x13/3,
    extreme 19x19/5 (tilemap.cpp:85-99);
  * agent — queued-direction turning at cell centers with an input reset
    timer (common_systems.cpp:305-444; speed 0.2, reset time 2.5);
  * enemy AI — eggs hatch after 50t (hatch_timer in sub-step dt units),
    junction-based 50% chase (Manhattan-greedy) / 50% uniform direction,
    inverted to flee while the system-global eat_timer is active; eaten
    enemies respawn as eggs at a random free cell
    (common_systems.cpp:117-295);
  * rewards — +0.04 per pellet *and per orb*, +10 when every Point entity
    (pellets + orbs) is collected; terminate on enemy contact while not
    vulnerable, or on completion (chaser.cpp:307-309). Reward recomputed
    per sub-step last-write-wins, break on terminal (chaser.cpp:298-312).

Reference quirks reproduced deliberately:
  * Egg respawn places the enemy at (x+0.5, y_up+0.5) — using the y-up
    tile coordinate directly as the render-space y, i.e. vertically
    mirrored (common_systems.cpp:269-274 lacks the map_height-1-y flip
    every spawn_* helper applies). Levels are vertically symmetric in
    distribution so this is invisible statistically, but we keep it.
  * At a junction with zero allowed directions (dead end, since reversal
    is excluded — chaser uses the *plain* maze generator which has dead
    ends, tilemap.cpp:113-114), select_index stays 0 and the enemy is
    pushed left regardless of walls (common_systems.cpp:198-237).
  * eat_timer, anim_timer/index and input_timer are system-global, not
    per-entity (common_systems.h:56, orb eaten by ANY collection flips
    ALL enemies).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from ..utils import struct

from ..core import spaces
from ..gen.kruskal import kruskal_maze, masked_uniform_cell
from ..physics.aabb import check_collision
from ..render import atlas as atlas_lib
from ..render import compositor as C

NAME = "chaser"
NUM_ACTIONS = 15
SUB_STEPS = 4  # chaser.cpp:44
DT = 1.0 / SUB_STEPS

AGENT_SPEED = 0.2  # common_systems.cpp:309
INPUT_RESET_TIME = 1.0 / AGENT_SPEED * 0.5  # = 2.5, common_systems.cpp:310
HATCH_TIME = 50.0  # common_systems.cpp:118
EAT_TIME = 75.0  # common_systems.cpp:298
SPEED_LOW = 0.125  # fleeing, common_systems.cpp:121
SPEED_HIGH = 0.25  # chasing, common_systems.cpp:122
ANIM_TIME = 1.0  # common_systems.cpp:119

_MODES = {  # world_dim, total_enemies, extra_orb_sign — tilemap.cpp:85-99
    "easy": (11, 3, 0),
    "hard": (13, 3, -1),
    "extreme": (19, 5, 1),
}

MAX_ENEMIES = 5
MAX_ORBS = 8  # 2 slots per quadrant (extreme grants one quadrant 2 orbs)

# Junction direction table (common_systems.h:61-66), render coords
_DIRS = np.array([[-1.0, 0.0], [1.0, 0.0], [0.0, -1.0], [0.0, 1.0]], np.float32)
NUM_BGS = 9  # chaser.cpp:57-66


@dataclasses.dataclass(frozen=True)
class Config:
    mode: str = "easy"  # tilemap.h:40 default easy_mode

    @property
    def world_dim(self):
        return _MODES[self.mode][0]

    @property
    def total_enemies(self):
        return _MODES[self.mode][1]

    @property
    def extra_orb_sign(self):
        return _MODES[self.mode][2]


@struct.dataclass
class Level:
    wall: jnp.ndarray  # bool [D, D] render coords [ry, x]
    orb_pos: jnp.ndarray  # f32 [MAX_ORBS, 2] render coords
    orb_exists: jnp.ndarray  # bool [MAX_ORBS]
    egg_pos: jnp.ndarray  # f32 [MAX_ENEMIES, 2] render coords
    egg_exists: jnp.ndarray  # bool [MAX_ENEMIES]
    agent_pos: jnp.ndarray  # f32 [2]
    point_grid0: jnp.ndarray  # bool [D, D] pellet on cell (render coords)
    respawn_free: jnp.ndarray  # bool [D, D] in (x, y_up) indexing —
    #   the tilemap free_cells list used for egg respawn (tilemap.cpp:174-179,
    #   common_systems.cpp:269-274)
    bg_index: jnp.ndarray  # i32
    bg_offset: jnp.ndarray  # f32


@struct.dataclass
class State:
    level: Level
    pos: jnp.ndarray  # f32 [2]
    vel: jnp.ndarray  # f32 [2] unit direction (Component_Dynamics)
    next_vel: jnp.ndarray  # f32 [2] queued turn (Component_Agent.next_velocity)
    input_timer: jnp.ndarray  # f32 (System_Agent::input_timer, system-global)
    mob_pos: jnp.ndarray  # f32 [MAX_ENEMIES, 2]
    mob_vel: jnp.ndarray  # f32 [MAX_ENEMIES, 2] (includes speed)
    hatch_timer: jnp.ndarray  # f32 [MAX_ENEMIES]
    eat_timer: jnp.ndarray  # f32 (system-global)
    anim_timer: jnp.ndarray  # f32
    anim_index: jnp.ndarray  # i32
    point_grid: jnp.ndarray  # bool [D, D]
    orb_taken: jnp.ndarray  # bool [MAX_ORBS]
    t: jnp.ndarray  # i32
    rng: jax.Array


# ---------------------------------------------------------------------------
# Assets
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _assets():
    atlas, idx = atlas_lib.build_atlas(
        ("stone_wall", "chaser_point", "crystal", "egg_spikey",
         "flyer0", "flyer1", "flyer2", "walker_flee", "floater")
    )
    bgs = atlas_lib.build_backgrounds("topdown", NUM_BGS)
    lut = [-1, idx["stone_wall"]]
    # hatched animation: anim_index<3 ? idx : 5-idx -> 0,1,2,2,1,0
    # (common_systems.cpp:151-155)
    flyer_frames = np.array(
        [idx[f"flyer{i}"] for i in (0, 1, 2, 2, 1, 0)], np.int32
    )
    return dict(
        atlas_p=atlas.transpose(3, 0, 1, 2),
        idx=idx,
        bgs_p=bgs.transpose(3, 0, 1, 2),
        lut=lut,
        flyer_frames=flyer_frames,
    )


# ---------------------------------------------------------------------------
# Generation (tilemap.cpp:80-243)
# ---------------------------------------------------------------------------

def generate(cfg: Config, key) -> Level:
    D = cfg.world_dim
    k_maze, k_quad, k_orbs, k_spawn, k_bg, k_bgoff = jax.random.split(key, 6)

    # Maze in (x, y_up) coords; the reference reads the padded generator grid
    # at +1 offsets (tilemap.cpp:133), which is exactly the unpadded maze.
    wall_xy = kruskal_maze(k_maze, D, max_dim=D)  # bool [x, y_up]
    free_xy = ~wall_xy

    # --- Orbs: quadrant-balanced placement (tilemap.cpp:116-172) ---
    extra_quad = jax.random.randint(k_quad, (), 0, 4)
    xs = jnp.arange(D)[:, None]
    ys = jnp.arange(D)[None, :]
    quad_of = (xs >= D // 2) * 2 + (ys >= D // 2)  # tilemap.cpp:140

    orb_pos = jnp.zeros((MAX_ORBS, 2), jnp.float32)
    orb_exists = jnp.zeros(MAX_ORBS, bool)
    orb_mask_xy = jnp.zeros((D, D), bool)
    okeys = jax.random.split(k_orbs, 8)
    for q in range(4):
        n_orbs = 1 + jnp.where(extra_quad == q, cfg.extra_orb_sign, 0)
        qmask = free_xy & (quad_of == q)
        ox1, oy1 = masked_uniform_cell(okeys[2 * q], qmask)
        have1 = n_orbs >= 1
        orb_mask_xy = orb_mask_xy.at[ox1, oy1].set(
            orb_mask_xy[ox1, oy1] | have1
        )
        orb_pos = orb_pos.at[2 * q].set(
            jnp.stack([ox1 + 0.5, D - 1.0 - oy1 + 0.5])
        )
        orb_exists = orb_exists.at[2 * q].set(have1)
        # Second orb (extreme's extra): distinct cell within the quadrant
        # (reference probes +1 on collision, tilemap.cpp:156-163 —
        # distributionally uniform-distinct for 2 draws)
        qmask2 = qmask.at[ox1, oy1].set(False)
        ox2, oy2 = masked_uniform_cell(okeys[2 * q + 1], qmask2)
        have2 = n_orbs >= 2
        orb_mask_xy = orb_mask_xy.at[ox2, oy2].set(
            orb_mask_xy[ox2, oy2] | have2
        )
        orb_pos = orb_pos.at[2 * q + 1].set(
            jnp.stack([ox2 + 0.5, D - 1.0 - oy2 + 0.5])
        )
        orb_exists = orb_exists.at[2 * q + 1].set(have2)

    # --- Agent start + eggs on distinct remaining free cells
    # (tilemap.cpp:174-213) ---
    avail = free_xy & ~orb_mask_xy
    skeys = jax.random.split(k_spawn, MAX_ENEMIES + 1)
    ax, ay = masked_uniform_cell(skeys[0], avail)
    avail = avail.at[ax, ay].set(False)
    agent_pos = jnp.stack([ax + 0.5, D - 1.0 - ay + 0.5]).astype(jnp.float32)

    egg_pos = jnp.zeros((MAX_ENEMIES, 2), jnp.float32)
    egg_exists = jnp.zeros(MAX_ENEMIES, bool)
    for e in range(MAX_ENEMIES):
        ex, ey = masked_uniform_cell(skeys[e + 1], avail)
        have = e < cfg.total_enemies  # static (mode is config)
        if have:
            avail = avail.at[ex, ey].set(False)
            egg_pos = egg_pos.at[e].set(
                jnp.stack([ex + 0.5, D - 1.0 - ey + 0.5])
            )
            egg_exists = egg_exists.at[e].set(True)

    # --- Pellets on every remaining free cell; this same set is the
    # respawn free_cells list (tilemap.cpp:215-225) ---
    point_xy = avail

    # (x, y_up) -> render [ry, x]
    wall_r = jnp.flip(wall_xy.T, axis=0)
    point_r = jnp.flip(point_xy.T, axis=0)

    return Level(
        wall=wall_r,
        orb_pos=orb_pos,
        orb_exists=orb_exists,
        egg_pos=egg_pos,
        egg_exists=egg_exists,
        agent_pos=agent_pos,
        point_grid0=point_r,
        respawn_free=point_xy,
        bg_index=jax.random.randint(k_bg, (), 0, NUM_BGS),
        bg_offset=jax.random.uniform(k_bgoff),
    )


def reset(cfg: Config, level: Level, key) -> State:
    return State(
        level=level,
        pos=level.agent_pos,
        vel=jnp.zeros(2, jnp.float32),
        next_vel=jnp.zeros(2, jnp.float32),
        input_timer=jnp.float32(0.0),
        mob_pos=level.egg_pos,
        mob_vel=jnp.zeros((MAX_ENEMIES, 2), jnp.float32),
        hatch_timer=jnp.zeros(MAX_ENEMIES, jnp.float32),
        eat_timer=jnp.float32(0.0),
        anim_timer=jnp.float32(0.0),
        anim_index=jnp.int32(0),
        point_grid=level.point_grid0,
        orb_taken=jnp.zeros(MAX_ORBS, bool),
        t=jnp.int32(0),
        rng=key,
    )


# ---------------------------------------------------------------------------
# Step (chaser.cpp:280-312)
# ---------------------------------------------------------------------------

def _wall_at(wall, cx, ry):
    """Wall test at render (col, row); OOB reads are walls for movement
    purposes (tilemap get() returns out_of_bounds, which != empty).

    `cx`/`ry` may carry leading dims (stacked probes). The lookup is an
    elementwise one-hot reduce over the small grid (D <= 19 makes the
    dense form cheap).
    """
    D = wall.shape[0]
    ohr = jnp.arange(D) == ry[..., None]
    ohc = jnp.arange(D) == cx[..., None]
    m = ohr[..., :, None] & ohc[..., None, :]
    val = jnp.any(m & wall, axis=(-2, -1))
    inb = (cx >= 0) & (cx < D) & (ry >= 0) & (ry < D)
    return jnp.where(inb, val, True)


def _sign(x):
    return jnp.where(x == 0.0, 0, jnp.where(x > 0.0, 1, -1))


def _agent_substep(wall, pos, vel, next_vel, input_timer, action):
    """System_Agent::update (common_systems.cpp:305-444)."""
    a = action
    movement_x = (a == 7).astype(jnp.float32) - (a == 1).astype(jnp.float32)
    movement_y = (a == 3).astype(jnp.float32) - (a == 5).astype(jnp.float32)
    movement_y = jnp.where(movement_x != 0.0, 0.0, movement_y)  # no diagonals

    has_input = (movement_x != 0.0) | (movement_y != 0.0)
    next_vel = jnp.where(has_input, jnp.stack([movement_x, movement_y]), next_vel)
    input_timer = jnp.where(has_input, 0.0, input_timer)

    px, py = pos[0], pos[1]
    ix = px.astype(jnp.int32)
    iy = py.astype(jnp.int32)

    # The reference's centering gate `abs(pos - (int(pos) + 0.5f)) <=
    # speed * dt` (common_systems.cpp:346-420) calls the GLOBAL ::abs —
    # common_systems.cpp includes <cmath> (std::abs overloads only) but
    # never `using std`, so unqualified abs binds to ::abs(int): the
    # float argument truncates to 0 and the gate is ALWAYS TRUE for any
    # sub-unit offset. Verified by compiling the expression in the
    # reference's exact include context and by 15/15-seed bit-exact
    # economy parity against the executed binary (the EPS-gated mirror
    # left a 2-seed one-sub-step pickup residual). Turns and stops
    # therefore engage from ANYWHERE in the cell, not just near centers.

    # Queued turn (common_systems.cpp:345-385); the whole next_velocity
    # vector is taken.
    turn_x_pos = (next_vel[0] > 0) & ~_wall_at(wall, ix + 1, iy)
    turn_x_neg = (next_vel[0] < 0) & ~_wall_at(wall, ix - 1, iy)
    turn_y_pos = (next_vel[1] > 0) & ~_wall_at(wall, ix, iy + 1)
    turn_y_neg = (next_vel[1] < 0) & ~_wall_at(wall, ix, iy - 1)
    turn_x = turn_x_pos | turn_x_neg
    turn_y = turn_y_pos | turn_y_neg
    py = jnp.where(turn_x, iy + 0.5, py)
    px = jnp.where(turn_y, ix + 0.5, px)
    vel = jnp.where(turn_x | turn_y, next_vel, vel)

    # Wall stops (common_systems.cpp:387-428; same always-true gate)
    ix = px.astype(jnp.int32)
    iy = py.astype(jnp.int32)
    stop_x = (
        ((vel[0] < 0) & _wall_at(wall, ix - 1, iy))
        | ((vel[0] > 0) & _wall_at(wall, ix + 1, iy))
    )
    stop_y = (
        ((vel[1] < 0) & _wall_at(wall, ix, iy - 1))
        | ((vel[1] > 0) & _wall_at(wall, ix, iy + 1))
    )
    px = jnp.where(stop_x, ix + 0.5, px)
    py = jnp.where(stop_y, iy + 0.5, py)
    vel = vel * jnp.stack([~stop_x, ~stop_y]).astype(jnp.float32)

    pos = jnp.stack([px + vel[0] * AGENT_SPEED * DT, py + vel[1] * AGENT_SPEED * DT])

    next_vel = jnp.where(input_timer >= INPUT_RESET_TIME,
                         jnp.zeros(2), next_vel)
    input_timer = jnp.where(input_timer >= INPUT_RESET_TIME,
                            input_timer, input_timer + DT)
    return pos, vel, next_vel, input_timer


def _mob_substep(level, mob_pos, mob_vel, hatch_timer, eat_timer, agent_pos, key):
    """System_Mob_AI::update for all enemies (common_systems.cpp:117-295).

    Returns (pos, vel, hatch_timer, player_hit).
    """
    wall = level.wall
    speed = jnp.where(eat_timer == 0.0, SPEED_HIGH, SPEED_LOW)

    def one(p, v, hatch, k):
        k_aggr, k_dir, k_respawn = jax.random.split(k, 3)
        hatched = hatch >= HATCH_TIME

        px, py = p[0], p[1]
        ix = px.astype(jnp.int32)
        iy = py.astype(jnp.int32)
        # at_junction (common_systems.cpp:165-166) uses the same
        # int-bound ::abs as the agent gates (see _agent_substep):
        # max(abs(int 0), abs(int 0)) < speed*dt is ALWAYS TRUE, so a
        # hatched enemy re-decides its direction EVERY sub-step.
        decide = hatched

        # Allowed directions: open tile, not a reversal
        # (common_systems.cpp:173-194)
        poss = jnp.stack([
            ~_wall_at(wall, ix - 1, iy) & (-1 != -_sign(v[0])),
            ~_wall_at(wall, ix + 1, iy) & (1 != -_sign(v[0])),
            ~_wall_at(wall, ix, iy - 1) & (-1 != -_sign(v[1])),
            ~_wall_at(wall, ix, iy + 1) & (1 != -_sign(v[1])),
        ])

        dirs = jnp.asarray(_DIRS)
        be_aggressive = jax.random.uniform(k_aggr) < 0.5
        # Manhattan-greedy toward (or away from) the agent
        # (common_systems.cpp:200-218); first index wins ties. The
        # distance ALSO goes through the int-bound ::abs — each delta
        # truncates toward zero before abs, so the chase metric is the
        # INTEGER manhattan distance (cell-granular, heavy ties).
        cand = (jnp.abs(jnp.trunc(px + dirs[:, 0] - agent_pos[0]))
                + jnp.abs(jnp.trunc(py + dirs[:, 1] - agent_pos[1])))
        cand = jnp.where(eat_timer > 0.0, -cand, cand)
        greedy = jnp.argmin(jnp.where(poss, cand, jnp.inf))
        greedy = jnp.where(poss.any(), greedy, 0)  # select_index stays 0
        # Uniform over allowed (roulette, common_systems.cpp:220-236)
        rand_sel = jax.random.categorical(
            k_dir, jnp.where(poss, 0.0, -jnp.inf)
        )
        rand_sel = jnp.where(poss.any(), rand_sel, 0)
        sel = jnp.where(be_aggressive, greedy, rand_sel)

        new_v = dirs[sel] * speed
        # Stay aligned on the orthogonal axis (common_systems.cpp:244-248)
        new_px = jnp.where(dirs[sel, 0] == 0.0, ix + 0.5, px)
        new_py = jnp.where(dirs[sel, 1] == 0.0, iy + 0.5, py)

        v = jnp.where(decide, new_v, v)
        px = jnp.where(decide, new_px, px)
        py = jnp.where(decide, new_py, py)

        # Move (hatched only)
        px = px + jnp.where(hatched, v[0] * DT, 0.0)
        py = py + jnp.where(hatched, v[1] * DT, 0.0)

        # Agent contact (1x1 boxes both; check_collision's exact f32
        # expression, see _collect_points)
        contact = hatched & check_collision(
            agent_pos[0] - 0.5, agent_pos[1] - 0.5, 1.0, 1.0,
            px - 0.5, py - 0.5, 1.0, 1.0,
        )
        hit = contact & (eat_timer == 0.0)
        eaten = contact & (eat_timer > 0.0)

        # Eaten -> respawn as egg; reproduces the missing y-flip
        # (common_systems.cpp:264-277): render y := y_up + 0.5
        rx, ry_up = masked_uniform_cell(k_respawn, level.respawn_free)
        px = jnp.where(eaten, rx + 0.5, px)
        py = jnp.where(eaten, ry_up + 0.5, py)
        hatch = jnp.where(eaten, 0.0, hatch)

        hatch = jnp.where(hatched, hatch, hatch + DT)
        return jnp.stack([px, py]), v, hatch, hit

    keys = jax.random.split(key, MAX_ENEMIES)
    new_pos, new_vel, new_hatch, hits = jax.vmap(one)(
        mob_pos, mob_vel, hatch_timer, keys
    )
    alive = level.egg_exists
    new_pos = jnp.where(alive[:, None], new_pos, mob_pos)
    new_vel = jnp.where(alive[:, None], new_vel, mob_vel)
    new_hatch = jnp.where(alive, new_hatch, hatch_timer)
    return new_pos, new_vel, new_hatch, (hits & alive).any()


def _collect_points(level, point_grid, orb_taken, agent_pos):
    """System_Point::update (common_systems.cpp:66-106).

    Pellet bounds 0.6x0.6, orb bounds 1x1, agent 1x1, all centered
    (tilemap.cpp:42,58). Returns (point_grid, orb_taken, delta, available,
    orb_collected).
    """
    D = point_grid.shape[0]
    # Overlap tests mirror check_collision's EXACT f32 expression
    # (helpers.cpp:40-46: a.x < b.x + b.w && a.x + a.w > b.x, operands
    # built as bounds + position) rather than the algebraically equal
    # |center delta| < 0.8 form: at boundary events the two round
    # differently, shifting the collection sub-step — and with the
    # last-write-wins reward quirk that flips reward VISIBILITY.
    # Caught by executing the compiled reference engine
    # (tests/test_reference_execution.py): the |d| form diverged from
    # the real cenv_step reward stream at f32-boundary pickups.
    ax = agent_pos[0] - 0.5
    ay = agent_pos[1] - 0.5
    # Pellet rects: (-0.3, -0.3, 0.6, 0.6) at cell centers built as
    # f32((i + 0.5) - 0.3) like spawn_point (tilemap.cpp:52-58), with
    # the rect edges PRE-EVALUATED in strict step-by-step f32 on the
    # host: XLA constant-folds traced constant chains like
    # ((i + 0.5) - 0.3) + 0.6 in one higher-precision pass (1.8 instead
    # of the reference's runtime 1.8000001f), which flipped boundary
    # pickups. The overlap window only covers the 3x3 cells around the
    # agent, so the dense whole-grid test is exactly the reference's
    # per-cell loop — and it is elementwise (no gathers/scatters).
    cf = np.float32(np.arange(D, dtype=np.float32) + np.float32(0.5))
    lo = np.float32(cf - np.float32(0.3))           # b.x
    hi = np.float32(lo + np.float32(0.6))           # b.x + b.w
    hits = (
        point_grid
        & (ax < hi[None, :]) & (ax + 1.0 > lo[None, :])
        & (ay < hi[:, None]) & (ay + 1.0 > lo[:, None])
    )
    delta = hits.sum().astype(jnp.int32)
    point_grid = point_grid & ~hits

    orb_hit = (
        level.orb_exists & ~orb_taken
        & check_collision(ax, ay, 1.0, 1.0,
                          level.orb_pos[:, 0] - 0.5,
                          level.orb_pos[:, 1] - 0.5, 1.0, 1.0)
    )
    delta = delta + orb_hit.sum()
    orb_taken = orb_taken | orb_hit
    available = point_grid.sum() + (level.orb_exists & ~orb_taken).sum()
    return point_grid, orb_taken, delta, available, orb_hit.any()


def step(cfg: Config, state: State, action):
    level = state.level
    a = action.astype(jnp.int32)

    pos, vel, next_vel = state.pos, state.vel, state.next_vel
    input_timer = state.input_timer
    mob_pos, mob_vel = state.mob_pos, state.mob_vel
    hatch_timer, eat_timer = state.hatch_timer, state.eat_timer
    anim_timer, anim_index = state.anim_timer, state.anim_index
    point_grid, orb_taken = state.point_grid, state.orb_taken
    rng = state.rng
    done = jnp.bool_(False)
    reward = jnp.float32(0.0)

    for _ in range(SUB_STEPS):  # chaser.cpp:298-312, break on terminal
        rng, k_mob = jax.random.split(rng)
        active = ~done

        n_pos, n_vel, n_next, n_itimer = _agent_substep(
            level.wall, pos, vel, next_vel, input_timer, a
        )
        n_mob_pos, n_mob_vel, n_hatch, dead = _mob_substep(
            level, mob_pos, mob_vel, hatch_timer, eat_timer, n_pos, k_mob
        )
        # System-global timers tick inside mob update
        # (common_systems.cpp:284-293)
        n_anim_t = jnp.where(anim_timer < ANIM_TIME, anim_timer + DT,
                             anim_timer - ANIM_TIME)
        n_anim_i = jnp.where(anim_timer < ANIM_TIME, anim_index,
                             (anim_index + 1) % 6)
        n_eat = jnp.maximum(0.0, eat_timer - DT)

        n_points, n_orbs, delta, available, orb_got = _collect_points(
            level, point_grid, orb_taken, n_pos
        )
        n_eat = jnp.where(orb_got, EAT_TIME, n_eat)  # eat(), cs.cpp:297-299

        sub_reward = delta.astype(jnp.float32) * 0.04 + (available == 0) * 10.0

        pos = jnp.where(active, n_pos, pos)
        vel = jnp.where(active, n_vel, vel)
        next_vel = jnp.where(active, n_next, next_vel)
        input_timer = jnp.where(active, n_itimer, input_timer)
        mob_pos = jnp.where(active, n_mob_pos, mob_pos)
        mob_vel = jnp.where(active, n_mob_vel, mob_vel)
        hatch_timer = jnp.where(active, n_hatch, hatch_timer)
        eat_timer = jnp.where(active, n_eat, eat_timer)
        anim_timer = jnp.where(active, n_anim_t, anim_timer)
        anim_index = jnp.where(active, n_anim_i, anim_index)
        point_grid = jnp.where(active, n_points, point_grid)
        orb_taken = jnp.where(active, n_orbs, orb_taken)
        reward = jnp.where(active, sub_reward, reward)
        done = done | (active & (dead | (available == 0)))

    new_state = State(
        level=level, pos=pos, vel=vel, next_vel=next_vel,
        input_timer=input_timer, mob_pos=mob_pos, mob_vel=mob_vel,
        hatch_timer=hatch_timer, eat_timer=eat_timer,
        anim_timer=anim_timer, anim_index=anim_index,
        point_grid=point_grid, orb_taken=orb_taken,
        t=state.t + 1, rng=rng,
    )
    return new_state, reward, done, {}


# ---------------------------------------------------------------------------
# Rendering (chaser.cpp:388-420)
# ---------------------------------------------------------------------------

def observe(cfg: Config, state: State):
    A = _assets()
    level = state.level
    D = cfg.world_dim
    ppu = C.OBS / D  # camera fits map width (chaser.cpp:400)
    center = jnp.float32(D / 2.0)
    wx, wy = C.camera_coords(ppu, center, center)

    img = C.clear()
    img = C.draw_background(img, jnp.asarray(A["bgs_p"]), level.bg_index, wx, wy)
    img = C.draw_tiles(
        img, level.wall.astype(jnp.int8), jnp.asarray(A["lut"]),
        A["atlas_p"], wx, wy, oob_tile=0,
    )
    # Pellets: draw via the tile layer (one per free cell, 1x1 sprite rect)
    pellet_layer = jnp.where(state.point_grid, 0, -1)
    img = C.draw_tiles(
        img, pellet_layer, jnp.asarray([A["idx"]["chaser_point"]]),
        A["atlas_p"], wx, wy, oob_tile=-1,
    )
    # Orbs
    live_orbs = level.orb_exists & ~state.orb_taken
    img = C.draw_sprites(
        img, A["atlas_p"], jnp.full(MAX_ORBS, A["idx"]["crystal"]),
        level.orb_pos[:, 0] - 0.5, level.orb_pos[:, 1] - 0.5,
        jnp.ones(MAX_ORBS), jnp.ones(MAX_ORBS), wx, wy,
        alives=live_orbs,
    )
    # Enemies: egg until hatched; flyer cycle (or flee sprite) after
    hatched = state.hatch_timer >= HATCH_TIME
    flyer_sid = jnp.asarray(A["flyer_frames"])[state.anim_index]
    sid = jnp.where(
        hatched,
        jnp.where(state.eat_timer > 0.0, A["idx"]["walker_flee"], flyer_sid),
        A["idx"]["egg_spikey"],
    )
    img = C.draw_sprites(
        img, A["atlas_p"], sid,
        state.mob_pos[:, 0] - 0.5, state.mob_pos[:, 1] - 0.5,
        jnp.ones(MAX_ENEMIES), jnp.ones(MAX_ENEMIES), wx, wy,
        alives=level.egg_exists,
    )
    # Agent (common_systems.cpp:446-460)
    img = C.draw_sprite(
        img, A["atlas_p"], A["idx"]["floater"],
        state.pos[0] - 0.5, state.pos[1] - 0.5, 1.0, 1.0, wx, wy,
    )
    return C.finalize(img)


def obs_space(cfg: Config):
    return spaces.Box(0, 255, (C.OBS, C.OBS, 3))


def action_space(cfg: Config):
    return spaces.MultiDiscrete((NUM_ACTIONS,))


# ---------------------------------------------------------------------------
# Batched fast renderer: fixed camera, kind-field tiles, enemy stamps
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _stamp_banks(ppu: float):
    """Pixel-snapped stamps for the moving entities (enemies + agent):
    variants = egg, walker_flee, flyer 0..5 cycle, floater."""
    A = atlas_lib
    names = ["egg_spikey", "walker_flee", "flyer0", "flyer1", "flyer2",
             "flyer2", "flyer1", "flyer0", "floater"]
    return A.build_pixel_bank(
        tuple((n, ppu, ppu) for n in names), patch=int(ppu) + 3
    )


def observe_batch(cfg: Config, states: State):
    A = _assets()
    level = states.level
    D = cfg.world_dim
    N = states.pos.shape[0]
    ppu = C.OBS / D
    center = jnp.float32(D / 2.0)
    wx, wy = C.camera_coords(ppu, center, center)

    # --- shared pieces (fixed camera: maze-style kind compositing) ---
    tx = jnp.floor(wx).astype(jnp.int32)
    ty = jnp.floor(wy).astype(jnp.int32)
    ohx = C._onehot(jnp.clip(tx, 0, D - 1), D)
    ohy = C._onehot(jnp.clip(ty, 0, D - 1), D)
    ohu = C._onehot(
        jnp.clip(((wx - tx) * C.S).astype(jnp.int32), 0, C.S - 1), C.S)
    ohv = C._onehot(
        jnp.clip(((wy - ty) * C.S).astype(jnp.int32), 0, C.S - 1), C.S)
    atlas_j = jnp.asarray(A["atlas_p"])
    wall_img = C._sep_sample(atlas_j[:, A["idx"]["stone_wall"]], ohv, ohu)
    pellet_img = C._sep_sample(atlas_j[:, A["idx"]["chaser_point"]], ohv, ohu)
    orb_img = C._sep_sample(atlas_j[:, A["idx"]["crystal"]], ohv, ohu)

    # pre-sampled background bank (spans 64 units from the origin)
    H = W = atlas_lib.BG_SIZE
    ub = wx / 64.0
    ohu_b = C._onehot(jnp.clip((ub * W).astype(jnp.int32), 0, W - 1),
                      W, (ub >= 0) & (ub < 1))
    ohv_b = C._onehot(jnp.clip((ub * H).astype(jnp.int32), 0, H - 1),
                      H, (ub >= 0) & (ub < 1))
    bgs_j = jnp.asarray(A["bgs_p"])
    bg_bank = jnp.clip(jnp.round(jax.vmap(
        lambda b: C._sep_sample(bgs_j[:, b], ohv_b, ohu_b)
    )(jnp.arange(bgs_j.shape[1]))), 0, 255).astype(jnp.uint8)

    # --- per-env kind grid: 0 empty, 1 wall, 2 pellet, 3 live orb ---
    rows = jnp.arange(D)[:, None]
    cols = jnp.arange(D)[None, :]
    orb_r = jnp.floor(level.orb_pos[..., 1]).astype(jnp.int32)  # [N, 8]
    orb_c = jnp.floor(level.orb_pos[..., 0]).astype(jnp.int32)
    orb_live = level.orb_exists & ~states.orb_taken
    orb_mask = (
        (orb_r[:, :, None, None] == rows) & (orb_c[:, :, None, None] == cols)
        & orb_live[:, :, None, None]
    ).any(axis=1)  # [N, D, D]
    aug = (
        level.wall.astype(jnp.int8)
        + states.point_grid * jnp.int8(2)
        + orb_mask * jnp.int8(3)
    )
    G = jnp.einsum("rh,nhw->nrw", ohy, aug.astype(jnp.bfloat16),
                   preferred_element_type=jnp.bfloat16)
    G = jnp.einsum("nrw,uw->nru", G, ohx,
                   preferred_element_type=jnp.bfloat16)
    Gi = jnp.round(G).astype(jnp.int8)[:, None]

    inv = jnp.bfloat16(1 / 255.0)
    img = bg_bank[level.bg_index.astype(jnp.int32)].astype(jnp.bfloat16)

    def blend(img, mask, kimg):
        a = mask.astype(jnp.bfloat16) * (kimg[3][None, None] * inv)
        return img + a * (kimg[:3][None] - img)

    img = blend(img, Gi == 1, wall_img)
    img = blend(img, Gi == 2, pellet_img)
    img = blend(img, Gi == 3, orb_img)

    # --- moving stamps: enemies (egg/flyer/flee) + agent ---
    bank = _stamp_banks(ppu)
    P = bank.shape[-1]
    hatched = states.hatch_timer >= HATCH_TIME
    flee = states.eat_timer[:, None] > 0.0
    var = jnp.where(
        hatched,
        jnp.where(flee, 1, 2 + states.anim_index[:, None]),
        0,
    ).astype(jnp.int32)
    centers = jnp.concatenate(
        [states.mob_pos, states.pos[:, None, :]], axis=1)
    vars_ = jnp.concatenate([var, jnp.full((N, 1), 8, jnp.int32)], axis=1)
    alives = jnp.concatenate(
        [level.egg_exists, jnp.ones((N, 1), bool)], axis=1)
    r0 = jnp.round(
        (centers[..., 1] - center) * ppu + C.OBS / 2 - P / 2
    ).astype(jnp.int32)
    c0 = jnp.round(
        (centers[..., 0] - center) * ppu + C.OBS / 2 - P / 2
    ).astype(jnp.int32)
    img = C.composite_stamps(img, bank, vars_, r0, c0, alives=alives)

    obs = jnp.clip(jnp.round(img), 0, 255).astype(jnp.uint8)
    return obs  # planar u8 [N, 3, OBS, OBS]; layout applied by the Environment
