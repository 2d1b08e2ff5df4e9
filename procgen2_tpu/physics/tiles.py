"""Two-pass axis-resolving tilemap collision, shared by every tile game.

Re-implements System_Tilemap::get_collision
(`games/coinrun/tilemap.cpp:323-396`, vendored near-identically in all 7
games): pass 1 resolves the vertical axis for tiles whose overlap is wider
than tall, pass 2 resolves the horizontal axis, with per-tile collision
semantics (none / full / down_only) injected by the caller — here as an int
LUT over tile ids instead of a std::function. Coinrun's one-way-platform
(`down_only`) logic with `fallthrough` + `step_y` (tilemap.cpp:352-360) is
included.

Array re-design: the reference loops over the floor/ceil tile window of the
AABB sequentially, *mutating the rectangle as it scans* (later tiles see the
already-resolved position) — so the loop is unrolled here over a static 3x3
tile window (sufficient for the <= 1x1 rects every game uses) carrying the
rect through `where`-selects. All scalar math, vmapped over the env batch.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

NONE, FULL, DOWN_ONLY = 0, 1, 2

_WINDOW = 3  # floor(x)..ceil(x+w) spans <= 3 tiles for w <= 1


def tile_at(grid, tx, ty, oob_id):
    """Tile lookup in render coords; out-of-bounds yields `oob_id`
    (tilemap.h:79-84)."""
    H, W = grid.shape
    inb = (tx >= 0) & (tx < W) & (ty >= 0) & (ty < H)
    v = grid[jnp.clip(ty, 0, H - 1), jnp.clip(tx, 0, W - 1)]
    return jnp.where(inb, v.astype(jnp.int32), oob_id)


def aabb_overlap(ax, ay, aw, ah, bx, by):
    """Overlap of rect (a) with the 1x1 tile at (bx, by); standard
    intersection (helpers.cpp:48-108 reduces to this, see physics/aabb.py)."""
    ox = jnp.maximum(ax, bx)
    oy = jnp.maximum(ay, by)
    ow = jnp.minimum(ax + aw, bx + 1.0) - ox
    oh = jnp.minimum(ay + ah, by + 1.0) - oy
    return ox, oy, ow, oh


def _window_types(grid, coll_lut, lx, ly, oob_id):
    """Collision types of the 3x3 tile window at (lx, ly), prefetched
    with one pair of one-hot contractions instead of 9 scalar gathers.

    The grid never changes during a resolve (only the rect moves), so the
    window values are loop constants, fetched once with one-hot masks
    instead of per-probe gathers. The LUT is applied arithmetically (tile-id equality masks) —
    no gathers at all. `lx`/`ly` may carry leading batch dims (e.g. [K]
    probes resolved together — coinrun's 40 mob sensors become one
    matmul pair instead of 40 resolver calls). Returns a python list
    [dy][dx] of int32 collision types with those batch dims.
    """
    H, W = grid.shape
    d3 = jnp.arange(_WINDOW)
    ys = ly[..., None] + d3  # [..., 3]
    xs = lx[..., None] + d3
    # Row select + column select as broadcast multiply-reduces: a dot
    # here would be one tiny batched [3,H]@[H,W] matmul per env; the
    # elementwise form fuses instead.
    ohy = (jnp.arange(H) == ys[..., None])  # [..., 3, H] bool
    rows = jnp.sum(
        jnp.where(ohy[..., None], grid[..., None, :, :].astype(jnp.int32), 0),
        axis=-2,
    )  # [..., 3, W]
    ohx = (jnp.arange(W) == xs[..., None])  # [..., 3, W]
    vals = jnp.sum(
        jnp.where(ohx[..., None, :, :], rows[..., :, None, :], 0), axis=-1
    )  # [..., 3(dy), 3(dx)]
    inb = (((ys >= 0) & (ys < H))[..., :, None]
           & ((xs >= 0) & (xs < W))[..., None, :])
    vals = jnp.where(inb, vals, oob_id)
    return _apply_lut(vals, coll_lut)


def _apply_lut(vals, coll_lut):
    """Tile ids [..., 3, 3] -> collision types, arithmetically when the
    LUT is static (no gathers). Returns list [dy][dx] of arrays."""
    if isinstance(coll_lut, (list, tuple)):
        lut = list(coll_lut)
    elif isinstance(coll_lut, np.ndarray):
        lut = coll_lut.tolist()
    else:
        lut = None
    if lut is None:  # traced LUT: fall back to one small gather
        t = jnp.asarray(coll_lut)[vals]
    else:  # static LUT: equality masks, no gather at all
        t = jnp.zeros_like(vals)
        for tile_id, ctype in enumerate(lut):
            if ctype != NONE:
                t = jnp.where(vals == tile_id, ctype, t)
    return [[t[..., dy, dx] for dx in range(_WINDOW)]
            for dy in range(_WINDOW)]


def resolve_tile_collisions(
    grid, coll_lut, x, y, w, h, oob_id, fallthrough=False, step_y=0.0
):
    """Returns (new_x, new_y, collided) for rect (x, y, w, h) in render units.

    `coll_lut`: static int sequence mapping tile id -> NONE/FULL/DOWN_ONLY.
    `fallthrough`/`step_y`: one-way platform control (tilemap.cpp:352-360).
    Window bounds and the rect center are captured once up-front, exactly as
    the reference does (tilemap.cpp:326-331).

    `x`/`y` (and `w`/`h`/`fallthrough`/`step_y`, broadcasting) may carry
    leading batch dims: K probe rects resolve together sharing one
    window-fetch contraction — the fast path for per-entity sensors.
    """
    lx = jnp.floor(x).astype(jnp.int32)
    ly = jnp.floor(y).astype(jnp.int32)
    types = _window_types(grid, coll_lut, lx, ly, oob_id)
    return _resolve_core(types, lx, ly, x, y, w, h, fallthrough, step_y)


def resolve_from_rows(rows, coll_lut, x, y, w, h, W, oob_id,
                      fallthrough=False, step_y=0.0):
    """resolve_tile_collisions for probes whose 3 window *rows* were
    prefetched (`rows` [..., 3, W] int tile values with row-OOB already
    folded to `oob_id`).

    For entities that keep a constant y within a step (coinrun/climber
    patrol mobs), the row fetch happens once per step as a single
    batched contraction, and each sub-step resolve reduces to an
    elementwise column selection here — no per-probe grid reads at all.
    """
    lx = jnp.floor(x).astype(jnp.int32)
    ly = jnp.floor(y).astype(jnp.int32)
    d3 = jnp.arange(_WINDOW)
    xs = lx[..., None] + d3
    ohx = (jnp.arange(W) == xs[..., None])  # [..., 3(dx), W]
    vals = jnp.sum(
        jnp.where(ohx[..., None, :, :], rows[..., :, None, :], 0), axis=-1
    )  # [..., 3(dy), 3(dx)]
    inx = ((xs >= 0) & (xs < W))[..., None, :]
    vals = jnp.where(inx, vals, oob_id)
    types = _apply_lut(vals, coll_lut)
    return _resolve_core(types, lx, ly, x, y, w, h, fallthrough, step_y)


def fetch_window_rows(grid, ly, oob_id):
    """Tile values of the 3 window rows starting at `ly` for K probes:
    one batched contraction per call (fold K*3 into the matmul M dim).

    grid [H, W]; ly i32 [K] -> rows int8 [K, 3, W] with row-OOB folded
    (int8: tile ids are tiny, and under vmap the [N, K, 3, W] rows
    tensor is re-read every sub-step — i32 rows cost 4x the HBM).
    """
    H, W = grid.shape
    ys = ly[:, None] + jnp.arange(_WINDOW)  # [K, 3]
    ohy = (jnp.arange(H) == ys[..., None]).astype(jnp.bfloat16)  # [K,3,H]
    K = ys.shape[0]
    rows = (ohy.reshape(K * _WINDOW, H) @ grid.astype(jnp.bfloat16))
    rows = jnp.round(rows).astype(jnp.int8).reshape(K, _WINDOW, W)
    iny = ((ys >= 0) & (ys < H))[..., None]
    return jnp.where(iny, rows, jnp.int8(oob_id))


def fetch_window_patch(grid, lx0, ly, oob_id, width=5):
    """Tile values of a 3-row x `width`-col window at (lx0, ly) for K
    probes: int8 [K, 3, width], OOB folded to `oob_id`.

    For entities whose per-step movement is bounded by one tile
    (coinrun/climber patrol mobs move <= 0.15 units/step), the whole
    step's sub-step resolves read from this one small patch instead of
    full-width rows: the patch is W/width of the traffic of the
    [N, K, 3, W] rows tensor, and the per-sub-step select shrinks from a
    64-wide reduction to a `width`-wide one.
    """
    rows = fetch_window_rows(grid, ly, oob_id)  # [K, 3, W] int8
    W = grid.shape[1]
    xs = lx0[:, None] + jnp.arange(width)  # [K, width]
    ohx = (jnp.arange(W) == xs[..., None])  # [K, width, W]
    vals = jnp.sum(
        jnp.where(ohx[:, None, :, :], rows[:, :, None, :], 0), axis=-1
    ).astype(jnp.int8)  # [K, 3, width]
    inx = ((xs >= 0) & (xs < W))[:, None, :]
    return jnp.where(inx, vals, jnp.int8(oob_id))


def resolve_from_patch(patch, lx0, coll_lut, x, y, w, h, oob_id,
                       fallthrough=False, step_y=0.0):
    """resolve_tile_collisions for probes whose 3 x `width` window patch
    was prefetched with `fetch_window_patch` at column origin `lx0`.

    The probe's current 3x3 window starts at floor(x), which the caller
    guarantees stays within [lx0, lx0 + width - 3] (fetch with enough
    margin for the step's movement). The per-sub-step work is a
    `width`-wide elementwise select — no grid reads at all.
    """
    lx = jnp.floor(x).astype(jnp.int32)
    ly = jnp.floor(y).astype(jnp.int32)
    width = patch.shape[-1]
    d = jnp.clip(lx - lx0, 0, width - _WINDOW)  # [...]
    # vals[..., dy, dx] = patch[..., dy, d + dx]
    cols = d[..., None] + jnp.arange(_WINDOW)  # [..., 3]
    oh = cols[..., :, None] == jnp.arange(width)  # [..., 3(dx), width]
    vals = jnp.sum(
        jnp.where(oh[..., None, :, :], patch[..., :, None, :], 0), axis=-1
    )  # [..., 3(dy), 3(dx)]
    types = _apply_lut(vals, coll_lut)
    return _resolve_core(types, lx, ly, x, y, w, h, fallthrough, step_y)


def _resolve_core(types, lx, ly, x, y, w, h, fallthrough, step_y):
    ux = jnp.ceil(x + w).astype(jnp.int32)
    uy = jnp.ceil(y + h).astype(jnp.int32)
    cx = x + w * 0.5
    cy = y + h * 0.5

    fallthrough = jnp.asarray(fallthrough)
    step_y = jnp.asarray(step_y, jnp.float32)

    collided = jnp.bool_(False)

    # ---- Pass 1: vertical resolution (tilemap.cpp:337-368) ----
    ry = y
    for dy in range(_WINDOW):
        for dx in range(_WINDOW):
            tx = lx + dx
            ty = ly + dy
            valid = (tx <= ux) & (ty <= uy)
            t = types[dy][dx]
            txf = tx.astype(jnp.float32)
            tyf = ty.astype(jnp.float32)
            ox, oy, ow, oh = aabb_overlap(x, ry, w, h, txf, tyf)
            hit = valid & (t != NONE) & (ow > 0) & (oh > 0) & (ow > oh)
            # down_only: only solid when landing from above while moving down
            # and not holding fallthrough (tilemap.cpp:353-360).
            inside = (ry + h - step_y) > tyf
            allowed = jnp.where(
                t == DOWN_ONLY, (step_y > 0.01) & ~fallthrough & ~inside, True
            )
            hit = hit & allowed
            oc_y = oy + oh * 0.5
            new_y = jnp.where(oc_y > cy, tyf - h, tyf + 1.0)
            ry = jnp.where(hit, new_y, ry)
            collided = collided | hit

    # ---- Pass 2: horizontal resolution (tilemap.cpp:370-393) ----
    rx = x
    for dy in range(_WINDOW):
        for dx in range(_WINDOW):
            tx = lx + dx
            ty = ly + dy
            valid = (tx <= ux) & (ty <= uy)
            t = types[dy][dx]
            txf = tx.astype(jnp.float32)
            tyf = ty.astype(jnp.float32)
            ox, oy, ow, oh = aabb_overlap(rx, ry, w, h, txf, tyf)
            hit = (
                valid & (t != NONE) & (t != DOWN_ONLY)
                & (ow > 0) & (oh > 0) & (ow <= oh)
            )
            oc_x = ox + ow * 0.5
            new_x = jnp.where(oc_x > cx, txf - w, txf + 1.0)
            rx = jnp.where(hit, new_x, rx)
            collided = collided | hit

    return rx, ry, collided


def probe_any_solid(solid, x, y, w, h, oob_solid=True):
    """Does each rect overlap any solid tile? Vectorized over [K] rects.

    For small rects (w, h < 1) only the 4 corner tiles can overlap, so
    collision reduces to 4 lookups — done as one one-hot contraction
    pair for all K rects, keeping bullet/mob wall probes off the
    per-probe resolver path (caveflyer fires 32 of these per sub-step,
    common_systems.cpp:216-280). Matches the reference resolver's
    `collided` output for such rects: either pass hits iff some solid
    tile strictly overlaps the original rect.

    solid: bool [H, W] (render coords); x, y, w, h: f32 [K].
    Returns bool [K].
    """
    H, W = solid.shape
    # Overlap-interval masks per axis (strict overlap, ow/oh > 0 — the
    # resolver's hit test): ovx[k, tx] / ovy[k, ty]. The solid-overlap
    # count is then (ovy @ solid) . ovx — two contractions for all K
    # probes with zero gathers.
    tiles_x = jnp.arange(W, dtype=jnp.float32)
    tiles_y = jnp.arange(H, dtype=jnp.float32)
    ovx = ((x[:, None] < tiles_x + 1.0)
           & (x[:, None] + w[:, None] > tiles_x)).astype(jnp.bfloat16)
    ovy = ((y[:, None] < tiles_y + 1.0)
           & (y[:, None] + h[:, None] > tiles_y)).astype(jnp.bfloat16)
    rows = ovy @ solid.astype(jnp.bfloat16)  # [K, W]
    count = jnp.einsum("kw,kw->k", rows, ovx)
    hit = count > 0.5
    if oob_solid:
        # any strict overlap beyond the map edge counts as a wall hit
        oob = (x < 0.0) | (x + w > W) | (y < 0.0) | (y + h > H)
        hit = hit | oob
    return hit
