"""Cellular-automata caves, connected rooms, BFS paths — array-parallel.

Array re-design of the reference's Room_Generator
(`games/jumper/room_generator.{h,cpp}`, vendored identically in caveflyer):

* `ca_smooth` — the Moore-9 >= 5 -> wall smoothing pass
  (room_generator.cpp:21-36) as a single 2D stencil (out-of-bounds counts
  as wall, room_generator.h:40-44).
* `largest_room` — find_best_room (room_generator.cpp:143-164): the
  reference BFS-floods every component with unordered_sets; here every
  cell iteratively adopts the minimum flat index of its 4-connected
  component (synchronous label propagation), then a bincount picks the
  largest label. Exact for any component shape given enough iterations.
* `bfs_dist` — find_path's breadth-first expansion
  (room_generator.cpp:80-141) as iterative distance relaxation over the
  4-neighborhood.
* `shortest_path_mask` — backtracks dst -> src along strictly-decreasing
  distances. The reference returns the specific FIFO-order BFS path; any
  shortest path has identical length and the downstream use is a 4-cell
  Moore dilation (expand_room), so the pruned world class matches.
* `dilate_in` — expand_room (room_generator.cpp:166-202): n Moore-8
  dilations restricted to open cells.

All functions take/return `wall: bool[H, W]`-style masks and jit/vmap
cleanly (fixed iteration bounds; no data-dependent shapes).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _shift(a, dx, dy, fill):
    """Shift a 2D array by (dx, dy) in (row, col), filling vacated cells."""
    return jnp.roll(a, (dx, dy), (0, 1)).at[
        jnp.s_[:dx] if dx > 0 else jnp.s_[dx:] if dx < 0 else jnp.s_[0:0]
    ].set(fill).at[
        :, jnp.s_[:dy] if dy > 0 else jnp.s_[dy:] if dy < 0 else jnp.s_[0:0]
    ].set(fill)


def ca_smooth(wall):
    """One cellular-automata pass: Moore-9 wall count >= 5 -> wall.

    (room_generator.cpp:21-36; the count includes the cell itself and
    out-of-bounds neighbors are walls.)
    """
    w = wall.astype(jnp.int32)
    total = jnp.zeros_like(w)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            total = total + _shift(w, dx, dy, 1)
    return total >= 5


def _neighbor_min(lbl, open_mask, big):
    m = lbl
    for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        m = jnp.minimum(m, _shift(lbl, dx, dy, big))
    return jnp.where(open_mask, jnp.minimum(lbl, m), big)


def largest_room(open_mask, iters: int):
    """Mask of the largest 4-connected component of `open_mask`.

    `iters` must be >= the largest component's internal BFS eccentricity;
    callers use H*W//2 which upper-bounds any 4-connected path shape.
    """
    H, W = open_mask.shape
    big = jnp.int32(H * W)
    idx = jnp.arange(H * W, dtype=jnp.int32).reshape(H, W)
    lbl = jnp.where(open_mask, idx, big)

    def body(_, lbl):
        return _neighbor_min(lbl, open_mask, big)

    lbl = jax.lax.fori_loop(0, iters, body, lbl)
    sizes = jnp.zeros(H * W + 1, jnp.int32).at[lbl.reshape(-1)].add(1)
    sizes = sizes.at[H * W].set(0)  # the non-open bucket
    best = jnp.argmax(sizes)
    return lbl == best


def bfs_dist(open_mask, src_y, src_x, iters: int):
    """4-connected BFS distance from (src_y, src_x) over open cells.

    Unreachable/closed cells get H*W (inf sentinel).
    """
    H, W = open_mask.shape
    inf = jnp.int32(H * W)
    dist = jnp.full((H, W), inf).at[src_y, src_x].set(0)

    def body(_, dist):
        m = dist
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            m = jnp.minimum(m, _shift(dist, dx, dy, inf) + 1)
        return jnp.where(open_mask, jnp.minimum(dist, m), inf)

    return jax.lax.fori_loop(0, iters, body, dist)


def shortest_path_mask(dist, dst_y, dst_x):
    """Bool mask of one shortest path ending at (dst_y, dst_x).

    Walks strictly-decreasing distance values; neighbor preference order
    (x-1, x+1, y-1, y+1) mirrors the reference's expansion order
    (room_generator.cpp:103-121).
    """
    H, W = dist.shape

    def in_b(y, x):
        return (y >= 0) & (y < H) & (x >= 0) & (x < W)

    def dist_at(y, x):
        return jnp.where(
            in_b(y, x), dist[jnp.clip(y, 0, H - 1), jnp.clip(x, 0, W - 1)],
            jnp.int32(H * W),
        )

    def cond(carry):
        y, x, mask = carry
        return dist_at(y, x) > 0

    def body(carry):
        y, x, mask = carry
        d = dist_at(y, x)
        mask = mask.at[y, x].set(True)
        # neighbor offsets in reference scan order: (x-1), (x+1), (y-1), (y+1)
        cands = ((y, x - 1), (y, x + 1), (y - 1, x), (y + 1, x))
        ny, nx = y, x
        found = jnp.bool_(False)
        for cy, cx in cands:
            ok = ~found & (dist_at(cy, cx) == d - 1)
            ny = jnp.where(ok, cy, ny)
            nx = jnp.where(ok, cx, nx)
            found = found | ok
        return ny, nx, mask

    y0 = jnp.asarray(dst_y, jnp.int32)
    x0 = jnp.asarray(dst_x, jnp.int32)
    y, x, mask = jax.lax.while_loop(
        cond, body, (y0, x0, jnp.zeros((H, W), bool))
    )
    return mask.at[y, x].set(True)


def dilate_in(mask, open_mask, n: int):
    """n Moore-8 dilations of `mask`, constrained to open cells
    (expand_room, room_generator.cpp:166-202)."""

    def body(_, m):
        g = m
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                g = g | _shift(m, dx, dy, False)
        return g & open_mask

    return jax.lax.fori_loop(0, n, body, mask)
