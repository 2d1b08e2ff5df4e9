"""Randomized-Kruskal maze carving as a jit-compiled, PRNG-keyed function.

Array re-design of the reference's Maze_Generator
(`games/maze/maze_generator.cpp:55-139`): the C++ picks a uniformly random
remaining wall each iteration and erases it from a vector — equivalent to
visiting the wall list in a uniformly random permutation — and merges room
sets with a path-compressed, union-by-rank union-find
(`maze_generator.cpp:47-53,110-135`). Here the wall list is a *static* array
for the maximum maze size, visited in `jax.random.permutation` order inside a
`lax.fori_loop`, with smaller (traced) maze sizes handled by a validity mask.
Union-find lives in flat int32 arrays with a path-halving `lax.while_loop`
find. The whole generator vmaps over a batch of PRNG keys so an entire level
bank is carved on-device in one compiled call (SURVEY.md §7.2).

Grid convention: cells are maze coordinates (i, j) in [0, max_dim)^2, rooms at
even-even cells, walls between them; returned as `wall: bool[max_dim, max_dim]`
indexed [i, j]. Cells outside the (traced) `dim` x `dim` region stay walls.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.lru_cache(maxsize=None)
def _wall_list(max_dim: int):
    """Static wall list for a max_dim x max_dim maze.

    Mirrors maze_generator.cpp:89-101: vertical walls at (odd i, even j)
    joining (i-1, j)-(i+1, j); horizontal walls at (even i, odd j) joining
    (i, j-1)-(i, j+1).
    """
    e1, e2, ce = [], [], []
    for i in range(1, max_dim - 1, 2):
        for j in range(0, max_dim, 2):
            e1.append((i - 1, j))
            e2.append((i + 1, j))
            ce.append((i, j))
    for i in range(0, max_dim, 2):
        for j in range(1, max_dim - 1, 2):
            e1.append((i, j - 1))
            e2.append((i, j + 1))
            ce.append((i, j))
    return (
        np.asarray(e1, np.int32),
        np.asarray(e2, np.int32),
        np.asarray(ce, np.int32),
    )


FIND_DEPTH = 12  # union-by-rank bounds tree height by the rank, and the
#                  rank only bumps on equal-rank unions: height <=
#                  log2(#nodes). The largest possible set joins every
#                  room + wall-center cell (~1541 at max_dim 45) ->
#                  height <= 10; 12 keeps margin. A fixed-depth chase
#                  always reaches the root and compiles far better than
#                  a data-dependent while_loop; the two chases dominate
#                  the loop's batched-gather work, so depth is kept
#                  tight.


def _find(parent, c):
    """Rank-bounded find. The reference uses path-halving
    (maze_generator.cpp:47-53); with union-by-rank the uncompressed height is
    <= log2(n), so a fixed unrollable chase is equivalent and avoids carrying
    the parent array through a while_loop."""

    def body(_, c):
        return parent[c]

    return jax.lax.fori_loop(0, FIND_DEPTH, body, c)


def kruskal_maze(key, dim, max_dim: int):
    """Carve a maze. `dim` may be traced (odd, 3 <= dim <= max_dim).

    Returns wall: bool[max_dim, max_dim] indexed [i, j] (maze coords).
    """
    e1, e2, ce = _wall_list(max_dim)
    e1 = jnp.asarray(e1)
    e2 = jnp.asarray(e2)
    ce = jnp.asarray(ce)
    n_walls = e1.shape[0]
    D = max_dim

    def cell(p):
        return p[..., 1] + D * p[..., 0]  # j + D*i, maze_generator.h:43-45

    c1, c2, c0 = cell(e1), cell(e2), cell(ce)
    # Wall participates only if fully inside the dim x dim region.
    valid = (
        (jnp.maximum(e1[:, 0], jnp.maximum(e2[:, 0], ce[:, 0])) < dim)
        & (jnp.maximum(e1[:, 1], jnp.maximum(e2[:, 1], ce[:, 1])) < dim)
    )

    order = jax.random.permutation(key, n_walls)

    parent = jnp.arange(D * D, dtype=jnp.int32)
    rank = jnp.zeros(D * D, jnp.int32)
    carved = jnp.zeros(n_walls, bool)

    # The loop carries ONLY the union-find state + the per-wall carve
    # bits. The reference also checks `wall[m]` before carving
    # (maze_generator.cpp:110-118), but each wall's CENTER cell is
    # unique to that wall and centers are never cell 0, so the check is
    # always true at the wall's own turn — dropping the wall-grid carry
    # removes three [D*D] scatters and a gather per iteration.
    #
    # Parallel reformulations (Boruvka rounds with scatter or dense
    # segment-min, chunked snapshot-finds) have been tried; none has been
    # timed on the GPU yet (ROADMAP Speed #4).
    def body(k, carry):
        parent, rank, carved = carry
        w = order[k]
        a, b = c1[w], c2[w]
        m = c0[w]
        ra = _find(parent, a)
        rb = _find(parent, b)
        can = valid[w] & (ra != rb)
        carved = carved.at[w].set(can)
        # Union by rank; the wall-center cell joins the root too
        # (maze_generator.cpp:125-134)
        a_bigger = rank[ra] > rank[rb]
        root = jnp.where(a_bigger, ra, rb)
        child = jnp.where(a_bigger, rb, ra)
        parent = parent.at[child].set(jnp.where(can, root, parent[child]))
        parent = parent.at[m].set(jnp.where(can, root, parent[m]))
        bump = can & ~a_bigger & (rank[ra] == rank[rb])
        rank = rank.at[root].add(bump.astype(jnp.int32))
        return parent, rank, carved

    parent, rank, carved = jax.lax.fori_loop(
        0, n_walls, body, (parent, rank, carved))

    wall = jnp.ones(D * D, bool).at[0].set(False)  # corner room opened,
    #                                           maze_generator.cpp:71
    cells = jnp.concatenate([
        jnp.where(carved, c1, 0), jnp.where(carved, c2, 0),
        jnp.where(carved, c0, 0),
    ])
    opened = jnp.concatenate([carved, carved, carved])
    wall = wall.at[cells].set(jnp.where(opened, False, wall[cells]))
    return wall.reshape(D, D)


def boruvka_maze(key, dim, max_dim: int):
    """Carve the SAME maze as `kruskal_maze` in O(log n) parallel rounds.

    Random-order Kruskal accepts exactly the minimum-spanning-tree edges
    of the room graph under weights = the wall's position in the visit
    permutation (acceptance depends only on connectivity, and the MST is
    unique for distinct weights) — so Boruvka's algorithm on those same
    weights carves the IDENTICAL wall set, key for key. The sequential
    ~n_walls fori_loop (two rank-bounded finds per iteration) becomes
    ~10 rounds of array-parallel work: per round every component picks
    its minimum crossing wall (segment_min over both endpoint labels),
    carved walls are recovered by VALUE comparison against the
    per-component minima (no scatter in the round body), and labels
    contract by pointer jumping.

    Verified bit-identical to kruskal_maze across keys/dims
    (tests/test_kruskal.py)."""
    e1, e2, ce = _wall_list(max_dim)
    e1 = jnp.asarray(e1)
    e2 = jnp.asarray(e2)
    ce = jnp.asarray(ce)
    n_walls = e1.shape[0]
    D = max_dim
    RD = (D + 1) // 2
    R = RD * RD  # rooms at even-even cells

    def room(p):
        return (p[..., 1] // 2) + RD * (p[..., 0] // 2)

    u = room(e1)
    v = room(e2)
    valid = (
        (jnp.maximum(e1[:, 0], jnp.maximum(e2[:, 0], ce[:, 0])) < dim)
        & (jnp.maximum(e1[:, 1], jnp.maximum(e2[:, 1], ce[:, 1])) < dim)
    )

    order = jax.random.permutation(key, n_walls)
    # weight of wall w = its rank in the visit order (inverse permutation)
    weight = jnp.argsort(order).astype(jnp.int32)
    BIG = jnp.int32(n_walls)

    labels = jnp.arange(R, dtype=jnp.int32)
    carved = jnp.zeros(n_walls, bool)
    n_rounds = int(np.ceil(np.log2(max(R, 2)))) + 1

    def round_body(_, carry):
        labels, carved = carry
        lu = labels[u]
        lv = labels[v]
        active = valid & (lu != lv)
        keyw = jnp.where(active, weight, BIG)
        # per-component min via a dense broadcast-reduce: segment_min
        # lowers to a batched scatter-min under vmap; a [E, R] masked
        # min is fused elementwise + reduce work
        comp = jnp.arange(R, dtype=jnp.int32)
        m_u = jnp.min(
            jnp.where(lu[:, None] == comp[None, :], keyw[:, None], BIG),
            axis=0)
        m_v = jnp.min(
            jnp.where(lv[:, None] == comp[None, :], keyw[:, None], BIG),
            axis=0)
        emin = jnp.minimum(m_u, m_v)  # [R] min crossing weight per comp
        # a wall is chosen iff it IS some endpoint component's minimum
        chosen = active & ((keyw == emin[lu]) | (keyw == emin[lv]))
        carved = carved | chosen
        # hook each component to its chosen partner, break 2-cycles
        # toward the smaller id, then pointer-jump to the root
        ew = jnp.clip(emin, 0, n_walls - 1)
        eidx = order[ew]  # weight rank -> wall index
        partner = jnp.where(
            emin < BIG, labels[u[eidx]] + labels[v[eidx]]
            - jnp.arange(R, dtype=jnp.int32), jnp.arange(R, dtype=jnp.int32))
        p = partner
        two_cycle = (p[p] == jnp.arange(R)) & (jnp.arange(R) < p)
        p = jnp.where(two_cycle, jnp.arange(R), p)
        for _ in range(int(np.ceil(np.log2(max(R, 2))))):
            p = p[p]
        labels = p[labels]
        return labels, carved

    labels, carved = jax.lax.fori_loop(
        0, n_rounds, round_body, (labels, carved))

    cells = jnp.concatenate([
        jnp.where(carved, e1[:, 1] + D * e1[:, 0], 0),
        jnp.where(carved, e2[:, 1] + D * e2[:, 0], 0),
        jnp.where(carved, ce[:, 1] + D * ce[:, 0], 0),
    ])
    opened = jnp.concatenate([carved, carved, carved])
    wall = jnp.ones(D * D, bool).at[0].set(False)
    wall = wall.at[cells].set(
        jnp.where(opened, False, wall[cells]))
    return wall.reshape(D, D)


def open_dead_ends(key, wall, dim):
    """The no-dead-end post-pass (generate_maze_no_dead_ends,
    `games/jumper/maze_generator.cpp:132-173`).

    Scans cells in (x-major) index order; every *space* cell with exactly
    one adjacent space and at least one adjacent wall gets a random
    adjacent wall opened. Sequential semantics matter (openings create
    spaces that later cells observe), so this is a `fori_loop` carrying the
    grid. Reference quirks kept faithfully:

    * neighbors are visited in the fixed order (x-1, x+1, y-1, y+1) and
      the random start offset is taken modulo `num_adjacent_walls` but
      *indexes the full neighbor array* (maze_generator.cpp:152-169), so
      only the first `num_adjacent_walls` neighbors are ever candidates —
      a left/right bias we reproduce;
    * out-of-maze neighbors (the generator's padding ring) count as walls
      for the modulo but fail the in-bounds check and are skipped.

    `wall`: bool[D, D] maze-coordinate grid; `dim` may be traced. Cells at
    (i, j) >= dim are padding walls.
    """
    D = wall.shape[0]

    def val(w, i, j):
        inb = (i >= 0) & (i < dim) & (j >= 0) & (j < dim)
        return jnp.where(
            inb, w[jnp.clip(i, 0, D - 1), jnp.clip(j, 0, D - 1)], True
        )

    def body(idx, carry):
        w, key = carry
        key, k = jax.random.split(key)
        x = idx // D
        y = idx % D
        # neighbor order: (x-1,y), (x+1,y), (x,y-1), (x,y+1)
        nbx = jnp.array([x - 1, x + 1, x, x])
        nby = jnp.array([y, y, y - 1, y + 1])
        nwall = jnp.stack([val(w, nbx[n], nby[n]) for n in range(4)])
        ninb = (nbx >= 0) & (nbx < dim) & (nby >= 0) & (nby < dim)
        n_spaces = (~nwall).sum()
        n_walls = nwall.sum()

        is_space = (x < dim) & (y < dim) & ~val(w, x, y)
        do = is_space & (n_spaces == 1) & (n_walls > 0)

        n_sel = jax.random.randint(k, (), 0, jnp.maximum(n_walls, 1))
        # first openable neighbor scanning (n_sel + n) % n_walls, n = 0..3
        chosen = jnp.int32(-1)
        for n in range(4):
            cand = (n_sel + n) % jnp.maximum(n_walls, 1)
            ok = (chosen < 0) & ninb[cand] & nwall[cand] & (n < n_walls)
            chosen = jnp.where(ok, cand, chosen)
        ci = jnp.clip(chosen, 0, 3)
        w = w.at[jnp.clip(nbx[ci], 0, D - 1), jnp.clip(nby[ci], 0, D - 1)].set(
            jnp.where(do & (chosen >= 0), False,
                      w[jnp.clip(nbx[ci], 0, D - 1), jnp.clip(nby[ci], 0, D - 1)])
        )
        return w, key

    wall, _ = jax.lax.fori_loop(0, D * D, body, (wall, key))
    return wall


def masked_uniform_cell(key, mask):
    """Uniformly choose one True cell of a 2D boolean mask; returns (i, j).

    Distributionally equivalent to the reference's rejection-sampled
    `place_object` (maze_generator.cpp:183-195): uniform over free cells,
    excluding whatever the caller has already masked out.
    """
    H, W = mask.shape
    logits = jnp.where(mask.reshape(-1), 0.0, -jnp.inf)
    flat = jax.random.categorical(key, logits)
    return flat // W, flat % W
