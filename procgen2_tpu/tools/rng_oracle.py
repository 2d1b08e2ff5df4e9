"""Reference RNG oracle: predict the C++ engines' levels from a seed.

Binds native/librng_oracle.so (std::mt19937 + libstdc++ distribution
semantics behind a C ABI) and replays the reference's generation-time
draw sequences in Python. This gives bit-exact fixed-seed *layout*
prediction for the reference engines without SDL or a compiled game .so
— the missing piece for fixed-seed parity testing, since jax.random
cannot be seed-matched to std::mt19937 (SURVEY.md §2.4).

Implements full generation replays for all 7 games:
  * maze (games/maze/tilemap.cpp:31-109 + maze_generator.cpp:55-195)
  * climber (games/climber/tilemap.cpp:75-172 + climber.cpp:459-497)
  * bossfight (games/bossfight/bossfight.cpp:426-503)
  * chaser (games/chaser/tilemap.cpp:80-248)
  * jumper (games/jumper/tilemap.cpp:78-240)
  * caveflyer (games/caveflyer/tilemap.cpp:117-277)
  * coinrun (games/coinrun/tilemap.cpp:97-292 + coinrun.cpp:472-507)
including every draw consumed by rejected candidates and short-circuit
conditions. Where the reference makes RNG-indexed choices over
libstdc++ unordered_set iteration order (chaser's agent/egg split,
tilemap.cpp:195-213; jumper/caveflyer's best-room free-cell order),
the replay drives a *real* libstdc++ unordered_set through the same
C ABI (see USet below).

The library is built from native/rng_oracle.cpp at first use (or by
hand: make -C native); it is not tracked by git.
"""
from __future__ import annotations

import ctypes as ct
import os
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native", "librng_oracle.so",
)
_lib = None
# Held while loading the library and while taking or freeing a handle:
# the C side picks free slots of a fixed table without synchronisation,
# and ctypes calls run without the interpreter lock.
_HANDLES = threading.Lock()


def _build():
    """Compile rng_oracle.cpp to a temporary file and rename it into
    place: the rename is atomic, so a concurrent process (a parallel
    test worker) loads either no library or a whole one."""
    native = os.path.dirname(_LIB_PATH)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=native)
    os.close(fd)
    try:
        subprocess.run(
            [os.environ.get("CXX", "g++"), "-O2", "-std=c++17", "-fPIC",
             "-Wall", "-shared", "-o", tmp,
             os.path.join(native, "rng_oracle.cpp")],
            check=True, capture_output=True,
        )
        os.replace(tmp, _LIB_PATH)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib
    if _lib is None:
        if not os.path.exists(_LIB_PATH):
            _build()
        _lib = ct.CDLL(_LIB_PATH)
        _lib.rng_create.restype = ct.c_int32
        _lib.rng_create.argtypes = [ct.c_uint32]
        _lib.rng_raw.restype = ct.c_uint32
        _lib.rng_uniform_int.restype = ct.c_int32
        _lib.rng_uniform_int.argtypes = [ct.c_int32, ct.c_int32, ct.c_int32]
        _lib.rng_uniform_float.restype = ct.c_float
        _lib.rng_uniform_float.argtypes = [ct.c_int32, ct.c_float, ct.c_float]
        if int(_lib.rng_oracle_version()) >= 2:
            _load_uset_symbols(_lib)
    return _lib


class Mt19937:
    """A seeded std::mt19937 with libstdc++ distribution draws."""

    def __init__(self, seed: int):
        with _HANDLES:
            self._lib = _load()
            self._h = self._lib.rng_create(ct.c_uint32(seed & 0xFFFFFFFF))
        if self._h < 0:
            raise RuntimeError("rng_oracle handle pool exhausted")

    def raw(self) -> int:
        return int(self._lib.rng_raw(self._h))

    def uniform_int(self, lo: int, hi: int) -> int:
        """std::uniform_int_distribution<int>(lo, hi) — inclusive bounds."""
        return int(self._lib.rng_uniform_int(self._h, lo, hi))

    def uniform_float(self, lo: float = 0.0, hi: float = 1.0) -> float:
        return float(self._lib.rng_uniform_float(self._h, lo, hi))

    def close(self):
        with _HANDLES:
            self._lib.rng_destroy(self._h)


WALL_CELL, EMPTY_CELL, GOAL = 1, 0, 2
START_CELL = 0  # maze_generator.h: the agent's corner cell index


def reference_maze_layout(seed: int, mode: str = "easy"):
    """Replay the reference maze generation for `seed`.

    Returns dict(maze_dim, margin, wall [dim, dim] bool in maze coords
    (i, j), goal (i, j), bg_index, bg_offset) — exactly what
    libMaze.so's reset() would produce after rng.seed(seed)
    (games/maze/maze.cpp:254,419-430).
    """
    world_dim = {"easy": 15, "hard": 25, "memory": 31}[mode]
    rng = Mt19937(seed)
    try:
        # tilemap.cpp:61-63
        maze_dim = rng.uniform_int(0, (world_dim - 1) // 2 - 1) * 2 + 3
        margin = (world_dim - maze_dim) // 2

        # --- generate_maze (maze_generator.cpp:55-139) ---
        D = maze_dim
        grid = np.ones((D, D), np.int8)  # WALL_CELL (unpadded view)
        grid[0, 0] = EMPTY_CELL
        walls = []  # (x1, y1, x2, y2)
        for i in range(1, D - 1, 2):
            for j in range(0, D, 2):
                walls.append((i - 1, j, i + 1, j))
        for i in range(0, D, 2):
            for j in range(1, D - 1, 2):
                walls.append((i, j - 1, i, j + 1))

        parent = np.arange(D * D, dtype=np.int64)
        rank = np.zeros(D * D, np.int64)
        free_cells: list[int] = []
        free_set: set[int] = set()

        def find(c):
            while parent[c] != c:
                parent[c] = parent[parent[c]]
                c = parent[c]
            return c

        def add_free(x, y):
            grid[x, y] = EMPTY_CELL
            idx = y + D * x
            if idx not in free_set:
                free_set.add(idx)
                free_cells.append(idx)

        while walls:
            n = rng.uniform_int(0, len(walls) - 1)
            x1, y1, x2, y2 = walls[n]
            s0 = find(y1 + D * x1)
            s1 = find(y2 + D * x2)
            x0, y0 = (x1 + x2) // 2, (y1 + y2) // 2
            center = y0 + D * x0
            if grid[x0, y0] == WALL_CELL and s0 != s1:
                add_free(x1, y1)
                add_free(x0, y0)
                add_free(x2, y2)
                if rank[s0] > rank[s1]:
                    parent[s1] = s0
                    parent[center] = s0
                else:
                    parent[s0] = s1
                    parent[center] = s1
                    if rank[s0] == rank[s1]:
                        rank[s1] += 1
            walls.pop(n)

        # --- place_object(GOAL) (maze_generator.cpp:183-195) ---
        fc = list(free_cells)
        idx = rng.uniform_int(0, len(fc) - 1)
        while fc[idx] == START_CELL:
            idx = rng.uniform_int(0, len(fc) - 1)
        goal_cell = fc[idx]
        goal = (goal_cell // D, goal_cell % D)

        # --- theming draws (maze.cpp:424-430) ---
        bg_index = rng.uniform_int(0, 8)
        bg_offset = rng.uniform_float(0.0, 1.0)

        return dict(
            maze_dim=maze_dim,
            margin=margin,
            wall=grid == WALL_CELL,
            goal=goal,
            bg_index=bg_index,
            bg_offset=bg_offset,
        )
    finally:
        rng.close()


def reference_climber_layout(seed: int, easy_mode: bool = False):
    """Replay the reference climber generation for `seed`.

    Draw order follows System_Tilemap::regenerate
    (games/climber/tilemap.cpp:99-171) and the post-regenerate theming
    draws in reset() (climber.cpp:466-492). Returns tile grid in (x,
    y_up) coords plus mob/crystal placements and theme indices.
    """
    W, H = 20, 64  # tilemap.cpp:76-77
    rng = Mt19937(seed)
    try:
        grid = np.zeros((W, H), np.int8)  # 0 empty, 1 top, 2 mid
        grid[:, 0] = 1  # set_area_with_top h=1 -> top row
        grid[0, :] = 2
        grid[W - 1, :] = 2
        grid[:, H - 1] = 2

        difficulty = rng.uniform_int(1, 3)  # tilemap.cpp:99-101
        num_platforms = rng.uniform_int(
            difficulty * difficulty + 1, (difficulty + 1) ** 2 + 1
        )
        curr_x = rng.uniform_int(2, W - 3)  # init_x_dist(2, 17)
        curr_y = 1
        enemy_prob = 0.2 if easy_mode else 0.5
        max_dy = int(1.5 * 1.5 / (2.0 * 0.2) - 0.5)  # = 5

        mobs = []  # (x, y_up, vx_sign)
        crystals = []  # (x, y_up)
        for p in range(num_platforms):
            delta_y = rng.uniform_int(3, max_dy - 1)
            can_spawn = 3 <= curr_x <= W - 4
            if can_spawn and rng.uniform_float() < enemy_prob:
                # arg expression draws dist2 first, then spawn draws the
                # velocity sign (tilemap.cpp:40-41,134-135)
                mob_y = curr_y + rng.uniform_int(0, 1) + 2
                vx_sign = rng.uniform_int(0, 1) * 2 - 1
                mobs.append((curr_x, mob_y, vx_sign))
            curr_y += delta_y
            plat_len = 2 + rng.uniform_int(0, 9)
            vx = rng.uniform_int(0, 1) * 2 - 1
            if curr_x < 3:
                vx = 1
            if curr_x > W - 3:
                vx = -1
            candidates = []
            for j in range(plat_len):
                nx = curr_x + (j + 1) * vx
                if nx <= 0 or nx >= W - 1:
                    break
                candidates.append(nx)
                if curr_y < H:
                    grid[nx, curr_y] = 1  # wall_top
            if rng.uniform_float() < 0.5 or p == num_platforms - 1:
                crystals.append(
                    (candidates[rng.uniform_int(0, len(candidates) - 1)],
                     curr_y + 1)
                )
            curr_x = candidates[rng.uniform_int(0, len(candidates) - 1)]

        # reset() theming draws (climber.cpp:466-492)
        bg_index = rng.uniform_int(0, 48)
        bg_offset = rng.uniform_float()
        agent_theme = rng.uniform_int(0, 3)
        map_theme = rng.uniform_int(0, 3)
        return dict(
            difficulty=difficulty,
            num_platforms=num_platforms,
            grid=grid,
            mobs=mobs,
            crystals=crystals,
            bg_index=bg_index,
            bg_offset=bg_offset,
            agent_theme=agent_theme,
            map_theme=map_theme,
        )
    finally:
        rng.close()


# ---------------------------------------------------------------------------
# libstdc++ unordered_set<int> (iteration-order oracle)
# ---------------------------------------------------------------------------

class USet:
    """A real libstdc++ std::unordered_set<int> behind the C ABI.

    Needed wherever the reference makes RNG-indexed choices over
    containers ordered by unordered_set iteration: jumper/caveflyer's
    `free_cells` from `best_room` (games/jumper/tilemap.cpp:146-151),
    chaser's agent-vs-egg split (games/chaser/tilemap.cpp:195-213).
    """

    def __init__(self):
        with _HANDLES:
            self._lib = _load()
            self._h = self._lib.uset_create()
        if self._h < 0:
            raise RuntimeError("uset handle pool exhausted")

    def insert(self, v: int):
        self._lib.uset_insert(self._h, ct.c_int32(v))

    def contains(self, v: int) -> bool:
        return bool(self._lib.uset_contains(self._h, ct.c_int32(v)))

    def size(self) -> int:
        return int(self._lib.uset_size(self._h))

    def items(self) -> list:
        """Elements in libstdc++ iteration order (begin -> end)."""
        n = self.size()
        buf = (ct.c_int32 * max(n, 1))()
        m = self._lib.uset_iterate(self._h, buf, n)
        return list(buf[:m])

    def assign_from(self, other: "USet"):
        """Copy-assignment `*this = other` (preserves the copy's order
        semantics, room_generator.cpp:158-162)."""
        self._lib.uset_assign(self._h, other._h)

    def close(self):
        with _HANDLES:
            self._lib.uset_destroy(self._h)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def _load_uset_symbols(lib):
    lib.uset_create.restype = ct.c_int32
    lib.uset_insert.argtypes = [ct.c_int32, ct.c_int32]
    lib.uset_contains.restype = ct.c_int32
    lib.uset_contains.argtypes = [ct.c_int32, ct.c_int32]
    lib.uset_size.restype = ct.c_int32
    lib.uset_size.argtypes = [ct.c_int32]
    lib.uset_iterate.restype = ct.c_int32
    lib.uset_assign.argtypes = [ct.c_int32, ct.c_int32]


# ---------------------------------------------------------------------------
# Shared generator machinery (set-merge Kruskal, CA rooms, BFS)
# ---------------------------------------------------------------------------

def _set_merge_kruskal(rng: Mt19937, mw: int, mh: int) -> np.ndarray:
    """Replay Maze_Generator::generate_maze (games/jumper/
    maze_generator.cpp:47-131; chaser/caveflyer vendor the same code).

    Returns the padded grid [(mw+2), (mh+2)] indexed [x, y], 1 = wall.
    The RNG stream only sees the wall-index draws (one per loop trip), so
    the set-merge bookkeeping can be plain Python: merge outcomes are
    order-independent.
    """
    aw, ah = mw + 2, mh + 2
    grid = np.ones((aw, ah), np.int8)
    grid[1, 1] = 0  # corner cell (maze_generator.cpp:61)

    sets_idx = np.arange(mw * mh)  # cell -> set id (cell_sets_indices)
    members: dict = {i: [i] for i in range(mw * mh)}

    walls = []
    for i in range(1, mw, 2):
        for j in range(0, mh, 2):
            if 0 < i < mw - 1:
                walls.append((i - 1, j, i + 1, j))
    for i in range(0, mw, 2):
        for j in range(1, mh, 2):
            if 0 < j < mh - 1:
                walls.append((i, j - 1, i, j + 1))

    while walls:
        n = rng.uniform_int(0, len(walls) - 1)
        x1, y1, x2, y2 = walls[n]
        s0 = int(sets_idx[y1 + mh * x1])
        s1 = int(sets_idx[y2 + mh * x2])
        x0, y0 = (x1 + x2) // 2, (y1 + y2) // 2
        center = y0 + mh * x0
        if grid[x0 + 1, y0 + 1] == 1 and s0 != s1:
            grid[x1 + 1, y1 + 1] = 0
            grid[x0 + 1, y0 + 1] = 0
            grid[x2 + 1, y2 + 1] = 0
            # s1->insert(s0 union {center}); all members repoint to s1
            moved = members.pop(s0)
            members[s1].extend(moved)
            if center not in members[s1]:
                members[s1].append(center)
            for c in moved:
                sets_idx[c] = s1
            sets_idx[center] = s1
        walls.pop(n)
    return grid


def _no_dead_ends_pass(grid: np.ndarray, rng: Mt19937):
    """Replay generate_maze_no_dead_ends' dead-end opener
    (maze_generator.cpp:133-200), including its neighbor-indexing quirk:
    the random choice indexes the first `num_adjacent_walls` entries of
    the (left, right, down, up) neighbor array, not the wall subset."""
    aw, ah = grid.shape

    def neighbors(x, y):
        return [(x - 1, y), (x + 1, y), (x, y - 1), (x, y + 1)]

    for i in range(aw * ah):
        x, y = i // ah, i % ah
        if grid[x, y] != 0:
            continue
        nb = neighbors(x, y)
        vals = [grid[nx, ny] for nx, ny in nb]
        n_spaces = sum(v == 0 for v in vals)
        n_walls = sum(v == 1 for v in vals)
        if n_spaces == 1 and n_walls > 0:
            n_select = rng.uniform_int(0, n_walls - 1)
            for n in range(4):
                n_offset = (n_select + n) % n_walls
                nx, ny = nb[n_offset]
                if 1 <= nx < aw - 1 and 1 <= ny < ah - 1 and grid[nx, ny] == 1:
                    grid[nx, ny] = 0
                    break


def _ca_update(grid: np.ndarray) -> np.ndarray:
    """Room_Generator::update (room_generator.cpp:21-36): Moore-9 count
    of walls >= 5 -> wall. `grid` is [W, H] indexed [x, y]; out-of-bounds
    reads are walls (room_generator.h get)."""
    W, H = grid.shape
    padded = np.ones((W + 2, H + 2), grid.dtype)
    padded[1:-1, 1:-1] = grid
    c = sum(
        padded[1 + i : W + 1 + i, 1 + j : H + 1 + j]
        for i in (-1, 0, 1)
        for j in (-1, 0, 1)
    )
    return (c >= 5).astype(grid.dtype)


def _build_room(grid: np.ndarray, index: int, room: USet):
    """Room_Generator::build_room (room_generator.cpp:38-78): BFS flood
    in exact reference order; `room` receives the exact libstdc++
    insertion sequence (the seed cell enters only via a neighbor's
    scan, reproducing the reference's skip)."""
    from collections import deque

    W, H = grid.shape
    if grid.flat[index] != 0:
        return
    q = deque([index])
    while q:
        cur = q.popleft()
        if grid.flat[cur] != 0:
            continue
        x, y = cur // H, cur % H
        for nx, ny in ((x - 1, y), (x, y - 1), (x, y + 1), (x + 1, y)):
            if nx < 0 or ny < 0 or nx >= W or ny >= H:
                continue
            ni = ny + H * nx
            if not room.contains(ni) and grid[nx, ny] == 0:
                q.append(ni)
                room.insert(ni)


def _find_best_room(grid: np.ndarray) -> list:
    """Room_Generator::find_best_room (room_generator.cpp:145-166):
    returns the largest room's cells in libstdc++ iteration order."""
    W, H = grid.shape
    best: list = []
    seen = set()
    best_size = -1
    for i in range(W * H):
        if grid.flat[i] == 0 and i not in seen:
            with USet() as room:
                _build_room(grid, i, room)
                items = room.items()
            seen.update(items)
            if len(items) > best_size:
                best_size = len(items)
                best = items
    return best


def _find_path(grid: np.ndarray, src: int, dst: int) -> list:
    """Room_Generator::find_path (room_generator.cpp:80-143): BFS with
    the reference's neighbor order; returns src..dst inclusive."""
    W, H = grid.shape
    if grid.flat[src] != 0:
        return []
    expanded = [src]
    parents = [-1]
    covered = set()
    si = 0
    while si < len(expanded):
        cur = expanded[si]
        if cur == dst:
            break
        x, y = cur // H, cur % H
        for nx, ny in ((x - 1, y), (x, y - 1), (x, y + 1), (x + 1, y)):
            if nx < 0 or ny < 0 or nx >= W or ny >= H:
                continue
            ni = ny + H * nx
            if ni not in covered and grid[nx, ny] == 0:
                expanded.append(ni)
                parents.append(si)
                covered.add(ni)
        si += 1
    if si < len(expanded) and expanded[si] == dst:
        path = []
        while si >= 0:
            path.append(expanded[si])
            si = parents[si]
        return path[::-1]
    return []


def _expand_room(grid: np.ndarray, cells: set, n: int) -> set:
    """Room_Generator::expand_room (room_generator.cpp:168-202): dilate
    `cells` n times over Moore neighborhoods restricted to spaces. The
    result is a pure union — order-independent, so Python sets suffice."""
    W, H = grid.shape
    out = set(cells)
    current = set(cells)
    for _ in range(n):
        nxt = set()
        for ci in current:
            if grid.flat[ci] != 0:
                continue
            x, y = ci // H, ci % H
            for i in (-1, 0, 1):
                for j in (-1, 0, 1):
                    if i == 0 and j == 0:
                        continue
                    nx, ny = x + i, y + j
                    if nx < 0 or ny < 0 or nx >= W or ny >= H:
                        continue
                    ni = ny + H * nx
                    if ni not in out and grid[nx, ny] == 0:
                        out.add(ni)
                        nxt.add(ni)
        current = nxt
    return out


# ---------------------------------------------------------------------------
# Per-game layout replays
# ---------------------------------------------------------------------------

def reference_bossfight_layout(seed: int):
    """Replay the reference bossfight reset for `seed`
    (games/bossfight/bossfight.cpp:426-503).

    Positions use the renderer's default obs camera (64 px / scale 1,
    renderer.h:18-20), giving the half-extent 64 * pixels_to_unit * 0.5
    = 2.0 world units. Barrier texture draws are *skipped* for rejected
    (overlapping) candidates; rejected slots keep a {0,0,0,0} rect that
    still participates in later overlap tests (bossfight.cpp:462-497).
    """
    half = 64.0 * (1.0 / 16.0) * 0.5  # = 2.0
    rng = Mt19937(seed)
    try:
        agent_x = rng.uniform_float(-1.0, 1.0) * half
        agent_pos = (agent_x, half)

        num_barriers = rng.uniform_int(1, 4)
        rects = []  # world rects used for the overlap chain
        barriers = []  # (x, y, tex) of *accepted* barriers
        for _ in range(num_barriers):
            bx = rng.uniform_float(-1.0, 1.0) * half * 0.9
            by = half - rng.uniform_float(0.7, 1.2)
            r = (bx - 0.1, by - 0.1, 0.2, 0.2)
            clash = any(
                r[0] < o[0] + o[2] and r[0] + r[2] > o[0]
                and r[1] < o[1] + o[3] and r[1] + r[3] > o[1]
                for o in rects
            )
            if not clash:
                tex = rng.uniform_int(0, 7)
                barriers.append((bx, by, tex))
                rects.append(r)
            else:
                rects.append((0.0, 0.0, 0.0, 0.0))

        bg_index = rng.uniform_int(0, 12)
        bg_off_x = rng.uniform_float()
        bg_off_y = rng.uniform_float()
        agent_ship = rng.uniform_int(0, 3)
        agent_bullet = rng.uniform_int(0, 2)
        boss_ship = rng.uniform_int(0, 3)
        boss_bullet = rng.uniform_int(0, 2)
        return dict(
            agent_pos=agent_pos,
            barriers=barriers,
            bg_index=bg_index,
            bg_off=(bg_off_x, bg_off_y),
            agent_ship=agent_ship,
            agent_bullet=agent_bullet,
            boss_ship=boss_ship,
            boss_bullet=boss_bullet,
        )
    finally:
        rng.close()


def reference_chaser_layout(seed: int, mode: str = "easy"):
    """Replay the reference chaser generation for `seed`
    (games/chaser/tilemap.cpp:80-248 + chaser.cpp reset theming).

    Returns wall grid [D, D] indexed (x, y_up), orb cells, egg cells,
    agent spawn cell and bg theming. The agent-vs-egg split follows
    libstdc++ unordered_set iteration order (tilemap.cpp:195-213)."""
    world_dim, total_enemies, extra_orb_sign = {
        "easy": (11, 3, 0), "hard": (13, 3, -1), "extreme": (19, 5, 1),
    }[mode]
    D = world_dim
    rng = Mt19937(seed)
    try:
        padded = _set_merge_kruskal(rng, D, D)
        wall = padded[1 : D + 1, 1 : D + 1].copy()  # get(x+1, y+1)

        extra_quad = rng.uniform_int(0, 3)
        orbs_for_quadrant = [
            1 + (extra_orb_sign if i == extra_quad else 0) for i in range(4)
        ]
        quadrants = [[] for _ in range(4)]
        tile = np.where(wall == 1, 1, 0).astype(np.int8)  # 1 wall, 0 empty
        MARKER = 3
        for x in range(D):
            for y in range(D):
                if wall[x, y] == 0:
                    quad = (x >= D // 2) * 2 + (y >= D // 2)
                    quadrants[quad].append(y + x * D)

        orb_cells = []
        for i in range(4):
            quadrant = quadrants[i]
            selected = USet()
            for _ in range(orbs_for_quadrant[i]):
                pos = rng.uniform_int(0, len(quadrant) - 1)
                while selected.contains(pos):
                    pos = (pos + 1) % len(quadrant)
                selected.insert(pos)
            # spawn order follows set iteration (cells are order-free here)
            for j in selected.items():
                cell = quadrant[j]
                orb_cells.append(cell)
                tile[cell // D, cell % D] = MARKER
            selected.close()

        # Reference flattening: index = y + x * map_height; scanning
        # tile_ids ascending equals (x, y) lexicographic — match it.
        free_cells = []
        for x in range(D):
            for y in range(D):
                if tile[x, y] == 0:
                    free_cells.append(y + x * D)

        selected = USet()
        for _ in range(total_enemies + 1):
            pos = rng.uniform_int(0, len(free_cells) - 1)
            while selected.contains(pos):
                pos = (pos + 1) % len(free_cells)
            selected.insert(pos)
        order = selected.items()
        selected.close()
        start = free_cells[order[0]]
        agent_cell = (start // D, start % D)  # (x, y_up)
        egg_cells = []
        for idx in order[1:]:
            cell = free_cells[idx]
            egg_cells.append(cell)
            tile[cell // D, cell % D] = MARKER
        tile[start // D, start % D] = MARKER

        point_cells = []
        for x in range(D):
            for y in range(D):
                if tile[x, y] == 0:
                    point_cells.append(y + x * D)

        bg_index = rng.uniform_int(0, 8)
        bg_off_x = rng.uniform_float()
        return dict(
            wall=wall == 1,
            orb_cells=orb_cells,
            egg_cells=egg_cells,
            agent_cell=agent_cell,
            point_cells=point_cells,
            bg_index=bg_index,
            bg_off_x=bg_off_x,
        )
    finally:
        rng.close()


def reference_jumper_layout(seed: int, mode: str = "easy"):
    """Replay the reference jumper generation for `seed`
    (games/jumper/tilemap.cpp:78-240 + jumper.cpp reset theming).

    Returns tile grid [D, D] indexed (x, y_up) with 0 empty / 2 wall_mid
    / 3 spike, goal cell, agent cell, and theming. free_cells order (and
    hence the goal draw) follows libstdc++ unordered_set iteration of
    the best room (tilemap.cpp:146-155)."""
    D = {"easy": 20, "hard": 40, "memory": 45}[mode]
    EMPTY, WALL_MID, SPIKE = 0, 2, 3
    rng = Mt19937(seed)
    try:
        maze_scale = 3
        maze_dim = D // maze_scale
        padded = _set_merge_kruskal(rng, maze_dim, maze_dim)
        _no_dead_ends_pass(padded, rng)

        # wall-probability prior + CA smoothing (tilemap.cpp:110-122)
        tiles = np.zeros((D, D), np.int8)  # indexed (x, y)
        room = np.zeros((D, D), np.int8)
        for i in range(D * D):
            x, y = i // D, i % D
            obj = padded[x // maze_scale + 1, y // maze_scale + 1]
            prob = 0.8 if obj == 1 else 0.2
            is_wall = rng.uniform_float() < prob
            tiles[x, y] = WALL_MID if is_wall else EMPTY
            room[x, y] = 1 if is_wall else 0
        for _ in range(2):
            room = _ca_update(room)
        # border (tilemap.cpp:124-139)
        room[:, 0] = 1
        room[:, D - 1] = 1
        room[0, :] = 1
        room[D - 1, :] = 1

        best = _find_best_room(room)
        tiles[:, :] = WALL_MID
        free_cells = []
        for i in best:
            tiles[i // D, i % D] = EMPTY
            free_cells.append(i)

        goal_cell = free_cells[rng.uniform_int(0, len(free_cells) - 1)]

        def get(x, y):
            if x < 0 or y < 0 or x >= D or y >= D:
                return WALL_MID
            return tiles[x, y]

        def is_space_on_ground(x, y):
            if get(x, y) != EMPTY:
                return False
            if get(x, y + 1) != EMPTY:
                return False
            below = get(x, y - 1)
            return below == WALL_MID or below == 1  # wall_top unused here

        agent_candidates = []
        for x in range(D):
            for y in range(D):
                i = y + D * x
                if is_space_on_ground(x, y) and i != goal_cell:
                    agent_candidates.append(i)
        agent_cell = agent_candidates[
            rng.uniform_int(0, len(agent_candidates) - 1)
        ]

        goal_path = _find_path(room, agent_cell, goal_cell)
        if mode != "memory":
            wide = _expand_room(room, set(goal_path), 4)
            tiles[:, :] = WALL_MID
            for i in wide:
                tiles[i // D, i % D] = EMPTY

        spike_prob = 0.0 if mode == "memory" else 0.2
        for x in range(D):
            for y in range(D):
                if (is_space_on_ground(x, y) and is_space_on_ground(x - 1, y)
                        and is_space_on_ground(x + 1, y)):
                    if rng.uniform_float() < spike_prob:
                        tiles[x, y] = SPIKE

        # long-vertical-wall breakup (tilemap.cpp:222-233); mutates as it
        # scans, matching the reference's in-place set() calls
        def is_left_wall(x, y):
            return get(x, y) == WALL_MID and get(x + 1, y) == EMPTY

        def is_right_wall(x, y):
            return get(x, y) == WALL_MID and get(x - 1, y) == EMPTY

        for x in range(D):
            for y in range(D):
                if (is_left_wall(x, y) and is_left_wall(x, y + 1)
                        and is_left_wall(x, y + 2)):
                    yy = y + rng.uniform_int(0, 2)
                    if 0 <= yy < D:
                        tiles[x, yy] = EMPTY
                if (is_right_wall(x, y) and is_right_wall(x, y + 1)
                        and is_right_wall(x, y + 2)):
                    yy = y + rng.uniform_int(0, 2)
                    if 0 <= yy < D:
                        tiles[x, yy] = EMPTY

        # spikes become entities; tile reverts to empty (tilemap.cpp:238+)
        spike_cells = [(x, y) for x in range(D) for y in range(D)
                       if tiles[x, y] == SPIKE]

        bg_index = rng.uniform_int(0, 48)
        bg_off_x = rng.uniform_float()
        map_theme = rng.uniform_int(0, 3)
        return dict(
            tiles=tiles,
            goal_cell=(goal_cell // D, goal_cell % D),
            agent_cell=(agent_cell // D, agent_cell % D),
            spike_cells=spike_cells,
            bg_index=bg_index,
            bg_off_x=bg_off_x,
            map_theme=map_theme,
        )
    finally:
        rng.close()


def reference_caveflyer_layout(seed: int, mode: str = "easy"):
    """Replay the reference caveflyer generation for `seed`
    (games/caveflyer/tilemap.cpp:117-277 + caveflyer.cpp reset theming).

    Note the reference's post-prune CA loop (tilemap.cpp:220-225)
    evolves the *room generator's* grid, never copying back into
    tile_ids — a no-op on the map apart from re-clearing the goal path;
    it also consumes no RNG, so the replay skips it."""
    D = {"easy": 20, "hard": 40, "memory": 45}[mode]
    EMPTY, WALL = 0, 1
    rng = Mt19937(seed)
    try:
        room = np.zeros((D, D), np.int8)
        for i in range(D * D):
            room[i // D, i % D] = 1 if rng.uniform_float() < 0.5 else 0
        for _ in range(2):
            room = _ca_update(room)

        best = _find_best_room(room)
        tiles = np.where(room == 1, WALL, EMPTY).astype(np.int8)
        free_cells = []
        for i in best:
            tiles[i // D, i % D] = EMPTY
            free_cells.append(i)

        goal_index = rng.uniform_int(0, len(free_cells) - 1)
        agent_index = rng.uniform_int(0, len(free_cells) - 1)
        if agent_index == goal_index:
            agent_index = (agent_index + 1) % len(free_cells)
        goal_cell = free_cells[goal_index]
        agent_cell = free_cells[agent_index]
        agent_pos = (agent_cell // D + 0.5, D - 1 - (agent_cell % D))

        goal_path = _find_path(room, agent_cell, goal_cell)
        if mode != "memory":
            wide = _expand_room(room, set(goal_path), 4)
            tiles[:, :] = WALL
            for i in wide:
                tiles[i // D, i % D] = EMPTY
        for i in goal_path:
            tiles[i // D, i % D] = EMPTY  # kept open each CA iteration

        MARKER = 9
        for i in goal_path:
            tiles[i // D, i % D] = MARKER

        free_cells = []
        for x in range(D):
            for y in range(D):
                if tiles[x, y] == EMPTY:
                    free_cells.append(y + x * D)

        chunk = len(free_cells) // 80
        num_objects = 3 * chunk
        obstacle_indices = []
        obstacles, targets, enemies = [], [], []
        for i in range(num_objects):
            index = rng.uniform_int(0, len(free_cells) - 1)
            while index in obstacle_indices:
                index = (index + 1) % len(free_cells)
            obstacle_indices.append(index)
            cell = free_cells[index]
            if i < chunk:
                obstacles.append(cell)
            elif i < 2 * chunk:
                targets.append(cell)
            else:
                # spawn_enemy draws (tilemap.cpp spawn_enemy): magnitude,
                # sign, then axis only when not near the agent spawn
                x, y = cell // D, cell % D
                pos = (x + 0.5, D - 1 - y + 0.5)
                mag = 0.1 * rng.uniform_float() + 0.1
                sign = 1.0 if rng.uniform_float() < 0.5 else -1.0
                vel_component = mag * sign
                eps, nb = 0.001, 2.0
                if (abs(pos[0] - agent_pos[0]) <= eps
                        and abs(pos[1] - agent_pos[1]) <= nb):
                    collision = 1
                elif (abs(pos[0] - agent_pos[0]) <= nb
                        and abs(pos[1] - agent_pos[1]) <= eps):
                    collision = 2
                else:
                    collision = 0
                if collision == 0:
                    axis = 0 if rng.uniform_float() < 0.5 else 1
                elif collision == 1:
                    axis = 0
                else:
                    axis = 1
                enemies.append((cell, vel_component if axis == 0 else 0.0,
                                vel_component if axis == 1 else 0.0))

        for x in range(D):
            for y in range(D):
                if tiles[x, y] == MARKER:
                    tiles[x, y] = EMPTY

        bg_index = rng.uniform_int(0, 12)
        bg_off_x = rng.uniform_float()
        return dict(
            tiles=tiles == WALL,
            goal_cell=(goal_cell // D, goal_cell % D),
            agent_cell=(agent_cell // D, agent_cell % D),
            obstacles=obstacles,
            targets=targets,
            enemies=enemies,
            bg_index=bg_index,
            bg_off_x=bg_off_x,
        )
    finally:
        rng.close()


def reference_coinrun_layout(seed: int, easy_mode: bool = False,
                             allow_pit: bool = True, allow_crate: bool = True,
                             allow_dy: bool = True, allow_mobs: bool = True):
    """Replay the reference coinrun generation for `seed`
    (games/coinrun/tilemap.cpp:97-292 + coinrun.cpp:472-507 theming).

    Returns the 64x64 tile grid indexed (x, y_up) with the reference's
    tile ids (tilemap.h:13-21: 0 empty, 1 wall_top, 2 wall_mid,
    3 lava_top, 4 lava_mid, 5 crate), saw/mob spawns, the coin cell and
    theming draws. Draw conditions that short-circuit (pit roll only
    when allow_pit && dx>7 && curr_y>3; mob roll only when allow_mobs)
    are replayed exactly.
    """
    EMPTY, WALL_TOP, WALL_MID, LAVA_TOP, LAVA_MID, CRATE = 0, 1, 2, 3, 4, 5
    W = H = 64
    rng = Mt19937(seed)
    try:
        tiles = np.zeros((W, H), np.int8)
        crate_types = np.zeros((W, H), np.int8)
        tiles[:, 0] = WALL_TOP        # floor (set_area, tilemap.cpp:111-115)
        tiles[0, :] = WALL_MID
        tiles[W - 1, :] = WALL_MID
        tiles[:, H - 1] = WALL_MID

        def set_area_with_top(x0, y0, w, h, mid, top):
            # set_area_with_top: fill h rows of mid from y0, then top row
            for x in range(x0, x0 + w):
                for y in range(y0, y0 + h):
                    if 0 <= x < W and 0 <= y < H:
                        tiles[x, y] = mid
                y = y0 + h - 1
                if 0 <= x < W and 0 <= y < H:
                    tiles[x, y] = top

        difficulty = rng.uniform_int(1, 3)
        num_sections = rng.uniform_int(difficulty, 2 * difficulty - 1)
        danger_type = rng.uniform_int(0, 2)

        curr_x, curr_y = 5, 1
        pit_thresh = difficulty
        doff = difficulty // 3
        max_dx = int(0.5 * 2.0 * 1.5 / 0.2 - 0.5)  # 7
        max_dy = int(1.5 * 1.5 / (2.0 * 0.2) - 0.5)  # 5

        saws = []   # (x, y_up) cells
        mobs = []   # (x, y_up, enemy_index, vx_sign)
        crates = []  # (x, y_up, type)

        def spawn_mob(x, y):
            enemy_index = rng.uniform_int(0, 8)  # 9 walking_enemies
            vx = 0.15 * ((1.0 if rng.uniform_float() < 0.5 else 0.0) * 2.0 - 1.0)
            mobs.append((x, y, enemy_index, vx))

        for _section in range(num_sections):
            if curr_x + 15 >= W:
                break
            dy = rng.uniform_int(1 + doff, 4 + doff) if allow_dy else 0
            dy = min(dy, max_dy)
            if curr_y >= 20:
                dy = -dy                       # no draw (short-circuit)
            elif curr_y >= 5 and rng.uniform_float() < 0.5:
                dy = -dy
            dx = rng.uniform_int(3 + doff, 2 * difficulty + 2 + doff)
            curr_y = max(1, curr_y + dy)

            use_pit = (allow_pit and dx > 7 and curr_y > 3
                       and rng.uniform_int(0, 19) >= pit_thresh)

            if use_pit:
                x1 = rng.uniform_int(1, 3)
                x2 = rng.uniform_int(1, 3)
                pit_width = dx - x1 - x2
                if pit_width > max_dx:
                    pit_width = max_dx
                    x2 = dx - x1 - pit_width
                set_area_with_top(curr_x, 0, x1, curr_y, WALL_MID, WALL_TOP)
                set_area_with_top(curr_x + dx - x2, 0, x2, curr_y,
                                  WALL_MID, WALL_TOP)
                lava_height = rng.uniform_int(1, curr_y - 3)
                if danger_type == 0:
                    set_area_with_top(curr_x + x1, 1, pit_width, lava_height,
                                      LAVA_MID, LAVA_TOP)
                elif danger_type == 1:
                    for i in range(pit_width):
                        saws.append((curr_x + x1 + i, 1))
                else:
                    for i in range(pit_width):
                        spawn_mob(curr_x + x1 + i, 1)
                if pit_width > 4:
                    if pit_width == 5:
                        x3 = rng.uniform_int(1, 2)
                        w1 = rng.uniform_int(1, 2)
                    elif pit_width == 6:
                        x3 = rng.uniform_int(1, 2) + 1
                        w1 = rng.uniform_int(1, 2)
                    else:
                        x3 = rng.uniform_int(1, 2) + 1
                        x4 = rng.uniform_int(1, 2) + 1
                        w1 = pit_width - x3 - x4
                    set_area_with_top(curr_x + x1 + x3, curr_y - 1, w1, 1,
                                      WALL_MID, WALL_TOP)
            else:
                set_area_with_top(curr_x, 0, dx, curr_y, WALL_MID, WALL_TOP)
                ob1_x = -1
                ob2_x = -1
                if rng.uniform_int(0, 9) < 2 * difficulty and dx > 3:
                    ob1_x = curr_x + rng.uniform_int(1, dx - 2)
                    saws.append((ob1_x, curr_y))
                if allow_mobs:
                    roll = rng.uniform_int(0, 9)
                    if roll < difficulty and dx > 3 and max_dx >= 4:
                        ob1_x = curr_x + rng.uniform_int(1, dx - 2)
                        spawn_mob(ob1_x, curr_y)
                if allow_crate:
                    for _ in range(2):
                        crate_x = curr_x + rng.uniform_int(1, dx - 2)
                        if (rng.uniform_float() < 0.5 and ob1_x != crate_x
                                and ob2_x != crate_x):
                            pile = rng.uniform_int(1, 3)
                            for j in range(pile):
                                if curr_y + j < H:
                                    tiles[crate_x, curr_y + j] = CRATE
                                    ct_i = rng.uniform_int(0, 3)
                                    crate_types[crate_x, curr_y + j] = ct_i
                                    crates.append((crate_x, curr_y + j, ct_i))
                                else:
                                    crate_types[crate_x % W, 0] = \
                                        rng.uniform_int(0, 3)
            curr_x += dx

        coin_cell = (curr_x, curr_y)
        set_area_with_top(curr_x, 0, 1, curr_y, WALL_MID, WALL_TOP)
        for x in range(curr_x + 1, W):
            tiles[x, :] = WALL_MID

        bg_index = rng.uniform_int(0, 48)
        bg_off_x = rng.uniform_float()
        agent_theme = rng.uniform_int(0, 4)
        map_theme = rng.uniform_int(0, 5)
        return dict(
            difficulty=difficulty,
            danger_type=danger_type,
            tiles=tiles,
            crate_types=crate_types,
            saws=saws,
            mobs=mobs,
            crates=crates,
            coin_cell=coin_cell,
            bg_index=bg_index,
            bg_off_x=bg_off_x,
            agent_theme=agent_theme,
            map_theme=map_theme,
        )
    finally:
        rng.close()
