"""RNG oracle tests: libstdc++ draw semantics + maze layout replay."""
import shutil
import subprocess

import numpy as np
import pytest

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="no C++ toolchain"
)


def test_mt19937_reference_values():
    # mt19937(5489) 10000th raw output is the canonical 4123659995
    from procgen2_tpu.tools.rng_oracle import Mt19937

    r = Mt19937(5489)
    v = 0
    for _ in range(10000):
        v = r.raw()
    assert v == 4123659995
    r.close()


def test_determinism_and_distribution():
    from procgen2_tpu.tools.rng_oracle import Mt19937

    a = Mt19937(42)
    b = Mt19937(42)
    seq_a = [a.uniform_int(0, 9) for _ in range(100)]
    seq_b = [b.uniform_int(0, 9) for _ in range(100)]
    assert seq_a == seq_b
    assert set(seq_a) <= set(range(10))
    fa = [a.uniform_float() for _ in range(100)]
    assert all(0.0 <= x < 1.0 for x in fa)
    a.close(); b.close()


def test_handles_are_thread_safe():
    """Threads creating, drawing from and freeing generators at once
    (more threads than cores, frequent switches) each keep their own
    stream: a handle handed out twice would interleave two streams."""
    import os
    import sys
    import threading

    from procgen2_tpu.tools.rng_oracle import Mt19937

    def stream(seed):
        r = Mt19937(seed)
        try:
            return [r.raw() for _ in range(3)]
        finally:
            r.close()

    want = {s: stream(s) for s in range(8)}
    got, errors = {}, []

    def worker(i):
        try:
            for rep in range(2000):
                s = (i + rep) % 8
                if stream(s) != want[s]:
                    errors.append((i, rep, s))
            got[i] = True
        except Exception as e:  # recorded and asserted below
            errors.append(e)

    # (the C side's handle table holds 64)
    n = min(2 * (os.cpu_count() or 4) + 4, 48)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:5]
    assert len(got) == n


def _solvable(wall, start, goal):
    import collections

    D = wall.shape[0]
    seen = {start}
    q = collections.deque([start])
    while q:
        x, y = q.popleft()
        if (x, y) == goal:
            return True
        for dx, dy in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            nx, ny = x + dx, y + dy
            if 0 <= nx < D and 0 <= ny < D and not wall[nx, ny] \
                    and (nx, ny) not in seen:
                seen.add((nx, ny))
                q.append((nx, ny))
    return False


def test_maze_layout_replay_properties():
    from procgen2_tpu.tools.rng_oracle import reference_maze_layout

    dims = set()
    for seed in range(20):
        lay = reference_maze_layout(seed, "easy")
        D = lay["maze_dim"]
        dims.add(D)
        assert D % 2 == 1 and 3 <= D <= 15
        wall = lay["wall"]
        # rooms at even-even coords are open (Kruskal invariant)
        assert not wall[::2, ::2].any()
        # goal on an open, non-start cell
        gi, gj = lay["goal"]
        assert not wall[gi, gj] and (gi, gj) != (0, 0)
        # maze is connected start -> goal
        assert _solvable(wall, (0, 0), (gi, gj))
        assert 0 <= lay["bg_index"] <= 8
        assert 0.0 <= lay["bg_offset"] < 1.0
    assert len(dims) > 1  # seed variety exercises multiple sizes


def test_climber_layout_replay_properties():
    from procgen2_tpu.tools.rng_oracle import reference_climber_layout

    for seed in range(15):
        lay = reference_climber_layout(seed)
        d = lay["difficulty"]
        assert 1 <= d <= 3
        assert d * d + 1 <= lay["num_platforms"] <= (d + 1) ** 2 + 1
        # platforms climb in steps of 3..4 within [1, H)
        assert len(lay["crystals"]) >= 1  # last platform always spawns one
        for (x, y) in lay["crystals"]:
            assert 0 < x < 19
        for (x, y, s) in lay["mobs"]:
            assert 3 <= x <= 16 and s in (-1, 1)
        # borders intact
        g = lay["grid"]
        assert (g[0] == 2).all() and (g[19] == 2).all()
        # floor is wall_top except corners (columns overwrite them,
        # tilemap.cpp:90-93 order)
        assert (g[1:19, 0] == 1).all()


def test_layout_is_seed_deterministic():
    from procgen2_tpu.tools.rng_oracle import reference_maze_layout

    a = reference_maze_layout(1234, "hard")
    b = reference_maze_layout(1234, "hard")
    np.testing.assert_array_equal(a["wall"], b["wall"])
    assert a["goal"] == b["goal"] and a["bg_index"] == b["bg_index"]
