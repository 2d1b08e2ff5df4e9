"""PNG asset overlay + recorded-fixture pixel diff.

The overlay is exercised against a synthetic assets/ tree (the real
reference assets are not redistributed); the fixture diff is exercised
as a round trip through the engine itself, which validates the whole
record -> replay -> compare pipeline bit-exactly.
"""
import os

import numpy as np
import pytest

from procgen2_tpu.render import atlas, png_assets


@pytest.fixture
def fake_assets(tmp_path):
    """A tiny fake reference assets/ tree with two mapped PNGs."""
    from PIL import Image

    # solid magenta cheese, solid cyan coin
    paths = {
        "misc_assets/cheese.png": (255, 0, 255, 255),
        "kenney/Items/coinGold.png": (0, 255, 255, 255),
        "topdown_backgrounds/floortiles.png": (10, 200, 30, 255),
    }
    for rel, color in paths.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        Image.new("RGBA", (96, 96), color).save(p)
    return str(tmp_path)


def test_overlay_install_uninstall(fake_assets):
    try:
        installed = png_assets.install(fake_assets)
        assert "cheese" in installed and "coin" in installed
        assert "backgrounds:topdown" in installed
        # atlas rebuild picks up the override
        imgs, index = atlas.build_atlas(("cheese", "coin", "maze_wall"))
        assert (imgs[index["cheese"]][..., :3] == [255, 0, 255]).all()
        assert (imgs[index["coin"]][..., :3] == [0, 255, 255]).all()
        # unmapped-or-missing sprite keeps procedural art (not solid color)
        assert len(np.unique(imgs[index["maze_wall"]][..., 0])) > 1
        # background overlay tiles modulo the supplied file count
        bgs = atlas.build_backgrounds("topdown", 9)
        assert bgs.shape == (9, atlas.BG_SIZE, atlas.BG_SIZE, 3)
        assert (bgs[0] == [10, 200, 30]).all() and (bgs[8] == [10, 200, 30]).all()
    finally:
        png_assets.uninstall()
    imgs2, index2 = atlas.build_atlas(("cheese",))
    assert not (imgs2[index2["cheese"]][..., :3] == [255, 0, 255]).all()
    assert "topdown" not in atlas._BG_OVERLAY


def test_default_mapping_names_are_registered():
    """Every mapping key must be a real registry sprite (guards doc rot)."""
    unknown = [n for n in png_assets.default_mapping() if n not in atlas._REGISTRY]
    assert unknown == []


REAL_ASSETS = "/root/reference/assets"
_has_real_assets = os.path.isdir(REAL_ASSETS)


@pytest.mark.skipif(not _has_real_assets, reason="reference assets absent")
def test_default_mapping_resolves_against_real_tree():
    """Every mapped path must exist in the actual reference assets tree
    (a typo'd path silently falls back to procedural art otherwise).
    The tree is read-only data; load sites it
    must match: e.g. games/coinrun/coinrun.cpp:296-300, games/coinrun/
    tilemap.cpp:11-36."""
    missing = [
        f"{n} -> {p}"
        for n, p in png_assets.default_mapping().items()
        if not os.path.exists(os.path.join(REAL_ASSETS, p))
    ]
    assert missing == []
    bg_missing = [
        f"{kind}: {rel}"
        for kind, rels in png_assets.BACKGROUND_PATHS.items()
        for rel in rels
        if not os.path.exists(os.path.join(REAL_ASSETS, rel))
    ]
    assert bg_missing == []


@pytest.mark.skipif(not _has_real_assets, reason="reference assets absent")
def test_real_overlay_golden_frames():
    """Strict-install the REAL assets tree (every entry must decode) and
    render oracle-pinned reference levels for all 7 games; frames must
    match the committed goldens bit-exactly. Locks both the mapping and
    the renderer against silent drift (regenerate via
    tests/golden/README.md when a rendering change is intentional)."""
    import jax
    import jax.numpy as jnp

    import procgen2_tpu as pg
    from procgen2_tpu.tools.reference_levels import reference_bank

    golden_path = os.path.join(os.path.dirname(__file__), "golden",
                               "overlay_frames.npz")
    kw_by_game = {"climber": dict(easy_mode=True), "maze": dict(mode="easy")}
    try:
        installed = png_assets.install(REAL_ASSETS, strict=True)
        assert len(installed) >= 130
        with np.load(golden_path) as gold:
            for game in pg.GAMES:
                kw = kw_by_game.get(game, {})
                env = pg.make(game, **kw)
                bank = jax.tree.map(
                    jnp.asarray, reference_bank(game, [0], **kw)
                )
                _, ts = env.reset(
                    bank, jax.random.fold_in(jax.random.key(0), 0), num_envs=1
                )
                assert np.array_equal(np.asarray(ts.obs[0]), gold[game]), game
    finally:
        png_assets.uninstall()


def test_fixture_roundtrip_with_terminating_episode(tmp_path):
    """record -> replay -> compare on the engine itself, ACROSS an
    episode boundary: the fixture's scripted maze run reaches the goal
    (terminal +10 step, terminal frame recorded), then keeps stepping
    into episode 2. Replay must agree 100% on rewards/terminations and
    bit-exactly on pixels, including the terminal frame — the episode
    semantics once found broken (`step_raw` + explicit resets,
    tools/difference.py:_engine_replay)."""
    import jax
    import jax.numpy as jnp

    from procgen2_tpu.tools.difference import (
        record_engine_fixture, run_fixture_diff,
    )
    from procgen2_tpu.tools.reference_levels import reference_bank
    from procgen2_tpu.tools.rng_oracle import reference_maze_layout
    from procgen2_tpu.tools.scripted import NOOP, bfs_actions

    seed = 7
    bank = reference_bank("maze", [seed], mode="easy")
    grid = np.asarray(bank.grid[0])
    lay = reference_maze_layout(seed, "easy")
    m = lay["margin"]
    gi, gj = lay["goal"]
    path = bfs_actions(grid, (14 - m, m), (14 - (gj + m), gi + m))
    assert path is not None
    actions = path + [NOOP] * 4  # cross the boundary into episode 2

    fx = tmp_path / "maze_fixture.npz"
    record_engine_fixture("maze", str(fx), actions, seed=seed, mode="easy")

    with np.load(fx) as data:
        # the fixture itself must show the terminal +10 at the path end
        assert data["rewards"][len(path) - 1] == 10.0
        assert bool(data["terminated"][len(path) - 1])
        assert not data["terminated"][len(path):].any()

    rep = run_fixture_diff(str(fx), episodes="all", mode="easy")
    assert rep["steps_compared"] == len(actions)
    assert rep["reward_agreement"] == 1.0
    assert rep["termination_agreement"] == 1.0
    assert rep["pixel"].mean_abs_diff == 0.0
    assert rep["pixel"].fraction_within_8 == 1.0

    # default mode stops at the fixture's first episode boundary
    rep1 = run_fixture_diff(str(fx), mode="easy")
    assert rep1["steps_compared"] == len(path)
    assert rep1["reward_agreement"] == 1.0
    assert rep1["pixel"].mean_abs_diff == 0.0


def test_signed_diff_image():
    from procgen2_tpu.tools.difference import signed_diff_image

    a = np.full((2, 2, 3), 200, np.uint8)
    b = np.full((2, 2, 3), 100, np.uint8)
    d = signed_diff_image(a, b)
    assert (d > 127).all()  # positive difference maps above mid-grey
    assert (signed_diff_image(b, a) < 128).all()
