"""Scene compositor for the quantized-camera games (coinrun, climber,
jumper, caveflyer).

With the render camera quantized to texel phases (render/phases.py) the
scrolling tile layer and background collapse to per-pixel selects from a
pre-pixelized tile bank:

  1. the tile-kind grid and the background texture are cut to a
     WIN x WIN tile window around each env's camera and lifted to pixel
     resolution by the phase's 0/1 expansion tables (`render_scene`);
  2. frame := background; each tile-bank entry alpha-blends its phase
     image wherever the per-pixel kind field matches (themed entries
     only for envs of that theme, mirroring the reference's per-level
     theme choice, games/coinrun/coinrun.cpp:418-421);
  3. each stamp group, slot by slot in painter order
     (renderer.cpp:5-101), alpha-blends its premultiplied patch over the
     frame (`composite_scene`).

Everything is plain jnp: the window slices are gathers and the select
chain is elementwise work that XLA fuses.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import phases as phases_lib


def composite_scene(X, p_joint, theme, tile_bank, entry_kind, entry_theme,
                    groups, obs):
    """Composite the full scene from pixel-resolution content.

    X:          bf16 [N, 4, obs, obs] — X[:, 0] per-pixel tile-kind
                field (integral values), X[:, 1:4] background rgb.
    p_joint:    i32 [N] joint phase index into tile_bank.
    theme:      i32 [N] per-env theme id (matched against entry_theme).
    tile_bank:  f32/bf16 [NPH, NE, 4, obs, obs] premultiplied phase
                images (phases.tile_phase_bank).
    entry_kind: static tuple — kind-field value of each bank entry.
    entry_theme: static tuple — required theme id, -1 = any theme.
    groups:     stamp groups [(prem_bank [V, 4, P, P], var [N, K],
                scale [N, K], r0, c0)] drawn in order after the tiles;
                out-of-range variants and off-frame texels draw nothing.
    Returns bf16 [N, 3, obs, obs].
    """
    X = X.astype(jnp.bfloat16)
    tile_bank = jnp.asarray(tile_bank, jnp.bfloat16)
    img = X[:, 1:4]
    G = X[:, 0]
    tb = tile_bank[p_joint]  # [N, NE, 4, obs, obs]
    for i, (kv, tv) in enumerate(zip(entry_kind, entry_theme)):
        t = tb[:, i]
        m = G == jnp.bfloat16(kv)
        if tv >= 0:
            m = m & (theme == tv)[:, None, None]
        a = jnp.where(m[:, None], t[:, 3:4], jnp.bfloat16(0))
        rgbp = jnp.where(m[:, None], t[:, :3], jnp.bfloat16(0))
        img = img * (jnp.bfloat16(1.0) - a) + rgbp

    for bank, var, scale, r0, c0 in groups:
        bank = jnp.asarray(bank, jnp.bfloat16)
        V, _, P, _ = bank.shape
        K = var.shape[1]
        ri = jnp.arange(obs)
        for k in range(K):
            patch = bank[jnp.clip(var[:, k], 0, V - 1)]  # [N, 4, P, P]
            patch = patch * (
                scale[:, k] * (var[:, k] >= 0) * (var[:, k] < V)
            )[:, None, None, None].astype(jnp.bfloat16)
            ohr = (
                ri[None, :, None] == r0[:, k, None, None] + jnp.arange(P)
            ).astype(jnp.bfloat16)  # [N, obs, P]
            ohc = (
                ri[None, :, None] == c0[:, k, None, None] + jnp.arange(P)
            ).astype(jnp.bfloat16)
            placed = jnp.einsum("nrp,ncpq,nuq->ncru", ohr, patch, ohc,
                                preferred_element_type=jnp.bfloat16)
            a = placed[:, 3:4]
            img = img * (jnp.bfloat16(1.0) - a) + placed[:, :3]
    return img


def render_scene(gridp, bgpad, ty0, tx0, jy, jx, bg_i, theme, tile_bank,
                 entry_kind, entry_theme, groups, ppu, qp, win, obs=64):
    """Full quantized-camera scene from raw per-env inputs.

    gridp:  i8 [N, GP, GP] kind grid padded by `win` on each side with
            the game's out-of-bounds tile.
    bgpad:  u8 [NB, 3, GP, GP] tile-resolution backgrounds, zero-padded
            the same way (zero = out-of-level black).
    ty0/tx0: i32 [N] window-origin tile (un-padded coordinates).
    jy/jx:  i32 [N] per-axis camera phase in [0, qp).
    bg_i:   i32 [N] background index; theme: i32 [N].
    Other arguments as `composite_scene`. Returns bf16 [N, 3, obs, obs].
    """
    gwin = jax.vmap(
        lambda g, y, x: jax.lax.dynamic_slice(g, (y + win, x + win),
                                              (win, win))
    )(gridp, ty0, tx0)
    bgpad = jnp.asarray(bgpad)
    bgwin = jax.vmap(
        lambda b, y, x: jax.lax.dynamic_slice(
            bgpad, (b, 0, y + win, x + win), (1, 3, win, win))[0]
    )(bg_i, ty0, tx0)
    window = jnp.concatenate(
        [gwin[:, None].astype(jnp.bfloat16), bgwin.astype(jnp.bfloat16)],
        1)  # [N, 4, win, win]
    EyTab, ExTab = phases_lib.expansion_tables(ppu, obs, qp, win_size=win)
    Ey = jnp.asarray(EyTab, jnp.bfloat16)[jy]  # [N, obs, win]
    Ex = jnp.asarray(ExTab, jnp.bfloat16)[jx]  # [N, win, obs]
    rows = jnp.einsum("nri,ncij->ncrj", Ey, window,
                      preferred_element_type=jnp.bfloat16)
    X = jnp.einsum("ncrj,nju->ncru", rows, Ex,
                   preferred_element_type=jnp.bfloat16)
    return composite_scene(X, jy * qp + jx, theme, tile_bank, entry_kind,
                           entry_theme, groups, obs)
