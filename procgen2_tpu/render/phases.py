"""Quantized-camera texel phases: collapse scrolling-camera tile sampling
into a small set of shared patterns.

The reference renders a continuously-scrolling camera by resampling every
tile texture per frame (render_game camera transform,
games/coinrun/coinrun.cpp:443-470 with renderer.cpp:5-82 nearest
sampling). Per-env resampling costs each tile kind a per-env pair of
small one-hot sampling matmuls ([4*OBS, S] @ [S, OBS]).

The structural alternative: quantize the *render* camera to
1/QP world units. Physics and rewards never see the quantized value —
the shift is render-only and bounded by 1/(2*QP) units (= PPU/(2*QP)
obs pixels; 0.6 px for coinrun's 4.8 ppu at QP=4, well under the one
obs pixel the reference's own integer dest-rect snapping moves sprites
by). With cam = m/QP the world x under obs pixel c is

    wx(c) = m/QP + (c + 0.5 - OBS/2) / ppu

whose fractional structure — which tile column each pixel hits relative
to the leftmost visible tile, and which texel inside it — depends only
on m mod QP. That yields QP x-phases times QP y-phases; every quantity
the renderer needs becomes a table lookup:

  * TR/TC[j][pix]  tile row/col offset from the window origin,
  * VV/UU[j][pix]  texel row/col inside the tile,
  * a pre-pixelized [QP*QP, kinds, 4, OBS, OBS] premultiplied tile
    bank (one entry per joint phase: the exact nearest-sampled image
    of an infinite plane of that kind) that turns per-env resampling
    into per-pixel selects (render/scene.py),
  * per-phase 0/1 expansion matrices Ey [OBS, WIN] / Ex [WIN, OBS]
    that lift any WIN x WIN tile-resolution window (tile kinds, the
    64-tile-spanning backgrounds of atlas.BG_SIZE) to pixel resolution.

All tables are exact: the math runs in `fractions.Fraction`, so a phase
image is bit-identical to what per-env one-hot sampling at the quantized
camera would produce.
"""
from __future__ import annotations

import functools
from fractions import Fraction

import numpy as np

from .atlas import SPRITE_SIZE

S = SPRITE_SIZE
WIN = 16  # tile-window size for ppu >= 4.8 games (<= 14 visible tiles
#           + phase); wider views compute their own via `win()`


def _frac_ppu(ppu: float) -> Fraction:
    f = Fraction(ppu).limit_denominator(10000)
    assert abs(float(f) - ppu) < 1e-9, ppu
    return f


@functools.lru_cache(maxsize=None)
def phase_tables(ppu: float, obs: int = 64, qp: int = 4):
    """Per-phase pixel->tile maps.

    Returns (TR, VV, t0_off) with TR int32 [qp, obs] (tile index offset
    from the window origin tile), VV int32 [qp, obs] (texel row in
    [0, S)), and t0_off: float world offset such that the window origin
    tile of an env is floor(camq + t0_off) (exact in f32 for dyadic
    camq/ppu). x and y share tables (the camera transform is the same
    affine map per axis, renderer.cpp:13-27).
    """
    fppu = _frac_ppu(ppu)
    q = Fraction(1, qp)
    t0_off = Fraction(1 - obs, 2) / fppu  # = (0.5 - obs/2)/ppu
    TR = np.zeros((qp, obs), np.int32)
    VV = np.zeros((qp, obs), np.int32)
    for j in range(qp):
        camq = j * q
        t0 = (camq + t0_off).__floor__()
        for c in range(obs):
            wx = camq + Fraction(2 * c + 1 - obs, 2) / fppu
            t = wx.__floor__()
            TR[j, c] = t - t0
            VV[j, c] = ((wx - t) * S).__floor__()
    return TR, VV, float(t0_off)


@functools.lru_cache(maxsize=None)
def win(ppu: float, obs: int = 64, qp: int = 4) -> int:
    """Tile-window span for this camera: the number of tile rows any
    phase can touch (= grid pad width for the scene compositor)."""
    TR, _, _ = phase_tables(ppu, obs, qp)
    return int(TR.max()) + 1


@functools.lru_cache(maxsize=None)
def expansion_tables(ppu: float, obs: int = 64, qp: int = 4,
                     win_size: int | None = None):
    """0/1 phase expansion matrices: (EyTab f32 [qp, obs, W],
    ExTab f32 [qp, W, obs]) for a W x W tile-resolution window
    (default: this camera's own span from `win()`).
    X = Ey[jy] @ window @ Ex[jx] lifts the window to pixel
    resolution."""
    TR, _, _ = phase_tables(ppu, obs, qp)
    W = win_size if win_size is not None else int(TR.max()) + 1
    assert TR.max() < W, (ppu, obs, qp, W)
    eye = np.eye(W, dtype=np.float32)
    EyTab = eye[TR]  # [qp, obs, W]
    ExTab = np.swapaxes(EyTab, 1, 2).copy()  # [qp, W, obs]
    return EyTab, ExTab


@functools.lru_cache(maxsize=None)
def _tile_phase_bank_cached(tex_bytes, shape, ppu, obs, qp):
    textures = np.frombuffer(tex_bytes, np.uint8).reshape(shape)
    TR, VV, _ = phase_tables(ppu, obs, qp)
    K = textures.shape[0]
    bank = np.zeros((qp * qp, K, 4, obs, obs), np.float32)
    for jy in range(qp):
        vv = VV[jy]
        for jx in range(qp):
            uu = VV[jx]
            # tex[:, :, vv, :][..., uu]: the pixelized infinite plane of
            # each kind at this joint phase (tile identity is irrelevant
            # to the texel pattern; the kind mask supplies placement)
            px = textures[:, :, vv][:, :, :, uu].astype(np.float32)
            a = px[:, 3:4] / 255.0
            bank[jy * qp + jx, :, :3] = px[:, :3] * a  # premultiplied
            bank[jy * qp + jx, :, 3:4] = a
    return bank


def tile_phase_bank(textures: np.ndarray, ppu: float, obs: int = 64,
                    qp: int = 4) -> np.ndarray:
    """Pre-pixelized premultiplied tile bank, f32
    [qp*qp, K, 4, obs, obs] (rgb * a, a in [0, 1]).

    textures: uint8 [K, 4, S, S] tile RGBA textures (kind order = the
    scene's entry order).
    """
    t = np.ascontiguousarray(np.asarray(textures, np.uint8))
    return _tile_phase_bank_cached(t.tobytes(), t.shape, ppu, obs, qp)
