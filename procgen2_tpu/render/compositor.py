"""Observation compositor: texture sampling as one-hot matmuls.

Re-implements the reference's SDL software rendering path — camera
transform (`games/maze/renderer.cpp:5-82`), camera-culled tilemap layer
(`games/maze/tilemap.cpp:111-131`) and z-ordered sprite blits — as
*matrix multiplications* instead of per-pixel gathers.

The camera is axis-aligned, so every sampling field is separable: the
tile under obs pixel (r, c) is `grid[ty(r), tx(c)]` and the texel inside
it is `(v(r), u(c))`. Separable integer sampling is exactly a pair of
one-hot matmuls:

    sample[r, c] = sum_h sum_w OHV[r, h] * img[h, w] * OHU[c, w]
                 = (OHV @ img @ OHU^T)[r, c]

with OHV/OHU one-hot row/column selectors — dense 64xH / 64xW bf16
matrices. Texture choice by a traced sprite id becomes a one-hot
contraction over the atlas axis. The operands are 0/1 selectors and
texel values <= 255, so the bf16 products are exact. The only
non-separable case is a *rotated* sprite, which keeps a (small) gather
path. (Which of these contractions a plain gather beats on the GPU is
an open measurement, ROADMAP Design #3.)

Coordinate conventions are unchanged from the reference: world units,
1 tile = 1 unit = 16 px (`helpers.h:8`), y down on screen, tile grids
stored row-major `grid[y, x]` with the reference's `H-1-y` storage flip
baked in at generation time. `camera_coords` returns the *separable*
pixel->world maps: `wx[64]` per obs column and `wy[64]` per obs row.

All functions are unbatched (one env); batch with vmap — under vmap the
per-env matmuls become batched matmuls.
"""
from __future__ import annotations

import contextlib

import jax
import jax.numpy as jnp

from .atlas import SPRITE_SIZE

OBS = 64  # observation width/height, games/maze/maze.cpp:26-27
S = SPRITE_SIZE


@contextlib.contextmanager
def resolution(n: int):
    """Trace-time render resolution override (square n x n target).

    The reference renders every scene twice — a 64x64 observation and a
    W x H window surface (`renderer.h:12,25-27`, dual targets created in
    cenv_make, games/coinrun/coinrun.cpp:225-229). Here a single scene
    description serves both: game `observe` functions read `C.OBS` at
    trace time, so tracing under `with resolution(512):` yields the
    window-size render program (camera spans the same world extent —
    games scale their ppu by OBS/64, mirroring render_game's
    `camera_scale = zoom * width / obs_width`, coinrun.cpp:412).
    """
    global OBS
    old = OBS
    OBS = int(n)
    try:
        yield
    finally:
        OBS = old


def planar(img_hwc):
    """numpy/jnp HWC uint8 -> planar CHW (host-side prep for atlas arrays)."""
    return jnp.moveaxis(jnp.asarray(img_hwc), -1, 0)


def planar_stack(imgs_nhwc):
    """[N, H, W, C] -> [C, N, H, W] (atlas stacks)."""
    return jnp.moveaxis(jnp.asarray(imgs_nhwc), -1, 0)


def camera_coords(ppu, cam_x, cam_y):
    """Separable world coords of obs pixel centers: (wx[64], wy[64])."""
    c = jnp.arange(OBS, dtype=jnp.float32) + 0.5 - OBS / 2
    return cam_x + c / ppu, cam_y + c / ppu


def pixel_coords():
    """Identity screen-space maps (for HUD overlays drawn in pixels)."""
    c = jnp.arange(OBS, dtype=jnp.float32) + 0.5
    return c, c


def clear(color=(0.0, 0.0, 0.0)):
    """Black clear, maze.cpp:390-391. Returns planar bf16 [4, OBS, OBS].

    The working image carries 4 channels so sprite blends never slice
    RGBA sample outputs (a [:3] slice is a 400 MB copy at batch 8192);
    the dead alpha plane is dropped in finalize(). bf16 accumulation
    costs at most 1 of 255 pixel-value units per blend — invisible, and
    it halves the dominant HBM traffic of the compositing chain.
    """
    c = jnp.asarray(tuple(color) + (0.0,), jnp.bfloat16).reshape(4, 1, 1)
    return jnp.zeros((4, OBS, OBS), jnp.bfloat16) + c


def _blend(img, rgba, a):
    """img, rgba: [4, OBS, OBS] bf16; a: [OBS, OBS] in [0, 1]."""
    a = a.astype(jnp.bfloat16)[None]
    return img * (1.0 - a) + rgba.astype(jnp.bfloat16) * a


def _onehot(idx, n, valid=None):
    """[...,] int32 -> [..., n] bf16 one-hot, zero rows where invalid.

    bf16 is exact here (0/1 selectors; texel values <= 255 are exact in
    bf16) and halves one-hot memory traffic.
    """
    oh = (idx[..., None] == jnp.arange(n)).astype(jnp.bfloat16)
    if valid is not None:
        oh = oh * valid[..., None].astype(jnp.bfloat16)
    return oh


def _sep_sample(tex, ohv, ohu):
    """tex [C, H, W], ohv [OBS, H], ohu [OBS, W] -> [C, OBS, OBS].

    Two one-hot matmuls (bf16 in and out): rows then columns.
    """
    t = jnp.einsum("rh,chw->crw", ohv, tex.astype(jnp.bfloat16),
                   preferred_element_type=jnp.bfloat16)
    return jnp.einsum("crw,uw->cru", t, ohu,
                      preferred_element_type=jnp.bfloat16)


def select_tex(atlas_p, sid):
    """Pick one RGBA sprite [4, S, S] from the atlas by a (traced) id —
    a one-hot contraction over the atlas axis."""
    A = atlas_p.shape[1]
    oh = _onehot(jnp.asarray(sid, jnp.int32), A)
    return jnp.einsum("a,cahw->chw", oh, atlas_p.astype(jnp.bfloat16),
                      preferred_element_type=jnp.bfloat16)


def select_texs(atlas_p, sids):
    """Batched select_tex: sids [K] -> [K, 4, S, S]."""
    A = atlas_p.shape[1]
    oh = _onehot(jnp.asarray(sids, jnp.int32), A)  # [K, A]
    return jnp.einsum("ka,cahw->kchw", oh, atlas_p.astype(jnp.bfloat16),
                      preferred_element_type=jnp.bfloat16)


def draw_background(img, bgs_p, bg_index, wx, wy,
                    origin_x=0.0, origin_y=0.0, size_units=64.0):
    """Sample background texture `bg_index` covering `size_units` units.

    Mirrors maze.cpp:403-408. `bgs_p`: uint8 [3, NUM_BGS, H, W]; selection
    + sampling are one-hot contractions.
    """
    bgs_p = jnp.asarray(bgs_p)
    _, NB, H, W = bgs_p.shape
    u = (wx - origin_x) / size_units  # [64]
    v = (wy - origin_y) / size_units
    in_u = (u >= 0) & (u < 1)
    in_v = (v >= 0) & (v < 1)
    ui = jnp.clip((u * W).astype(jnp.int32), 0, W - 1)
    vi = jnp.clip((v * H).astype(jnp.int32), 0, H - 1)
    ohu = _onehot(ui, W, in_u)
    ohv = _onehot(vi, H, in_v)
    # Selection as an explicit flat matmul: under vmap this is one
    # [N, NB] @ [NB, 3HW] product that reads the bg bank once, instead of
    # a per-env contraction that re-reads every texture per lane.
    sel = _onehot(jnp.asarray(bg_index, jnp.int32), NB)
    bg = (sel @ bgs_p.astype(jnp.bfloat16).reshape(3 * NB, H * W)
          .reshape(3, NB, H * W).swapaxes(0, 1).reshape(NB, 3 * H * W)
          ).reshape(3, H, W)
    rgb = _sep_sample(bg, ohv, ohu)
    a = (in_v[:, None] & in_u[None, :]).astype(jnp.bfloat16)[None]
    # blend rgb channels only (bg has no alpha plane; the img alpha plane
    # is dead anyway)
    out_rgb = img[:3] * (1.0 - a) + rgb * a
    return jnp.concatenate([out_rgb, img[3:]], axis=0)


def draw_tiles(img, grid, lut, atlas_p, wx, wy, oob_tile):
    """Tilemap layer.

    `grid` int [H, W] of tile ids in render coords; `lut` (STATIC length
    K) maps tile id -> atlas sprite index, -1 = transparent; OOB reads
    yield `oob_tile` (tilemap.h:82-87 "Out of bounds is a wall").

    The tile-under-pixel field G[r, c] = grid[ty(r), tx(c)] is separable
    -> two one-hot matmuls; each of the K tile kinds contributes a
    separable texel image masked by (G == k). Cost scales with K (games
    have 2-6 tile kinds).
    """
    atlas_p = jnp.asarray(atlas_p)
    grid = jnp.asarray(grid)
    lut = jnp.asarray(lut)
    H, W = grid.shape
    K = lut.shape[0]

    tx = jnp.floor(wx).astype(jnp.int32)
    ty = jnp.floor(wy).astype(jnp.int32)
    in_x = (tx >= 0) & (tx < W)
    in_y = (ty >= 0) & (ty < H)
    ohx = _onehot(jnp.clip(tx, 0, W - 1), W)
    ohy = _onehot(jnp.clip(ty, 0, H - 1), H)
    G = _sep_sample(grid[None], ohy, ohx)[0]
    inb = in_y[:, None] & in_x[None, :]
    G = jnp.where(inb, G, jnp.float32(oob_tile))
    Gi = jnp.round(G).astype(jnp.int32)

    # intra-tile texel coords (separable)
    u = jnp.clip(((wx - tx) * S).astype(jnp.int32), 0, S - 1)
    v = jnp.clip(((wy - ty) * S).astype(jnp.int32), 0, S - 1)
    ohu = _onehot(u, S)
    ohv = _onehot(v, S)

    # texel image for each of the K tile kinds
    texs = select_texs(atlas_p, jnp.maximum(lut, 0))  # [K, 4, S, S]
    sampled = jax.vmap(lambda t: _sep_sample(t, ohv, ohu))(texs)  # [K,4,64,64]

    for k in range(K):
        mask = (Gi == k) & (lut[k] >= 0)
        a = jnp.where(mask, sampled[k, 3], 0.0) * jnp.bfloat16(1 / 255.0)
        img = _blend(img, sampled[k], a)
    return img


def _rect_onehots(x, y, w, h, wx, wy, flip_x):
    """One-hot texel selectors for an axis-aligned sprite rect."""
    u_f = (wx - x) / w  # [64]
    v_f = (wy - y) / h
    in_u = (u_f >= 0) & (u_f < 1)
    in_v = (v_f >= 0) & (v_f < 1)
    ui = jnp.clip((u_f * S).astype(jnp.int32), 0, S - 1)
    ui = jnp.where(flip_x, S - 1 - ui, ui)
    vi = jnp.clip((v_f * S).astype(jnp.int32), 0, S - 1)
    return _onehot(ui, S, in_u), _onehot(vi, S, in_v)


def _draw_tex(img, tex, x, y, w, h, wx, wy, flip_x, alive, alpha):
    """Blend a pre-selected RGBA texel block as an axis-aligned rect."""
    ohu, ohv = _rect_onehots(x, y, w, h, wx, wy, flip_x)
    rgba = _sep_sample(tex, ohv, ohu)
    a = (rgba[3] * jnp.bfloat16(1 / 255.0)
         * jnp.asarray(alive, jnp.bfloat16) * jnp.bfloat16(alpha))
    return _blend(img, rgba, a)


def draw_sprite(img, atlas_p, sid, x, y, w, h, wx, wy, flip_x=False,
                alive=True, rotation=None, alpha=1.0):
    """Alpha-blend one sprite, top-left at world (x, y), size (w, h).

    Equivalent of Renderer::render_texture (renderer.cpp:5-82) /
    render_texture_rotated (renderer.cpp:84-101), nearest sampling.
    Axis-aligned sprites are one-hot matmuls; `rotation` (radians,
    screen-clockwise like SDL's positive degrees) falls back to a 2-D
    gather since rotated sampling is not separable.

    Perf note: pass `sid` as a *python int* whenever the sprite identity
    is static — the texture is then closed over instead of batched, and
    under vmap the sampling matmuls fold the env batch into the M
    dimension (one large matmul instead of thousands of small 64x32x32
    ones).
    """
    atlas_p = jnp.asarray(atlas_p)
    if rotation is None:
        if isinstance(sid, int):
            tex = atlas_p[:, sid].astype(jnp.bfloat16)  # static slice
        else:
            tex = select_tex(atlas_p, sid)
        return _draw_tex(img, tex, x, y, w, h, wx, wy, flip_x, alive, alpha)

    wx2 = jnp.broadcast_to(wx[None, :], (OBS, OBS))
    wy2 = jnp.broadcast_to(wy[:, None], (OBS, OBS))
    cx = x + 0.5 * w
    cy = y + 0.5 * h
    cosr = jnp.cos(rotation)
    sinr = jnp.sin(rotation)
    rx = wx2 - cx
    ry = wy2 - cy
    u_f = (cosr * rx + sinr * ry) / w + 0.5
    v_f = (-sinr * rx + cosr * ry) / h + 0.5
    inside = (u_f >= 0) & (u_f < 1) & (v_f >= 0) & (v_f < 1)
    ui = jnp.clip((u_f * S).astype(jnp.int32), 0, S - 1)
    ui = jnp.where(flip_x, S - 1 - ui, ui)
    vi = jnp.clip((v_f * S).astype(jnp.int32), 0, S - 1)
    tex = select_tex(atlas_p, sid)  # [4, S, S]
    ch = tex[:, vi, ui]  # [4, OBS, OBS] gather (rotated path only)
    a = (ch[3] * jnp.bfloat16(1 / 255.0) * inside.astype(jnp.bfloat16)
         * jnp.asarray(alive, jnp.bfloat16) * jnp.asarray(alpha, jnp.bfloat16))
    return _blend(img, ch, a)


def draw_sprites(img, atlas_p, sids, xs, ys, ws, hs, wx, wy, flips=None,
                 alives=None):
    """Composite K sprites back-to-front (already z-sorted by the caller).

    Texture selection for all K slots is one batched contraction; the
    per-slot rect blends run in a fori_loop carrying the image.
    """
    atlas_p = jnp.asarray(atlas_p)
    K = sids.shape[0]
    flips = jnp.zeros(K, bool) if flips is None else flips
    alives = jnp.ones(K, bool) if alives is None else alives
    texs = select_texs(atlas_p, sids)  # [K, 4, S, S]

    def body(i, im):
        return _draw_tex(
            im, texs[i], xs[i], ys[i], ws[i], hs[i], wx, wy,
            flips[i], alives[i], 1.0,
        )

    return jax.lax.fori_loop(0, K, body, img)


def sprite_stamps(bank_p, var_idx, xs, ys, ws, hs, wx_b, wy_b,
                  flips=None, alives=None, patch=8):
    """Batched small-sprite compositor: K sprites x N envs as P x P stamps.

    The fori_loop in `draw_sprites` materializes one full [4, OBS, OBS]
    frame per sprite slot — ruinous for games with dozens of slots
    (coinrun's 40 saws + 40 mobs, bossfight's 64-bullet pool). A sprite
    only covers ~w*ppu <= P screen pixels, so instead: sample each
    sprite's texels into a P x P *patch* (two batched one-hot matmuls
    with the variant selection fused into the row one-hot), then place
    all K patches into the frame with one batched placement matmul.
    Traffic is O(N*K*P) + one full-frame output for *all* K sprites
    together, instead of O(N*K*OBS^2).

    Placement sums premultiplied contributions, which is exact alpha
    compositing whenever stamps don't overlap on screen and a saturating
    approximation when they do (the reference painter's order differs
    only on overlapped translucent texels).

    bank_p:  [V, 4, S, S] texture bank for this sprite class (u8/bf16)
    var_idx: i32 [N, K] texture index into the bank
    xs, ys:  f32 [N, K] world top-left; ws, hs: f32 [N, K] world size
    wx_b, wy_b: f32 [N, OBS] per-env separable pixel->world maps
    flips:   bool [N, K]; alives: bool [N, K]
    patch:   static P (pixels); must cover max(w*ppu, h*ppu) + 1

    Returns (rgbp [N, 3, OBS, OBS], a [N, 1, OBS, OBS]) premultiplied;
    composite with  img = img * (1 - a) + rgbp * 255-scale.
    """
    bank_p = jnp.asarray(bank_p)
    V = bank_p.shape[0]
    N, K = var_idx.shape
    P = patch
    if alives is None:
        alives = jnp.ones((N, K), bool)
    if flips is None:
        flips = jnp.zeros((N, K), bool)

    # Row/col window origins: first obs row/col covering the sprite.
    # wx/wy are affine per env (camera transform), so the step is
    # constant along the axis.
    def origin(w_map, pos):
        step = w_map[:, 1] - w_map[:, 0]  # [N]
        return jnp.ceil(
            (pos - w_map[:, :1]) / step[:, None]
        ).astype(jnp.int32)  # [N, K]

    r0 = origin(wy_b, ys)
    c0 = origin(wx_b, xs)

    p_i = jnp.arange(P)
    # world coords of the patch's pixel rows/cols (clip keeps the gather
    # in-bounds; out-of-frame placement is masked by the one-hots below)
    rows_idx = jnp.clip(r0[..., None] + p_i, 0, OBS - 1)  # [N, K, P]
    cols_idx = jnp.clip(c0[..., None] + p_i, 0, OBS - 1)
    wyp = jnp.take_along_axis(
        wy_b[:, None, :].repeat(K, 1), rows_idx, axis=2
    )  # [N, K, P]
    wxp = jnp.take_along_axis(
        wx_b[:, None, :].repeat(K, 1), cols_idx, axis=2
    )

    v_f = (wyp - ys[..., None]) / hs[..., None]
    u_f = (wxp - xs[..., None]) / ws[..., None]
    in_v = (v_f >= 0) & (v_f < 1)
    in_u = (u_f >= 0) & (u_f < 1)
    vi = jnp.clip((v_f * S).astype(jnp.int32), 0, S - 1)
    ui = jnp.clip((u_f * S).astype(jnp.int32), 0, S - 1)
    ui = jnp.where(flips[..., None], S - 1 - ui, ui)

    # --- texel sampling: variant-fused row one-hot, then col one-hot ---
    # OHVH [N, K, P, V*S]: one-hot over (variant, texel row)
    z = var_idx[..., None] * S + vi  # [N, K, P]
    ohvh = _onehot(z, V * S, in_v & alives[..., None])
    # bank rows keyed by (variant, texel row): [V, 4, S(h), S(w)] ->
    # [(V, h), (4, w)]
    b1 = (bank_p.astype(jnp.bfloat16)
          .transpose(0, 2, 1, 3).reshape(V * S, 4 * S))
    rows = (ohvh.reshape(N * K * P, V * S) @ b1).reshape(N, K, P, 4, S)

    ohu = _onehot(ui, S, in_u)  # [N, K, P(q), S]
    # patch4 [N, K, 4, P(p), P(q)]
    patch4 = jnp.einsum("nkpcw,nkqw->nkcpq", rows, ohu,
                        preferred_element_type=jnp.bfloat16)

    a_p = patch4[:, :, 3:4] * jnp.bfloat16(1 / 255.0)  # [N, K, 1, P, P]
    prem = jnp.concatenate([patch4[:, :, :3] * a_p, a_p], axis=2)
    return place_stamps(prem, r0, c0)


def blend_premul(img, rgbp, a):
    """img [N, 3, OBS, OBS] + premultiplied stamps; all bf16."""
    return img * (1.0 - a) + rgbp


def place_stamps(prem, r0, c0):
    """Place per-sprite premultiplied patches into the frame.

    prem: bf16 [N, K, 4, P, P] (rgb premultiplied + alpha in [0,1])
    r0, c0: i32 [N, K] top-left obs pixel of each patch
    Returns (rgbp [N,3,OBS,OBS], a [N,1,OBS,OBS]) as bf16 sums —
    placement is two batched one-hot matmuls, so the full-frame cost is
    paid once for all K sprites.
    """
    N, K, _, P, _ = prem.shape
    p_i = jnp.arange(P)
    r_iota = jnp.arange(OBS)
    ohr = (r_iota[None, None, :, None] == (r0[..., None, None] + p_i)
           ).astype(jnp.bfloat16)  # [N, K, OBS, P]
    ohc = (r_iota[None, None, :, None] == (c0[..., None, None] + p_i)
           ).astype(jnp.bfloat16)
    T = jnp.einsum("nkrp,nkcpq->ncrkq", ohr, prem,
                   preferred_element_type=jnp.bfloat16)
    out = jnp.einsum("ncrkq,nkuq->ncru", T, ohc,
                     preferred_element_type=jnp.bfloat16)
    return out[:, :3], out[:, 3:4]


def _premultiply_bank(pbank):
    """u8/float [V, 4, P, P] -> premultiplied bf16 bank (trace-time
    constant, folded once by XLA)."""
    pbank = jnp.asarray(pbank).astype(jnp.float32)
    a_tex = pbank[:, 3:4] * (1.0 / 255.0)
    return jnp.concatenate(
        [pbank[:, :3] * a_tex, a_tex], axis=1
    ).astype(jnp.bfloat16)


def composite_stamps(img, pbank, var_idx, r0, c0, alives=None, alpha=None):
    """Alpha-blend K pixel-snapped stamps/env OVER `img`.

    For fixed-(screen)-size sprites the patch content is independent of
    the env once positions snap to the obs pixel grid (the reference's
    SDL software rasterizer snaps destination rects the same way), so
    sampling collapses to a variant select from `pbank` and the
    full-frame cost is the shared placement matmul. Rotation is handled
    by baking quantized rotation variants into the bank
    (atlas.rasterize_patch) instead of a per-pixel rotated gather.

    The group's premultiplied sum is blended once: exact alpha
    compositing when stamps don't overlap on screen, a saturating
    approximation of the painter order (renderer.cpp:5-101) where they
    do — see sprite_stamps.

    img: bf16 [N, 3, OBS, OBS]; pbank: [V, 4, P, P] u8/bf16
    pre-rasterized patches; var_idx: i32 [N, K]; r0/c0: i32 [N, K]
    top-left obs pixel.
    """
    rgbp, a = _stamps_matmul(_premultiply_bank(pbank), var_idx, r0, c0,
                             alives, alpha)
    return blend_premul(img, rgbp, a)


def _stamps_matmul(prem_bank, var_idx, r0, c0, alives=None, alpha=None):
    """Matmul formulation of the stamp group: one-hot variant select +
    the place_stamps one-hot placement pair. The bank is premultiplied
    (a trace-time constant, folded once by XLA) and alive/alpha fold
    into the one-hot *values*, so the select yields premultiplied
    patches with no elementwise stage between the two matmuls. Variants
    outside [0, V) select nothing. Returns premultiplied (rgbp, a)
    sums."""
    N, K = var_idx.shape
    V = prem_bank.shape[0]
    P = prem_bank.shape[-1]
    ohvar = (var_idx[..., None] == jnp.arange(V)).astype(jnp.bfloat16)
    if alives is not None:
        ohvar = ohvar * alives[..., None].astype(jnp.bfloat16)
    if alpha is not None:
        ohvar = ohvar * jnp.asarray(alpha, jnp.bfloat16)[..., None]
    # Bank stored as [V, c, q, p] so the select's natural row-major
    # output [NK, (c, q, p)] already has the p-minor layout the
    # row-placement dot wants for its prem operand — the swapaxes below
    # is then a pure layout relabeling, not a data movement.
    bank_cqp = prem_bank.transpose(0, 1, 3, 2)  # constant-folded
    prem = (
        ohvar.reshape(N * K, V) @ bank_cqp.reshape(V, 4 * P * P)
    ).reshape(N, K, 4, P, P).swapaxes(3, 4)
    return place_stamps(prem, r0, c0)


def draw_background_batch(bgs_p, bg_index, wx_b, wy_b,
                          origin_x=0.0, origin_y=0.0, size_units=64.0,
                          base=(0.0, 0.0, 0.0)):
    """Batched draw_background for per-env (moving) cameras.

    bgs_p: u8 [3, B, H, W]; bg_index: i32 [N]; wx_b/wy_b: f32 [N, OBS].
    Returns bf16 [N, 3, OBS, OBS] (background over `base` clear color).
    """
    bgs_p = jnp.asarray(bgs_p)
    _, B, H, W = bgs_p.shape
    u = (wx_b - origin_x) / size_units  # [N, OBS]
    v = (wy_b - origin_y) / size_units
    in_u = (u >= 0) & (u < 1)
    in_v = (v >= 0) & (v < 1)
    ohu = _onehot(jnp.clip((u * W).astype(jnp.int32), 0, W - 1), W, in_u)
    ohv = _onehot(jnp.clip((v * H).astype(jnp.int32), 0, H - 1), H, in_v)
    # background select as a whole-texture row gather: each row is one
    # contiguous 3*H*W texture
    tex = jnp.moveaxis(bgs_p, 1, 0)[bg_index].astype(jnp.bfloat16)
    t1 = jnp.einsum("nrh,nchw->ncrw", ohv, tex,
                    preferred_element_type=jnp.bfloat16)
    rgb = jnp.einsum("ncrw,nuw->ncru", t1, ohu,
                     preferred_element_type=jnp.bfloat16)
    a = (in_v[:, None, :, None] & in_u[:, None, None, :]).astype(jnp.bfloat16)
    basec = jnp.asarray(base, jnp.bfloat16).reshape(1, 3, 1, 1)
    return basec * (1.0 - a) + rgb * a


def tile_onehots(wx_b, wy_b, H, W):
    """Per-env tile/texel one-hot selectors for a moving camera.

    Returns (ohy [N,OBS,H], ohx [N,OBS,W], ohv [N,OBS,S], ohu [N,OBS,S],
    inb [N,OBS,OBS] bool)."""
    tx = jnp.floor(wx_b).astype(jnp.int32)
    ty = jnp.floor(wy_b).astype(jnp.int32)
    in_x = (tx >= 0) & (tx < W)
    in_y = (ty >= 0) & (ty < H)
    ohx = _onehot(jnp.clip(tx, 0, W - 1), W)
    ohy = _onehot(jnp.clip(ty, 0, H - 1), H)
    ohu = _onehot(jnp.clip(((wx_b - tx) * S).astype(jnp.int32), 0, S - 1), S)
    ohv = _onehot(jnp.clip(((wy_b - ty) * S).astype(jnp.int32), 0, S - 1), S)
    inb = in_y[:, :, None] & in_x[:, None, :]
    return ohy, ohx, ohv, ohu, inb


def draw_tiles_batch(img, grids, lut, atlas_p, wx_b, wy_b, oob_tile,
                     onehots=None, extra_layers=()):
    """Batched tilemap layer for per-env cameras.

    grids: int [N, H, W] tile ids (render coords); lut: static list of
    atlas indices (-1 transparent); per-env camera maps wx_b/wy_b
    [N, OBS]. All K tile-kind texel images are sampled with ONE pair of
    batched matmuls (kinds stacked into the channel axis), then blended
    by kind masks from the G field. `extra_layers` entries
    (kind_id, atlas_sid) append additional kinds drawn from the same
    grid values (used for sprites folded into the grid).
    """
    atlas_p = jnp.asarray(atlas_p)
    grids = jnp.asarray(grids)
    N, H, W = grids.shape
    lut = list(lut)
    K = len(lut)

    ohy, ohx, ohv, ohu, inb = (
        tile_onehots(wx_b, wy_b, H, W) if onehots is None else onehots
    )

    # tile-kind field G
    G = jnp.einsum("nrh,nhw->nrw", ohy, grids.astype(jnp.bfloat16),
                   preferred_element_type=jnp.bfloat16)
    G = jnp.einsum("nrw,nuw->nru", G, ohx,
                   preferred_element_type=jnp.bfloat16)
    G = jnp.where(inb, jnp.round(G), jnp.float32(oob_tile)).astype(jnp.int8)
    Gi = G[:, None]  # [N, 1, OBS, OBS]

    # all K kind texel images in one batched matmul pair: stack kinds
    # into the channel axis of a shared texture block
    sids = [max(s, 0) for s in lut] + [s for _, s in extra_layers]
    texs = atlas_p[:, jnp.asarray(sids, jnp.int32)]  # [4, KT, S, S]
    KT = len(sids)
    texs = texs.transpose(1, 0, 2, 3).reshape(KT * 4, S, S).astype(jnp.bfloat16)
    t1 = jnp.einsum("nrh,chw->ncrw", ohv, texs,
                    preferred_element_type=jnp.bfloat16)  # [N, KT4, OBS, S]
    t1 = t1.reshape(N, KT, 4, OBS, S)

    # Per-kind second-stage sampling fused with its blend: one
    # [N, KT, 4, OBS, OBS] einsum would materialize ~KT x the frame
    # (805 MB for 6 kinds at batch 4096); kind-at-a-time keeps the live
    # set to one frame.
    inv = jnp.bfloat16(1 / 255.0)

    def blend_one(img, kk, kind_id):
        sk = jnp.einsum("ncrw,nuw->ncru", t1[:, kk], ohu,
                        preferred_element_type=jnp.bfloat16)
        a = (Gi == kind_id).astype(jnp.bfloat16) * (sk[:, 3:4] * inv)
        return img + a * (sk[:, :3] - img)

    for k in range(K):
        if lut[k] < 0:
            continue
        img = blend_one(img, k, k)
    for j, (kind_id, _sid) in enumerate(extra_layers):
        img = blend_one(img, K + j, kind_id)
    return img


def finalize(img):
    """Planar bf16 [4, OBS, OBS] in [0,255] -> uint8 HWC observation.

    Stays in bf16 end to end: round/clip are exact there for the 0..255
    range, and skipping the f32 inflation saves ~1.2 GB of traffic per
    step at batch 8192.
    """
    rgb = jnp.clip(jnp.round(img[:3]), 0, 255)
    return jnp.moveaxis(rgb, 0, -1).astype(jnp.uint8)
