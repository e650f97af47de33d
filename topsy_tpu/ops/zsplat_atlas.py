"""Atlas-windowed z-buffered splatting: the surface-mode engine.

Uses the same presorted (bucket, Morton) machinery as the additive atlas
splatter (ops/splat_atlas.py) — per-group support-tight window anchors in
one stacked pyramid atlas, and bounded spill tiers — but each deposit keeps
the front-most hemisphere fragment per pixel instead of accumulating
(reference: src/topsy/sph.py:459-656).

One ``lax.scan`` body serves the main pass and both spill tiers: each step
forms a group's hemisphere fragments over each particle's footprint and
max-composites them into the group's atlas window (depth max, then the
largest value among the fragments at that depth).  The fragment arithmetic
is the scatter-max reference's (ops/zsplat.py) term for term, in
level-pixel coordinates, so with matched pyramid levels the two agree on
coverage, depth and winners.

Requires presorted input (the per-frame band sort is never paid: surface
interactive frames use the column-LOD slices, exports the full presorted
arrays).  The scatter-max path (ops/zsplat.py) remains the reference
implementation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from .splat import H_MIN, H_TRUNC, PyramidSpec, default_pyramid, exp2_int, \
    levels_from_buckets, project
from .splat_atlas import (BAND, COL_PAD, FOOT, PRESORTED_WINDOW_ROWS,
                          ROW_PAD, WINDOW_COLS, atlas_layout)
from .zsplat import HEMI_SUPPORT, hemisphere_kernel

GROUP = 512
WINDOW_ROWS = PRESORTED_WINDOW_ROWS


def _front_scan(atlas, groups, *, window_rows: int, window_cols: int):
    """Merge the front-most fragments of a sequence of particle groups into
    the (2=[depth, value], rows, cols) atlas.

    ``groups``: (cy, cx, roff, ih, z, hch, val, w0, c0) with the particle
    fields shaped (n_steps, G) and the window anchors (w0, c0) shaped
    (n_steps,).  cy/cx are level-pixel centres, roff the atlas row offset of
    the particle's level (float), ih the inverse smoothing (<= 0 marks a
    particle that deposits nothing here).

    Each particle's fragments are its 2*FOOT x 2*FOOT footprint, the
    reference's window (offsets -7..8 from the centre pixel); each step
    max-scatters a group's footprints into its atlas window, depth first,
    then the largest value among the fragments at the winning depth (the
    window's current winner included)."""
    size = window_rows * window_cols
    off = jnp.arange(2 * int(FOOT), dtype=jnp.int32) - (int(FOOT) - 1)

    def body(atlas, inputs):
        cy, cx, roff, ih, z, hch, val, w0, c0 = inputs
        py = jnp.floor(cy).astype(jnp.int32)[:, None] + off     # (G, F)
        px = jnp.floor(cx).astype(jnp.int32)[:, None] + off
        # integer pixel minus centre: one rounding, as in the reference
        dy = py.astype(jnp.float32) - cy[:, None]
        dx = px.astype(jnp.float32) - cx[:, None]
        q = jnp.sqrt(dy[:, :, None] ** 2 + dx[:, None, :] ** 2) \
            * ih[:, None, None]
        k = hemisphere_kernel(q)                                 # (G, F, F)
        r = py + roff.astype(jnp.int32)[:, None] - w0
        c = px + COL_PAD - c0
        ok = ((k >= 0.0) & (ih > 0.0)[:, None, None]
              & ((r >= 0) & (r < window_rows))[:, :, None]
              & ((c >= 0) & (c < window_cols))[:, None, :])
        dep = jnp.where(ok, z[:, None, None] + k * hch[:, None, None],
                        -jnp.inf).ravel()
        idx = jnp.where(ok, r[:, :, None] * window_cols + c[:, None, :],
                        size).ravel()
        cur = jax.lax.dynamic_slice(atlas, (0, w0, c0),
                                    (2, window_rows, window_cols))
        cur_d, cur_v = cur[0].ravel(), cur[1].ravel()
        new_d = cur_d.at[idx].max(dep, mode="drop")
        win = ok.ravel() & (dep == new_d[jnp.minimum(idx, size - 1)])
        vals = jnp.broadcast_to(val[:, None, None], ok.shape).ravel()
        new_v = jnp.where(cur_d == new_d, cur_v, -jnp.inf).at[idx].max(
            jnp.where(win, vals, -jnp.inf), mode="drop")
        new = jnp.stack([new_d, new_v]).reshape(2, window_rows, window_cols)
        return jax.lax.dynamic_update_slice(atlas, new, (0, w0, c0)), None

    atlas, _ = jax.lax.scan(body, atlas, groups)
    return atlas


def zsplat_atlas(pos_smooth, values, matrix, resolution, scale,
                 presorted_buckets, density_cut=0.0, extra_mask=None,
                 pyramid: PyramidSpec | None = None, giants="none",
                 group: int | None = None,
                 spill_group_cap: int | None = None,
                 t3_cap: int | None = None):
    """(N,4) x (N,>=2 [mass, qty]) -> ((res, res, 2) [value, depth], dropped).

    Same output contract as zsplat.zsplat_scatter; ``presorted_buckets``
    is required (arrays in ops/morton.py order).  Background depth is 0.

    ``giants``: 'none' keeps the truncated windowed hemisphere for
    over-window splats (the zsplat_scatter-compatible behavior), or a
    smoothing-bucket threshold — those splats are dropped here and the
    caller max-composites the exact dense layer
    (ops/splat_giant.zsplat_giant_image) instead.

    ``group``: particles per scan step; the surface column path passes the
    slice width so each original presorted group keeps its own (tight)
    window — flat slices reshape to one row per original group instead of
    merging pad_group/width of them (merged unions flood the spill tiers).

    ``spill_group_cap`` / ``t3_cap``: spill-tier budget overrides.  The
    whole-tier surface column path raises both: decimation-tier groups
    cover 8x the volume of main-layout groups, so whole-tier CHANGE frames
    overflow the default budgets.
    """
    if pyramid is None:
        pyramid = default_pyramid(resolution)

    n = pos_smooth.shape[0]
    G = group if group is not None else (
        GROUP if n >= 1 << 18 else (128 if n >= 1 << 14 else 64))
    n_pad = max(G, ((n + G - 1) // G) * G)

    row_offs, atlas_rows, atlas_cols = atlas_layout(pyramid)
    res_per_level = jnp.asarray(pyramid.level_resolutions, dtype=jnp.float32)
    row_offs_arr = jnp.asarray(row_offs, dtype=jnp.float32)
    window_rows = WINDOW_ROWS

    # ---- front-end: projection, level placement, payload -------------------
    cx, cy, z01, h_px, visible = project(pos_smooth, matrix, resolution, scale)
    px_per_world = resolution / (2.0 * scale)
    lev = levels_from_buckets(presorted_buckets, px_per_world,
                              pyramid.num_levels)
    from .splat import assign_levels
    lev, h_eff, _tiny = assign_levels(h_px, pyramid.num_levels, lev=lev)
    h_eff = jnp.clip(h_eff, H_MIN, H_TRUNC)
    inv_lev_scale = exp2_int(-lev)
    cx_l = (cx + 0.5) * inv_lev_scale - 0.5
    cy_l = (cy + 0.5) * inv_lev_scale - 0.5

    mass = values[:, 0]
    qty = values[:, 1]
    h_world = pos_smooth[:, 3]
    rho = mass / jnp.maximum(h_world, 1e-30) ** 3
    ok = visible & (rho > density_cut)
    if extra_mask is not None:
        ok = ok & extra_mask
    if giants != "none":
        from .splat_giant import GIANT_H
        h_l = h_px * inv_lev_scale
        ok = ok & ~((h_l > GIANT_H)
                    & (presorted_buckets >= jnp.asarray(giants, jnp.int32)))
    h_clip_half = h_world / scale * 0.5

    res_l = res_per_level[lev]
    # off-image splats are clipped into the guard margin, so they deposit
    # only into padding (cropped later) — the reference's viewport clipping
    margin = float(COL_PAD) - FOOT + 4.0
    cyc = jnp.clip(cy_l, -margin, res_l + margin)
    cxc = jnp.clip(cx_l, -margin, res_l + margin)
    roff = row_offs_arr[lev]
    sentinel_ay = float(atlas_rows - ROW_PAD + FOOT + 2.0)
    ay = jnp.where(jnp.isnan(cyc), sentinel_ay, roff + cyc)
    ax = jnp.where(jnp.isnan(cxc), float(COL_PAD), COL_PAD + cxc)
    ok = ok & jnp.isfinite(z01) & jnp.isfinite(h_clip_half) \
        & jnp.isfinite(cyc) & jnp.isfinite(cxc)
    inv_h = jnp.where(ok, 1.0 / h_eff, 0.0)

    def pad_to(x, fill):
        return jnp.concatenate(
            [x, jnp.full((n_pad - n,) + x.shape[1:], fill, x.dtype)])

    ay_s = pad_to(ay, sentinel_ay)
    ax_s = pad_to(ax, float(COL_PAD))
    ih_s = pad_to(inv_h, 0.0)
    # payload: every field a scan step needs besides the anchors
    pay = tuple(pad_to(jnp.nan_to_num(a), 0.0)
                for a in (cyc, cxc, roff, z01, h_clip_half, qty))

    # ---- anchors and fits (as splat_atlas, support-tight) ------------------
    n_groups = n_pad // G
    sup_s = jnp.where(ih_s > 0.0,
                      jnp.minimum(HEMI_SUPPORT / jnp.maximum(ih_s, 1e-30),
                                  FOOT), 1.0)
    ay_lo = ay_s - sup_s
    ay_hi = ay_s + sup_s
    ax_lo = ax_s - sup_s
    ax_hi = ax_s + sup_s
    lo_r = ay_lo.reshape(n_groups, G).min(axis=1)
    lo_c = ax_lo.reshape(n_groups, G).min(axis=1)
    w0 = (jnp.floor(lo_r / BAND).astype(jnp.int32) * BAND)
    w0 = jnp.clip(w0, 0, ((atlas_rows - window_rows) // BAND) * BAND)
    c0 = jnp.clip(jnp.floor(lo_c).astype(jnp.int32), 0,
                  atlas_cols - WINDOW_COLS)

    w0_rep = jnp.repeat(w0, G).astype(jnp.float32)
    c0_rep = jnp.repeat(c0, G).astype(jnp.float32)
    fits = ((ay_hi < w0_rep + window_rows)
            & (ax_hi < c0_rep + WINDOW_COLS)
            & (ax_lo >= c0_rep))
    ih_fit = jnp.where(fits, ih_s, 0.0)

    def fields(ih, cy, cx, roff, z, hch, val, steps, g):
        return tuple(a.reshape(steps, g)
                     for a in (cy, cx, roff, ih, z, hch, val))

    atlas = jnp.zeros((2, atlas_rows, atlas_cols), dtype=jnp.float32)
    atlas = _front_scan(atlas, fields(ih_fit, *pay, n_groups, G) + (w0, c0),
                        window_rows=window_rows, window_cols=WINDOW_COLS)

    # ---- spill tiers (mirrors splat_atlas.spill_pass; max semantics) -------
    spilled = ~fits & (ih_s > 0.0)
    per_group_spill = spilled.reshape(n_groups, G).sum(axis=1)
    n_spill = per_group_spill.sum()
    G_SPILL = max(16, G // 8)
    k_groups = min(n_groups, (config.SPLAT_SPILL_GROUP_CAP
                              if spill_group_cap is None
                              else spill_group_cap))
    spill_cap = k_groups * G

    def do_spill(atlas):
        _, top_idx = jax.lax.top_k(per_group_spill, k_groups)
        # layout order: gathered groups stay spatially adjacent
        top_idx = jnp.sort(top_idx)

        def gather(arr):
            return jnp.take(arr.reshape(n_groups, G), top_idx,
                            axis=0).reshape(spill_cap)

        valid = gather(spilled)
        s_ay = gather(ay_s)
        s_ax = gather(ax_s)
        s_ih = jnp.where(valid, gather(ih_s), 0.0)
        s_pay = tuple(gather(a) for a in pay)

        n_sg = spill_cap // G_SPILL
        valid2 = valid.reshape(n_sg, G_SPILL)
        ay2 = s_ay.reshape(n_sg, G_SPILL)
        ay2m = jnp.where(valid2, ay2, jnp.inf).min(axis=1)
        ay2m = jnp.where(jnp.isfinite(ay2m), ay2m, float(ROW_PAD))
        sw0 = (jnp.floor((ay2m - FOOT) / BAND).astype(jnp.int32) * BAND)
        sw0 = jnp.clip(sw0, 0, ((atlas_rows - window_rows) // BAND) * BAND)

        # tier 2: full-width windows, so only row stragglers fall through
        sw0_rep = jnp.repeat(sw0, G_SPILL).astype(jnp.float32)
        fits2 = (s_ay + FOOT < sw0_rep + window_rows) & valid
        straggler = ~fits2 & valid
        n3 = straggler.sum()
        atlas = _front_scan(
            atlas, fields(jnp.where(fits2, s_ih, 0.0), *s_pay, n_sg,
                          G_SPILL) + (sw0, jnp.zeros_like(sw0)),
            window_rows=window_rows, window_cols=atlas_cols)

        # tier 3: per-particle windows (fit by construction)
        T3 = min(1024 if t3_cap is None else t3_cap, spill_cap)

        def do_t3(atlas):
            big3 = jnp.int32(np.iinfo(np.int32).max)
            key3 = jnp.where(straggler,
                             jnp.arange(spill_cap, dtype=jnp.int32), big3)
            ops3 = jax.lax.sort((key3, s_ay, s_ax, s_ih) + s_pay,
                                num_keys=1)
            valid3 = ops3[0][:T3] < big3
            t_ay, t_ax, t_ih = (o[:T3] for o in ops3[1:4])
            t_pay = tuple(o[:T3] for o in ops3[4:])
            tw0 = (jnp.floor((t_ay - FOOT) / BAND).astype(jnp.int32) * BAND)
            tw0 = jnp.clip(tw0, 0, ((atlas_rows - window_rows) // BAND) * BAND)
            tc0 = jnp.clip(jnp.floor(t_ax - FOOT).astype(jnp.int32),
                           0, atlas_cols - WINDOW_COLS)
            return _front_scan(
                atlas, fields(jnp.where(valid3, t_ih, 0.0), *t_pay, T3, 1)
                + (tw0, tc0),
                window_rows=window_rows, window_cols=WINDOW_COLS)

        atlas = jax.lax.cond(n3 > 0, do_t3, lambda a: a, atlas)
        not_gathered = n_spill - valid.sum()
        return atlas, not_gathered + jnp.maximum(n3 - T3, 0)

    atlas, dropped = jax.lax.cond(n_spill > 0, do_spill,
                                  lambda a: (a, jnp.int32(0)), atlas)

    return collapse_max_atlas(atlas, pyramid), dropped


def collapse_max_atlas(atlas: jnp.ndarray, pyramid: PyramidSpec):
    """Max-composite the channel-major (2=[depth, value], rows, cols) atlas
    pyramid into a (res, res, 2) [value, depth] image (the zsplat contract).

    Coarse levels are upsampled with coverage-normalized bilinear filtering
    (ops/composite.upsample2x_zmax_cm): interpolating (depth, value)
    directly would smear silhouettes into the empty background — a raw
    bilinear collapse measured up to 2^level fine pixels of spurious faint
    coverage beyond the true footprint, which the reference's rasterizer
    (exact fragments at full resolution) never produces.  Upsampled coarse
    content loses against finer content only where the finer fragment is in
    front — the occlusion analogue of the additive collapse (same rule as
    zsplat._collapse_max)."""
    from .composite import upsample2x_zmax_cm
    row_offs, _, _ = atlas_layout(pyramid)
    levels = []
    for l, res_l in enumerate(pyramid.level_resolutions):
        r0 = row_offs[l]
        levels.append(atlas[:, r0:r0 + res_l, COL_PAD:COL_PAD + res_l])
    out = levels[-1]
    for l in range(pyramid.num_levels - 2, -1, -1):
        target = pyramid.level_resolutions[l]
        up = upsample2x_zmax_cm(out)[:, :target, :target]
        fine = levels[l]
        front = fine[0] >= up[0]
        out = jnp.where(front[None], fine, up)
    depth = jnp.maximum(out[0], 0.0)
    value = jnp.where(out[0] > 0.0, out[1], 0.0)
    return jnp.stack([value, depth], axis=-1)
