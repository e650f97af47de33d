"""The additive windowed splatter: sorted groups deposited by matmuls.

Each particle's separable low-rank kernel decomposition (ops/kernels.py)

    deposit(dy, dx) = sum_k s_k * p_k((dy/h)^2) * p_k((dx/h)^2)

makes all deposits of a group of G particles into a (rows x cols) window

    out[r, (w, c)] = sum_{k, i} P[k, i, r] * (Q[k, i, w] * coef[i, c])

— one (rows x G*rank) @ (G*rank x W*C) matrix product.  The pipeline:

1. project + level-assign particles (ops/splat.py front-end); all pyramid
   levels live stacked in one padded "atlas" canvas so there is one code path;
2. order particles so consecutive groups are spatially local: one variadic
   ``lax.sort`` by (8-row atlas band, column) carrying the per-particle
   payload, or no sort at all when the arrays come in the static presorted
   (smoothing-bucket, Morton) order (ops/morton.py);
3. ``lax.scan`` over fixed groups; each group accumulates into a
   dynamically positioned window of the atlas (``dynamic_update_slice``);
4. particles that do not fit their group's window are deposited by the
   bounded spill tiers (``spill_pass``), executed only when spills exist;
5. crop the levels out of the atlas, upsample and sum.

Everything is static-shaped; particle counts are handled by masking, so a
given (bucket size, resolution, channels) compiles exactly once.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from . import kernels
from .splat import (PyramidSpec, default_pyramid, profiles_select,
                    splat_coefficients)

GROUP = 512                 # particles per matmul group
WINDOW_ROWS = 64            # rows of the dynamic accumulation window
PRESORTED_WINDOW_ROWS = 96  # presorted groups span whole Morton cells
WINDOW_COLS = 256           # cols of the dynamic accumulation window
BAND = config.SPLAT_BAND_ROWS
COL_PAD = config.SPLAT_ATLAS_COL_PAD
ROW_PAD = config.SPLAT_ATLAS_PAD
FOOT = 8.0                  # footprint half-width in level pixels
# The deposit matmul's precision.  DEFAULT lets the GPU run the float32
# product in TF32 (10 mantissa bits, float32 accumulation).  Measured on an
# H100 at 2^24 particles, 1024^2, against the float32 scatter reference
# (PERF.md): TF32 leaves the image mean within 1.1e-4, the std within
# 7.4e-5 and the pixel correlation at 0.9999999999 — against tolerances of
# 0.005, 0.02 and 0.999, the error being dominated by the rank-2 kernel
# fit either way — and the EXPORT frame is 25% faster than at HIGHEST.
DEPOSIT_PRECISION = jax.lax.Precision.DEFAULT


def atlas_layout(pyramid: PyramidSpec):
    """Row offset of each level region in the atlas, and total atlas shape."""
    row_offs = []
    r = ROW_PAD
    for res_l in pyramid.level_resolutions:
        row_offs.append(r)
        r += res_l + ROW_PAD
    width = max(pyramid.resolution + 2 * COL_PAD, WINDOW_COLS)
    return tuple(row_offs), r, width


def make_group_contribution(lrk, C: int):
    """Window-deposit closure for the main scan and the spill tiers."""

    def group_contribution(ay_g, ax_g, inv_h_g, coef_g, w0_g, c0_g, rows, cols):
        """(rows x G*rank) @ (G*rank x W*C) deposit for one particle group."""
        n_rows = rows.shape[0]
        dy = (w0_g + rows)[None, :] - ay_g[:, None]              # (G, R)
        dx = (c0_g + cols)[None, :] - ax_g[:, None]              # (G, W)
        ymask = (dy > -FOOT) & (dy <= FOOT)
        xmask = (dx > -FOOT) & (dx <= FOOT)
        ty2 = (dy * inv_h_g[:, None]) ** 2
        tx2 = (dx * inv_h_g[:, None]) ** 2
        tiny_g = (inv_h_g < 0)[:, None]                          # (G, 1)
        P = profiles_select(ty2, tiny_g, lrk, signed=True) * ymask[None]
        Q = profiles_select(tx2, tiny_g, lrk, signed=False) * xmask[None]
        # fold channel coefficients into the (small) row-profile side instead
        # of materializing a (K, G, W, C) tensor
        PC = P[:, :, :, None] * coef_g[None, :, None, :]         # (K, G, R, C)
        PC2 = PC.reshape(-1, n_rows * C)                         # (K*G, R*C)
        Q2 = Q.reshape(PC2.shape[0], -1)                         # (K*G, W)
        out = jnp.einsum("xr,xw->rw", PC2, Q2,
                         preferred_element_type=jnp.float32,
                         precision=DEPOSIT_PRECISION)
        return out.reshape(n_rows, C, -1).transpose(1, 0, 2)     # (C, R, W)

    return group_contribution


def splat_atlas(pos_smooth, values, matrix, resolution, scale,
                extra_mask=None, pyramid: PyramidSpec | None = None,
                depth_channel=False, presorted_buckets=None, giants="auto"):
    """Matmul-based splatter; same contract as splat.splat_scatter.

    ``presorted_buckets``: per-particle static smoothing buckets signalling
    that the arrays are already in (bucket, Morton) order with padded runs
    (ops/morton.py) — the per-frame sort is skipped entirely and levels are
    derived from the buckets.
    Returns (image (res, res, C), spilled_dropped count).
    """
    if pyramid is None:
        pyramid = default_pyramid(resolution)
    lrk = kernels.lowrank_kernel()
    level_override = None
    if presorted_buckets is not None:
        from .splat import levels_from_buckets
        px_per_world = resolution / (2.0 * scale)
        level_override = levels_from_buckets(presorted_buckets, px_per_world,
                                             pyramid.num_levels)
    parts = splat_coefficients(pos_smooth, values, matrix, resolution, scale,
                               pyramid, extra_mask, mode="lowrank",
                               depth_channel=depth_channel,
                               level_override=level_override)
    C = values.shape[1] + (1 if depth_channel else 0)
    n = pos_smooth.shape[0]
    # group size adapts to the scene size: sparse scenes need smaller groups
    # so a group's (band, column) span still fits its accumulation window
    # (the column-LOD path relies on this n-based choice plus the layout's
    # run-quantum alignment to keep merged slice groups single-level)
    if n >= 1 << 18:
        G = GROUP
    elif n >= 1 << 14:
        G = 128
    else:
        G = 64
    n_pad = max(G, ((n + G - 1) // G) * G)

    row_offs, atlas_rows, atlas_cols = atlas_layout(pyramid)
    res_per_level = jnp.asarray(pyramid.level_resolutions, dtype=jnp.float32)
    row_offs_arr = jnp.asarray(row_offs, dtype=jnp.float32)

    # giants: exclude from the windowed deposit; their exact full-support
    # image comes from the dense pass (ops/splat_giant.py).  Three modes:
    # 'auto' selects + renders internally via top_k (correct anywhere, one
    # top_k per call); an integer/traced *bucket threshold* excludes giants
    # whose smoothing bucket >= it and renders NOTHING here — the caller
    # owns one dense layer per frame over the layout's static candidate
    # pool (render/sph._giant_layer; buckets travel with the data, so the
    # same threshold is valid through column slices, mip tiers and mesh
    # slabs); 'none' keeps the truncated deposit (A/B tests).
    from . import splat_giant
    giant_args = None
    if giants == "auto":
        gidx, gvalid, excluded = splat_giant.select_giants_topk(
            parts["giant"], parts["h_px"], splat_giant.CAP)
        giant_args = (parts["cy_fine"][gidx], parts["cx_fine"][gidx],
                      parts["h_px"][gidx],
                      parts["coef_giant"][gidx] * gvalid[:, None])
        parts["coef"] = jnp.where(excluded[:, None], 0.0, parts["coef"])
    elif giants != "none":
        assert presorted_buckets is not None, \
            "bucket-threshold giant exclusion needs presorted_buckets"
        excluded = (parts["giant"]
                    & (presorted_buckets >= jnp.asarray(giants, jnp.int32)))
        parts["coef"] = jnp.where(excluded[:, None], 0.0, parts["coef"])

    lev = parts["level"]
    res_l = res_per_level[lev]
    # clip centres into the guard margin so off-image splats deposit only
    # into padding (cropped later) — same viewport clipping as the reference
    margin = float(COL_PAD) - FOOT + 4.0  # 12 px
    cy = jnp.clip(parts["cy"], -margin, res_l + margin)
    cx = jnp.clip(parts["cx"], -margin, res_l + margin)
    ay = row_offs_arr[lev] + cy
    ax = COL_PAD + cx
    # sign trick: negative inv_h flags a tiny (CIC) splat; profiles only see
    # inv_h^2 so the magnitude is unaffected, and the flag survives the sort
    # without an extra payload operand
    inv_h = jnp.where(parts["tiny"], -1.0, 1.0 / parts["h_eff"])
    coef = parts["coef"]

    sentinel_ay = float(atlas_rows - ROW_PAD + FOOT + 2.0)

    def pad_to(x, fill):
        return jnp.concatenate([x, jnp.full((n_pad - n,) + x.shape[1:], fill, x.dtype)])

    if presorted_buckets is not None:
        # arrays are already (bucket, Morton)-ordered with padded runs:
        # consecutive particles are spatially local and single-level, so the
        # per-frame sort is skipped.  Inactive particles keep their (clamped)
        # projected positions — they are spatially consistent with their
        # neighbours and carry zero coefficients.  NaN projections (always
        # inactive: non-finite inputs are masked) must not poison group-min
        # window anchors.
        ay = jnp.where(jnp.isnan(ay), sentinel_ay, ay)
        ax = jnp.where(jnp.isnan(ax), float(COL_PAD), ax)
        ay_s = pad_to(ay, sentinel_ay)
        ax_s = pad_to(ax, float(COL_PAD))
        inv_h_s = pad_to(inv_h, 1.0)
        coef_s = pad_to(coef, 0.0)
    else:
        # sort key: (row band, tiny class, column); masked/invisible
        # particles take the sentinel key and collect in trailing groups.
        band = jnp.floor(ay / BAND).astype(jnp.int32)
        xkey = jnp.clip(jnp.floor(ax).astype(jnp.int32), 0, 2047)
        key = band * 4096 + jnp.where(parts["tiny"], 0, 2048) + xkey

        sentinel_key = (int(sentinel_ay // BAND) + 2) * 4096
        active = jnp.abs(coef).sum(axis=1) > 0.0
        key = jnp.where(active, key, sentinel_key)
        ay = jnp.where(active, ay, sentinel_ay)
        ax = jnp.where(active, ax, float(COL_PAD))

        key = pad_to(key, sentinel_key)
        ay = pad_to(ay, sentinel_ay)
        ax = pad_to(ax, float(COL_PAD))
        inv_h = pad_to(inv_h, 1.0)
        coef = pad_to(coef, 0.0)

        operands = (key, ay, ax, inv_h) + tuple(coef[:, c] for c in range(C))
        sorted_ops = jax.lax.sort(operands, num_keys=1)
        _, ay_s, ax_s, inv_h_s = sorted_ops[:4]
        coef_s = jnp.stack(sorted_ops[4:], axis=-1)

    n_groups = n_pad // G
    # per-particle true support radius in level pixels (the deposit is
    # exactly zero beyond it): 1 for CIC hats, KERNEL_SUPPORT * h_eff for
    # polynomials, FOOT for oversize footprint-truncated splats.  Anchoring
    # windows and fit tests on it (instead of the worst-case FOOT) shrinks
    # group spans by up to 14 px and reduces spills.
    sup_s = jnp.where(inv_h_s < 0.0, 1.0,
                      jnp.minimum(kernels.KERNEL_SUPPORT / inv_h_s, FOOT))
    ay_lo = ay_s - sup_s
    ay_hi = ay_s + sup_s
    ax_lo = ax_s - sup_s
    ax_hi = ax_s + sup_s
    lo_r = ay_lo.reshape(n_groups, G).min(axis=1)
    lo_c = ax_lo.reshape(n_groups, G).min(axis=1)
    # window anchor per group: min supported row band / column in the group
    window_rows = (PRESORTED_WINDOW_ROWS if presorted_buckets is not None
                   else WINDOW_ROWS)
    w0 = (jnp.floor(lo_r / BAND).astype(jnp.int32) * BAND)
    w0 = jnp.clip(w0, 0, ((atlas_rows - window_rows) // BAND) * BAND)
    c0 = jnp.clip(jnp.floor(lo_c).astype(jnp.int32), 0,
                  atlas_cols - WINDOW_COLS)

    w0_rep = jnp.repeat(w0, G).astype(jnp.float32)
    c0_rep = jnp.repeat(c0, G).astype(jnp.float32)
    fits = ((ay_hi < w0_rep + window_rows)
            & (ax_hi < c0_rep + WINDOW_COLS)
            & (ax_lo >= c0_rep))
    coef_fit = jnp.where(fits[:, None], coef_s, 0.0)

    group_contribution = make_group_contribution(lrk, C)

    rows_win = jnp.arange(window_rows, dtype=jnp.float32)
    cols_win = jnp.arange(WINDOW_COLS, dtype=jnp.float32)

    def body(atlas, inputs):
        ay_g, ax_g, inv_h_g, coef_g, w0_g, c0_g = inputs
        contrib = group_contribution(ay_g, ax_g, inv_h_g, coef_g,
                                     w0_g.astype(jnp.float32),
                                     c0_g.astype(jnp.float32),
                                     rows_win, cols_win)
        cur = jax.lax.dynamic_slice(atlas, (0, w0_g, c0_g),
                                    (C, window_rows, WINDOW_COLS))
        atlas = jax.lax.dynamic_update_slice(atlas, cur + contrib,
                                             (0, w0_g, c0_g))
        return atlas, None

    atlas0 = jnp.zeros((C, atlas_rows, atlas_cols), dtype=jnp.float32)
    per_group = (ay_s.reshape(n_groups, G), ax_s.reshape(n_groups, G),
                 inv_h_s.reshape(n_groups, G),
                 coef_fit.reshape(n_groups, G, C),
                 w0, c0)
    atlas, _ = jax.lax.scan(body, atlas0, per_group)

    # ---- spill pass: particles too sparse for their group window ----------
    spilled = ~fits & (jnp.abs(coef_s).sum(axis=1) > 0.0)
    per_group_spill = spilled.reshape(n_groups, G).sum(axis=1)
    n_spill = per_group_spill.sum()
    atlas, dropped = spill_pass(
        atlas, ay_s, ax_s, inv_h_s, coef_s, spilled, per_group_spill,
        n_spill, C=C, G=G, atlas_rows=atlas_rows,
        atlas_cols=atlas_cols, window_rows=window_rows,
        group_contribution=group_contribution)

    image = collapse_atlas(atlas, pyramid)
    if giant_args is not None:
        image = image + splat_giant.giant_image(*giant_args, resolution)
    return image, dropped


def spill_pass(atlas, ay_s, ax_s, inv_h_s, coef_s, spilled, per_group_spill,
               n_spill, *, C, G, atlas_rows, atlas_cols, window_rows,
               group_contribution):
    """Deposit spilled particles (too sparse for their group's window).

    Re-runs the same windowed machinery with much smaller groups on the
    spilled subset.  Compaction is GROUP-granular: top-k over per-group
    spill counts (n_groups keys) + a contiguous row gather — never a
    full-length particle sort, which would cost as much as the main sort.
    Groups that small fit their windows except in pathologically empty
    regions, whose few stragglers go to a third tier of one-particle
    windows; what exceeds the tiers' capacities is dropped with an explicit
    count.

    ay_s/ax_s/inv_h_s: (n_pad,) anchors; coef_s: (n_pad, C) coefficients;
    group_contribution: the window-deposit closure.  Returns
    (atlas, dropped_count).
    """
    n_groups = per_group_spill.shape[0]
    G_SPILL = max(16, G // 8)
    k_groups = min(n_groups, config.SPLAT_SPILL_GROUP_CAP)
    spill_cap = k_groups * G

    def do_spill(atlas):
        _, top_idx = jax.lax.top_k(per_group_spill, k_groups)
        # layout order, not spill-count order: gathered groups keep their
        # spatial adjacency, so consecutive spill subgroups share bands
        top_idx = jnp.sort(top_idx)

        def gather(arr):
            return jnp.take(arr.reshape(n_groups, G, -1), top_idx,
                            axis=0).reshape(spill_cap, -1)

        valid = gather(spilled)[:, 0]
        s_ay = gather(ay_s)[:, 0]
        s_ax = gather(ax_s)[:, 0]
        s_ih = gather(inv_h_s)[:, 0]
        s_coef = jnp.where(valid[:, None], gather(coef_s), 0.0)

        n_sg = spill_cap // G_SPILL
        ay2 = s_ay.reshape(n_sg, G_SPILL)
        valid2 = valid.reshape(n_sg, G_SPILL)
        # windows anchored on valid members only (padding must not drag them)
        ay2m = jnp.where(valid2, ay2, jnp.inf).min(axis=1)
        ay2m = jnp.where(jnp.isfinite(ay2m), ay2m, float(ROW_PAD))
        sw0 = (jnp.floor((ay2m - FOOT) / BAND).astype(jnp.int32) * BAND)
        sw0 = jnp.clip(sw0, 0, ((atlas_rows - window_rows) // BAND) * BAND)

        # spill windows span the full atlas width, so only row-stragglers
        # (pathologically empty stretches) fall through to tier 3
        sw0_rep = jnp.repeat(sw0, G_SPILL).astype(jnp.float32)
        fits2 = (s_ay + FOOT < sw0_rep + window_rows) & valid
        s_coef_fit = jnp.where(fits2[:, None], s_coef, 0.0)
        straggler = ~fits2 & valid
        n3 = straggler.sum()

        rows_w = jnp.arange(window_rows, dtype=jnp.float32)
        cols_full = jnp.arange(atlas_cols, dtype=jnp.float32)

        def sbody(atlas, inputs):
            ay_g, ax_g, ih_g, coef_g, w0_g = inputs
            contrib = group_contribution(ay_g, ax_g, ih_g, coef_g,
                                         w0_g.astype(jnp.float32),
                                         jnp.float32(0.0),
                                         rows_w, cols_full)
            cur = jax.lax.dynamic_slice(atlas, (0, w0_g, 0),
                                        (C, window_rows, atlas_cols))
            return jax.lax.dynamic_update_slice(atlas, cur + contrib,
                                                (0, w0_g, 0)), None

        atlas, _ = jax.lax.scan(
            sbody, atlas,
            (ay2, s_ax.reshape(n_sg, G_SPILL),
             s_ih.reshape(n_sg, G_SPILL),
             s_coef_fit.reshape(n_sg, G_SPILL, C), sw0))

        # ---- final tier: per-particle windows (fit by construction) -------
        T3 = min(1024, spill_cap)

        def do_t3(atlas):
            big3 = jnp.int32(np.iinfo(np.int32).max)
            key3 = jnp.where(straggler,
                             jnp.arange(spill_cap, dtype=jnp.int32), big3)
            ops3 = jax.lax.sort((key3, s_ay, s_ax, s_ih)
                                + tuple(s_coef[:, c] for c in range(C)),
                                num_keys=1)
            valid3 = ops3[0][:T3] < big3
            t_ay = ops3[1][:T3]
            t_ax = ops3[2][:T3]
            t_ih = ops3[3][:T3]
            t_coef = jnp.stack([o[:T3] for o in ops3[4:]], axis=-1)
            t_coef = jnp.where(valid3[:, None], t_coef, 0.0)
            tw0 = (jnp.floor((t_ay - FOOT) / BAND).astype(jnp.int32) * BAND)
            tw0 = jnp.clip(tw0, 0, ((atlas_rows - window_rows) // BAND) * BAND)
            # per-particle column windows always fit (footprint <= 17 px)
            tc0 = jnp.floor(t_ax - FOOT).astype(jnp.int32)
            tc0 = jnp.clip(tc0, 0, atlas_cols - WINDOW_COLS)
            cols_w = jnp.arange(WINDOW_COLS, dtype=jnp.float32)

            def tbody(atlas, inputs):
                ay_g, ax_g, ih_g, coef_g, w0_g, c0_g = inputs
                contrib = group_contribution(
                    ay_g[None], ax_g[None], ih_g[None], coef_g[None],
                    w0_g.astype(jnp.float32), c0_g.astype(jnp.float32),
                    rows_w, cols_w)
                cur = jax.lax.dynamic_slice(atlas, (0, w0_g, c0_g),
                                            (C, window_rows, WINDOW_COLS))
                return jax.lax.dynamic_update_slice(atlas, cur + contrib,
                                                    (0, w0_g, c0_g)), None

            atlas, _ = jax.lax.scan(tbody, atlas,
                                    (t_ay, t_ax, t_ih, t_coef, tw0, tc0))
            return atlas

        atlas = jax.lax.cond(n3 > 0, do_t3, lambda a: a, atlas)
        not_gathered = n_spill - valid.sum()
        return atlas, not_gathered + jnp.maximum(n3 - T3, 0)

    return jax.lax.cond(n_spill > 0, do_spill,
                        lambda a: (a, jnp.int32(0)), atlas)


def collapse_atlas(atlas: jnp.ndarray, pyramid: PyramidSpec) -> jnp.ndarray:
    """Crop levels from the channel-major (C, rows, cols) atlas, upsample
    coarse->fine, sum, and return the image as (res, res, C)."""
    row_offs, _, _ = atlas_layout(pyramid)
    levels = []
    for l, res_l in enumerate(pyramid.level_resolutions):
        r0 = row_offs[l]
        levels.append(atlas[:, r0:r0 + res_l, COL_PAD:COL_PAD + res_l])
    out = levels[-1]
    for l in range(pyramid.num_levels - 2, -1, -1):
        from .composite import upsample2x_kind_cm
        target = pyramid.level_resolutions[l]
        up = upsample2x_kind_cm(out, config.PYRAMID_COLLAPSE_FILTER)
        out = levels[l] + up[:, :target, :target]
    return out.transpose(1, 2, 0)
