"""Particle splatting: the render core.

The reference's instanced-quad additive-blend rasterizer pipeline
(reference: src/topsy/sph.py:221-362, shaders/sph.wgsl) becomes an array
program:

* particles are projected with a 4x4 matrix (one small matmul),
* each splat is assigned to a resolution-pyramid level so its footprint is a
  bounded number of *level* pixels (the analogue of the reference's kernel
  mip levels, reference: sph.py:396-426),
* kernel-weighted contributions are accumulated into per-level framebuffers,
* levels are bilinearly up-sampled and summed into the final image.

Two interchangeable accumulation backends:

* ``splat_scatter``: straightforward windowed scatter-add.  Exact and simple;
  fast on CPU, used for tests and as the ground-truth implementation.
* ``splat_atlas`` (see splat_atlas.py): the fast path — orders splats so
  consecutive groups are spatially local and accumulates each group into a
  window of a stacked level atlas via low-rank outer-product matmuls.

Both conserve mass exactly via the discrete normalization table
(ops/kernels.py) and produce distribution-identical images.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from . import kernels

WINDOW = config.SPLAT_WINDOW
H_MAX = config.SPLAT_MAX_HALF_SIZE_PX
H_MIN = config.SPLAT_MIN_HALF_SIZE_PX
H_TRUNC = 16.0  # coarsest-level smoothing clamp for the norm table domain


# ---------------------------------------------------------------------------
# geometry of the level pyramid
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PyramidSpec:
    resolution: int
    num_levels: int
    pad: int  # padding pixels on each side of each level buffer

    @property
    def level_resolutions(self) -> tuple[int, ...]:
        # ceil division: every level fully covers the image so non-power-of-2
        # resolutions upsample by an exact factor of 2 (then crop)
        return tuple(max(1, -(-self.resolution // (1 << l)))
                     for l in range(self.num_levels))

    @property
    def padded_sizes(self) -> tuple[int, ...]:
        return tuple(r + 2 * self.pad for r in self.level_resolutions)

    @property
    def flat_offsets(self) -> tuple[int, ...]:
        offs = [0]
        for s in self.padded_sizes:
            offs.append(offs[-1] + s * s)
        return tuple(offs)

    @property
    def flat_size(self) -> int:
        return self.flat_offsets[-1]


def default_pyramid(resolution: int) -> PyramidSpec:
    # coarsest level is 16px so a full kernel footprint (14 level px) always
    # fits inside a level image; giant splats beyond that truncate at the
    # coarsest window with compensated mass
    n = min(config.SPLAT_PYRAMID_LEVELS,
            max(1, int(np.log2(max(resolution, 16) / 16)) + 1))
    return PyramidSpec(resolution=resolution, num_levels=n, pad=WINDOW)


# ---------------------------------------------------------------------------
# projection & level assignment (shared by all backends)
# ---------------------------------------------------------------------------

def project(pos_smooth: jnp.ndarray, matrix: jnp.ndarray, resolution: int,
            scale: float | jnp.ndarray):
    """Project particles to screen space.

    pos_smooth: (N, 4) [x, y, z, h]; matrix: (4, 4) world->clip.
    Returns (cx, cy) fractional pixel coords (pixel centres at integers),
    z01 (clip depth in [0, 1] when visible), h_px (smoothing length in
    pixels), visible mask (z-culling as the rasterizer would do).
    """
    # explicit linear combination instead of concat-ones + (N,4)@(4,4):
    # the concat materializes a 16B/particle copy; three 4-term FMAs fuse
    # into the single elementwise pass
    # XLA already makes over the columns (the w row is an affine constant 1)
    x, y, z = pos_smooth[:, 0], pos_smooth[:, 1], pos_smooth[:, 2]
    m = matrix
    clip_x = x * m[0, 0] + y * m[0, 1] + z * m[0, 2] + m[0, 3]
    clip_y = x * m[1, 0] + y * m[1, 1] + z * m[1, 2] + m[1, 3]
    z01 = x * m[2, 0] + y * m[2, 1] + z * m[2, 2] + m[2, 3]
    cx = (clip_x + 1.0) * (resolution / 2.0) - 0.5
    cy = (1.0 - clip_y) * (resolution / 2.0) - 0.5
    h_px = pos_smooth[:, 3] * (resolution / (2.0 * scale))
    visible = (z01 >= 0.0) & (z01 <= 1.0) & (h_px > 0.0) & jnp.isfinite(h_px)
    return cx, cy, z01, h_px, visible


def assign_levels(h_px: jnp.ndarray, num_levels: int, lev=None):
    """Pyramid level per splat and the effective smoothing in level pixels.

    Splats smaller than H_MIN level-pixels are flagged ``tiny``: they deposit
    via a cloud-in-cell bilinear hat (exactly mass conserving at every pixel
    phase) with h_eff fixed to 1, instead of a phase-averaged normalized
    kernel, which would alias for sub-pixel splats whose positions correlate
    with the pixel grid.

    ``lev`` overrides the per-splat level choice (the presorted path derives
    it from static smoothing buckets, see levels_from_buckets); the exact
    smoothing is still used for h_eff, so the deposit itself is unchanged.
    """
    if lev is None:
        lev = ceil_log2_pos(jnp.maximum(h_px, 1e-30) / H_MAX)
        lev = jnp.clip(lev, 0, num_levels - 1)
    h_l = h_px * exp2_int(-lev)
    tiny = h_l < H_MIN
    h_eff = jnp.where(tiny, 1.0, jnp.clip(h_l, H_MIN, H_TRUNC))
    return lev, h_eff, tiny


def levels_from_buckets(buckets: jnp.ndarray, px_per_world, num_levels: int):
    """Pyramid levels derived from static 1/8-octave smoothing buckets.

    Uses each bucket's *upper edge* as the representative smoothing so the
    derived level never undershoots: ``h_eff = h_px * 2^-lev <= H_MAX``
    holds exactly, as with per-splat levels.  Because the level is a
    function of the bucket alone, a presorted bucket run maps to a single
    atlas level region (ops/morton.py).
    """
    from .morton import DELTA_OCTAVE
    s = jnp.log2(px_per_world / H_MAX)
    lev = jnp.ceil((buckets.astype(jnp.float32) + 1.0) * DELTA_OCTAVE + s)
    return jnp.clip(lev, 0, num_levels - 1).astype(jnp.int32)


@functools.lru_cache(maxsize=None)
def _norm_poly(mode: str, degree: int = 12) -> tuple[np.ndarray, float, float]:
    """Chebyshev fit of c(h) against normalized h, for gather-free,
    transcendental-free evaluation on device (a direct degree-12 fit is
    accurate to ~5e-4, tighter than the log-log+exp form it replaced and
    two 4M-wide transcendentals cheaper).  Returns (power-basis coeffs,
    centre, halfwidth)."""
    hs, cs = kernels.norm_table(mode)
    lo, hi = hs[0], hs[-1]
    centre, halfwidth = (hi + lo) / 2.0, (hi - lo) / 2.0
    t = (hs - centre) / halfwidth
    cheb = np.polynomial.chebyshev.Chebyshev.fit(t, cs, degree, domain=[-1, 1])
    coeffs = np.polynomial.chebyshev.cheb2poly(cheb.coef)[::-1]  # highest first
    fit = np.polyval(coeffs, t)
    err = np.abs(fit / cs - 1.0).max()
    assert err < 5e-3, f"norm poly fit error too large: {err}"
    return coeffs.astype(np.float64), float(centre), float(halfwidth)


def norm_factor(h_eff: jnp.ndarray, mode: str) -> jnp.ndarray:
    """Discrete mass-normalization c(h_eff), evaluated without gathers."""
    coeffs, centre, halfwidth = _norm_poly(mode)
    x = (jnp.clip(h_eff, 0.4, H_TRUNC) - centre) / halfwidth
    acc = jnp.full_like(x, float(coeffs[0]))
    for c in coeffs[1:]:
        acc = acc * x + float(c)
    return acc


def exp2_int(e: jnp.ndarray) -> jnp.ndarray:
    """Exact 2^e for small integer arrays via the f32 exponent field — no
    transcendental."""
    return jax.lax.bitcast_convert_type(
        ((e + 127) << 23).astype(jnp.int32), jnp.float32)


def ceil_log2_pos(x: jnp.ndarray) -> jnp.ndarray:
    """ceil(log2(x)) for positive normal f32, via exponent/mantissa bits."""
    bits = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.int32)
    e = ((bits >> 23) & 0xFF) - 127
    return e + ((bits & 0x7FFFFF) != 0).astype(jnp.int32)


def splat_coefficients(pos_smooth, values, matrix, resolution, scale,
                       pyramid: PyramidSpec, extra_mask=None, mode="exact",
                       depth_channel=False, level_override=None):
    """Shared front-end: projection, level assignment, deposit coefficients.

    Returns a dict of per-particle arrays: level, centre in level px
    (cx_l, cy_l), effective smoothing h_eff (level px), weighted channel
    coefficients coef (N, C) such that the deposit at a level pixel is
    coef * K(d / h_eff).  With ``depth_channel``, an extra channel
    values[:, 0] * clip_z is appended (the reference's vertex_depth path,
    reference: shaders/sph.wgsl:86-91).  ``level_override`` substitutes
    precomputed per-splat levels (see levels_from_buckets).
    """
    cx, cy, z01, h_px, visible = project(pos_smooth, matrix, resolution, scale)
    if depth_channel:
        values = jnp.concatenate([values, values[:, :1] * z01[:, None]], axis=1)
    lev, h_eff, tiny = assign_levels(h_px, pyramid.num_levels,
                                     lev=level_override)
    lev_scale = exp2_int(lev)
    inv_lev_scale = exp2_int(-lev)

    # centre coordinates in level pixels (pixel centres at integers)
    cx_l = (cx + 0.5) * inv_lev_scale - 0.5
    cy_l = (cy + 0.5) * inv_lev_scale - 0.5

    # world size of the *effective* smoothing length (handles the minimum
    # splat-size clamp while conserving mass exactly)
    px_per_world = resolution / (2.0 * scale)
    h_eff_world = h_eff * lev_scale / px_per_world

    # tiny (CIC) splats need no discrete normalization: the hat sums to 1
    c_norm = jnp.where(tiny, 1.0, norm_factor(h_eff, mode))
    w = c_norm / (h_eff_world * h_eff_world)
    w = jnp.where(visible, w, 0.0)
    if extra_mask is not None:
        w = jnp.where(extra_mask, w, 0.0)
    coef = values * w[:, None]

    # giant splats: support wider than the level deposit window — rendered
    # exactly by the dense full-support pass (ops/splat_giant.py) instead
    # of truncated.  Selection/exclusion capping is the caller's job.
    from .splat_giant import GIANT_H, giant_norm
    h_l = h_px * inv_lev_scale
    giant = (~tiny) & (h_l > GIANT_H) & (jnp.abs(w) > 0.0)
    coef_giant = values * jnp.where(giant, giant_norm(h_px, px_per_world),
                                    0.0)[:, None]
    return dict(level=lev, cx=cx_l, cy=cy_l, h_eff=h_eff, tiny=tiny,
                coef=coef, giant=giant, coef_giant=coef_giant,
                cx_fine=cx, cy_fine=cy, h_px=h_px)


# ---------------------------------------------------------------------------
# kernel evaluation on device
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _radial_table_f32(n: int = 2048) -> np.ndarray:
    _, k = kernels.radial_table(n)
    return k.astype(np.float32)


def kernel_radial_jnp(q: jnp.ndarray) -> jnp.ndarray:
    """Exact radial kernel via table interpolation (gathers; scatter path)."""
    table = jnp.asarray(_radial_table_f32())
    n = table.shape[0]
    x = jnp.clip(q, 0.0, kernels.KERNEL_SUPPORT) * ((n - 1) / kernels.KERNEL_SUPPORT)
    i0 = jnp.clip(x.astype(jnp.int32), 0, n - 2)
    frac = x - i0.astype(jnp.float32)
    v = table[i0] * (1.0 - frac) + table[i0 + 1] * frac
    return jnp.where(q < kernels.KERNEL_SUPPORT, v, 0.0)


def lowrank_profiles_jnp(t2: jnp.ndarray, lrk: kernels.LowRankKernel) -> jnp.ndarray:
    """Evaluate the low-rank kernel profiles at squared offsets t2 (units of
    h^2) by Horner polynomials — no gathers.  Returns (rank,) + t2.shape."""
    outs = []
    for k in range(lrk.rank):
        acc = jnp.full_like(t2, float(lrk.coeffs[k][0]))
        for c in lrk.coeffs[k][1:]:
            acc = acc * t2 + float(c)
        outs.append(jnp.where(t2 <= kernels.KERNEL_SUPPORT ** 2, acc, 0.0))
    return jnp.stack(outs)


def hat_profile(t2: jnp.ndarray) -> jnp.ndarray:
    """Cloud-in-cell triangle profile max(0, 1 - |t|) from squared offsets."""
    return jnp.maximum(0.0, 1.0 - jnp.sqrt(jnp.maximum(t2, 0.0)))


def profiles_select(t2: jnp.ndarray, tiny: jnp.ndarray,
                    lrk: kernels.LowRankKernel, signed: bool) -> jnp.ndarray:
    """Kernel profiles with the CIC hat substituted for tiny splats.

    ``tiny`` broadcasts against t2.  The hat is rank-1 (only profile 0,
    eigen-sign +1), so tiny rows simply zero the higher-rank profiles.
    """
    p = lowrank_profiles_jnp(t2, lrk)
    if signed:
        sign = jnp.asarray(lrk.signs)[(...,) + (None,) * t2.ndim]
        p = p * sign
    hat = hat_profile(t2)
    zero = jnp.zeros_like(t2)
    rows = [jnp.where(tiny, hat if k == 0 else zero, p[k])
            for k in range(lrk.rank)]
    return jnp.stack(rows)


# ---------------------------------------------------------------------------
# scatter backend (ground truth; CPU-friendly)
# ---------------------------------------------------------------------------

def splat_scatter(pos_smooth, values, matrix, resolution, scale,
                  extra_mask=None, pyramid: PyramidSpec | None = None,
                  depth_channel=False):
    """Windowed scatter-add splatter.  (N,4) x (N,C) -> (res, res, C)."""
    if pyramid is None:
        pyramid = default_pyramid(resolution)
    parts = splat_coefficients(pos_smooth, values, matrix, resolution, scale,
                               pyramid, extra_mask, mode="exact",
                               depth_channel=depth_channel)
    C = values.shape[1] + (1 if depth_channel else 0)
    lev, cx, cy, h_eff, coef = (parts["level"], parts["cx"], parts["cy"],
                                parts["h_eff"], parts["coef"])

    # giants: exclude from the windowed deposit, render exactly via the
    # dense full-support pass (ops/splat_giant.py)
    from . import splat_giant
    gidx, gvalid, excluded = splat_giant.select_giants_topk(
        parts["giant"], parts["h_px"], splat_giant.CAP)
    coef = jnp.where(excluded[:, None], 0.0, coef)
    giant_im = splat_giant.giant_image(
        parts["cy_fine"][gidx], parts["cx_fine"][gidx], parts["h_px"][gidx],
        parts["coef_giant"][gidx] * gvalid[:, None], resolution)

    pad = pyramid.pad
    res_l = jnp.asarray(pyramid.level_resolutions)[lev]
    sizes = jnp.asarray(pyramid.padded_sizes)[lev]
    flat_offs = jnp.asarray(pyramid.flat_offsets)[lev]

    sx = jnp.clip(jnp.floor(cx).astype(jnp.int32) - (WINDOW // 2 - 1) + pad,
                  0, sizes - WINDOW)
    sy = jnp.clip(jnp.floor(cy).astype(jnp.int32) - (WINDOW // 2 - 1) + pad,
                  0, sizes - WINDOW)
    # particles entirely outside the level image deposit only into padding
    # (cropped away), matching viewport clipping; mask the pathological ones
    inside = (cx > -pad - 8.0) & (cx < res_l.astype(jnp.float32) + pad + 8.0) & \
             (cy > -pad - 8.0) & (cy < res_l.astype(jnp.float32) + pad + 8.0)
    coef = coef * inside[:, None].astype(coef.dtype)

    d = jnp.arange(WINDOW, dtype=jnp.float32)
    dx = (sx - pad)[:, None] + d[None, :] - cx[:, None]   # (N, W)
    dy = (sy - pad)[:, None] + d[None, :] - cy[:, None]
    inv_h = 1.0 / h_eff
    q = jnp.sqrt((dy[:, :, None] ** 2 + dx[:, None, :] ** 2)) * inv_h[:, None, None]
    w_kernel = kernel_radial_jnp(q)                        # (N, W, W)
    tiny = parts["tiny"]
    hat2d = (hat_profile(dy ** 2)[:, :, None]
             * hat_profile(dx ** 2)[:, None, :])
    w = jnp.where(tiny[:, None, None], hat2d, w_kernel)

    rows = sy[:, None] + jnp.arange(WINDOW, dtype=jnp.int32)[None, :]
    cols = sx[:, None] + jnp.arange(WINDOW, dtype=jnp.int32)[None, :]
    flat_idx = (flat_offs[:, None, None]
                + rows[:, :, None] * sizes[:, None, None]
                + cols[:, None, :])                        # (N, W, W)

    updates = w[..., None] * coef[:, None, None, :]        # (N, W, W, C)
    buf = jnp.zeros((pyramid.flat_size, C), dtype=jnp.float32)
    buf = buf.at[flat_idx.reshape(-1)].add(updates.reshape(-1, C))
    return collapse_pyramid(buf, pyramid) + giant_im


def collapse_pyramid(flat_buffer: jnp.ndarray, pyramid: PyramidSpec) -> jnp.ndarray:
    """Crop each level out of the flat buffer, upsample and sum coarse->fine."""
    C = flat_buffer.shape[-1]
    pad = pyramid.pad
    levels = []
    for l in range(pyramid.num_levels):
        size = pyramid.padded_sizes[l]
        off = pyramid.flat_offsets[l]
        im = flat_buffer[off:off + size * size].reshape(size, size, C)
        levels.append(im[pad:size - pad, pad:size - pad])

    out = levels[-1]
    for l in range(pyramid.num_levels - 2, -1, -1):
        from .composite import upsample2x_kind
        target = pyramid.level_resolutions[l]
        up = upsample2x_kind(out, config.PYRAMID_COLLAPSE_FILTER)
        out = levels[l] + up[:target, :target]
    return out


# ---------------------------------------------------------------------------
# brute-force numpy ground truth (tests only; small N)
# ---------------------------------------------------------------------------

def splat_bruteforce(pos_smooth: np.ndarray, values: np.ndarray,
                     matrix: np.ndarray, resolution: int, scale: float) -> np.ndarray:
    """Continuous-ideal splatter: full-resolution, windowless, exact radial
    kernel, exact per-size normalization.  O(N * footprint); tests only."""
    pos_smooth = np.asarray(pos_smooth, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    xyz1 = np.concatenate([pos_smooth[:, :3], np.ones((len(pos_smooth), 1))], axis=1)
    clip = xyz1 @ np.asarray(matrix, dtype=np.float64).T
    cx = (clip[:, 0] + 1.0) * (resolution / 2.0) - 0.5
    cy = (1.0 - clip[:, 1]) * (resolution / 2.0) - 0.5
    z01 = clip[:, 2]
    h_px = pos_smooth[:, 3] * (resolution / (2.0 * scale))

    out = np.zeros((resolution, resolution, values.shape[1]))
    for i in range(len(pos_smooth)):
        if not (0.0 <= z01[i] <= 1.0) or h_px[i] <= 0:
            continue
        h = max(h_px[i], H_MIN)
        r = 2.0 * h
        x0 = max(int(np.floor(cx[i] - r)), 0)
        x1 = min(int(np.ceil(cx[i] + r)) + 1, resolution)
        y0 = max(int(np.floor(cy[i] - r)), 0)
        y1 = min(int(np.ceil(cy[i] + r)) + 1, resolution)
        if x0 >= x1 or y0 >= y1:
            continue
        xs = np.arange(x0, x1) - cx[i]
        ys = np.arange(y0, y1) - cy[i]
        q = np.sqrt(ys[:, None] ** 2 + xs[None, :] ** 2) / h
        kv = kernels.kernel_value(q)
        # exact discrete normalization for this footprint
        full_xs = np.arange(int(np.floor(cx[i] - r)), int(np.ceil(cx[i] + r)) + 1) - cx[i]
        full_ys = np.arange(int(np.floor(cy[i] - r)), int(np.ceil(cy[i] + r)) + 1) - cy[i]
        qf = np.sqrt(full_ys[:, None] ** 2 + full_xs[None, :] ** 2) / h
        denom = kernels.kernel_value(qf).sum()
        if denom <= 0:
            continue
        h_world = h / (resolution / (2.0 * scale))
        w = kv * (h * h / denom) / h_world**2
        out[y0:y1, x0:x1] += w[:, :, None] * values[i][None, None, :]
    return out
