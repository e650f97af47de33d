"""Occlusion (z-buffered) splatting for surface rendering.

Emulates the reference's DepthSPHWithOcclusion pipeline (reference:
src/topsy/sph.py:459-656, shaders/sph.wgsl:94-158): particles above a density
cut rasterize hemispheres; a greater-compare depth test keeps the front-most
fragment, outputting (quantity value, surface depth) per pixel, where the
surface depth is clip_z + hemisphere_kernel * h_clipspace / 2.

An array program has no z-buffer; the winner is found with a two-pass
windowed scatter-max (max depth, then select the matching fragment's
payload).  This path is exact and is the reference for the windowed
front-most engine (ops/zsplat_atlas.py).

Pyramid levels are combined by *max-compositing* (bilinear-upsampled coarse
depth loses against finer fragments only where the finer content is in
front), the occlusion analogue of the additive pyramid collapse.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import kernels
from .splat import (H_MIN, H_TRUNC, WINDOW, PyramidSpec, assign_levels,
                    default_pyramid, project)

HEMI_SUPPORT = 2.0


def hemisphere_kernel(q: jnp.ndarray) -> jnp.ndarray:
    """sqrt(4 - q^2) inside the support, negative outside (discarded) —
    the reference's LocalSphereKernel (reference: sph.py:448-457)."""
    return jnp.where(q < HEMI_SUPPORT,
                     jnp.sqrt(jnp.maximum(4.0 - q * q, 0.0)), -0.01)


def zsplat_scatter(pos_smooth, values, matrix, resolution, scale,
                   density_cut=0.0, extra_mask=None,
                   pyramid: PyramidSpec | None = None, level_override=None):
    """(N,4) x (N,1 quantity) -> (res, res, 2) [value, depth]; depth 0 = empty.

    ``values[:, 0]`` must be the particle mass (for the density cut) and
    ``values[:, 1]`` the displayed quantity value, matching the reference's
    mass_and_quantity buffer driving vertex_depth_with_cut.
    ``level_override`` substitutes per-splat pyramid levels (used by tests
    to compare bit-for-bit against the bucket-derived atlas path).
    """
    if pyramid is None:
        pyramid = default_pyramid(resolution)
    cx, cy, z01, h_px, visible = project(pos_smooth, matrix, resolution, scale)
    lev, h_eff, _tiny = assign_levels(h_px, pyramid.num_levels,
                                      lev=level_override)
    lev_scale = jnp.exp2(lev.astype(jnp.float32))
    cx_l = (cx + 0.5) / lev_scale - 0.5
    cy_l = (cy + 0.5) / lev_scale - 0.5

    mass = values[:, 0]
    qty = values[:, 1]
    h_world = pos_smooth[:, 3]
    rho = mass / jnp.maximum(h_world, 1e-30) ** 3
    ok = visible & (rho > density_cut)
    if extra_mask is not None:
        ok = ok & extra_mask

    # hemisphere depth scale: h in clip-z units (z is squashed by 0.5)
    # (reference: shaders/sph.wgsl:107-113)
    h_clip_half = h_world / scale * 0.5

    pad = pyramid.pad
    res_l = jnp.asarray(pyramid.level_resolutions)[lev]
    sizes = jnp.asarray(pyramid.padded_sizes)[lev]
    flat_offs = jnp.asarray(pyramid.flat_offsets)[lev]

    sx = jnp.clip(jnp.floor(cx_l).astype(jnp.int32) - (WINDOW // 2 - 1) + pad,
                  0, sizes - WINDOW)
    sy = jnp.clip(jnp.floor(cy_l).astype(jnp.int32) - (WINDOW // 2 - 1) + pad,
                  0, sizes - WINDOW)
    inside = (cx_l > -pad - 8.0) & (cx_l < res_l.astype(jnp.float32) + pad + 8.0) & \
             (cy_l > -pad - 8.0) & (cy_l < res_l.astype(jnp.float32) + pad + 8.0)
    ok = ok & inside

    d = jnp.arange(WINDOW, dtype=jnp.float32)
    dxs = (sx - pad)[:, None] + d[None, :] - cx_l[:, None]
    dys = (sy - pad)[:, None] + d[None, :] - cy_l[:, None]
    inv_h = 1.0 / jnp.clip(h_eff, H_MIN, H_TRUNC)
    q = jnp.sqrt(dys[:, :, None] ** 2 + dxs[:, None, :] ** 2) * inv_h[:, None, None]
    k = hemisphere_kernel(q)
    frag_ok = (k >= 0.0) & ok[:, None, None]
    depth = z01[:, None, None] + k * h_clip_half[:, None, None]
    depth = jnp.where(frag_ok, depth, -jnp.inf)

    rows = sy[:, None] + jnp.arange(WINDOW, dtype=jnp.int32)[None, :]
    cols = sx[:, None] + jnp.arange(WINDOW, dtype=jnp.int32)[None, :]
    flat_idx = (flat_offs[:, None, None]
                + rows[:, :, None] * sizes[:, None, None]
                + cols[:, None, :]).reshape(-1)

    dflat = depth.reshape(-1)
    dbuf = jnp.zeros((pyramid.flat_size,), dtype=jnp.float32)
    dbuf = dbuf.at[flat_idx].max(dflat)

    # second pass: select the winning fragment's quantity value
    win = (dflat == dbuf[flat_idx]) & jnp.isfinite(dflat)
    vfrag = jnp.broadcast_to(qty[:, None, None], depth.shape).reshape(-1)
    vbuf = jnp.full((pyramid.flat_size,), -jnp.inf, dtype=jnp.float32)
    vbuf = vbuf.at[flat_idx].max(jnp.where(win, vfrag, -jnp.inf))
    vbuf = jnp.where(jnp.isfinite(vbuf), vbuf, 0.0)
    dbuf = jnp.maximum(dbuf, 0.0)  # background depth 0, as the cleared z-buffer

    return _collapse_max(dbuf, vbuf, pyramid)


def _collapse_max(dbuf, vbuf, pyramid: PyramidSpec):
    pad = pyramid.pad
    levels = []
    for l in range(pyramid.num_levels):
        size = pyramid.padded_sizes[l]
        off = pyramid.flat_offsets[l]
        dim = dbuf[off:off + size * size].reshape(size, size)
        vim = vbuf[off:off + size * size].reshape(size, size)
        levels.append((dim[pad:size - pad, pad:size - pad],
                       vim[pad:size - pad, pad:size - pad]))

    dout, vout = levels[-1]
    for l in range(pyramid.num_levels - 2, -1, -1):
        # coverage-normalized upsample: raw bilinear would bleed silhouettes
        # into the background (see zsplat_atlas.collapse_max_atlas)
        from .composite import upsample2x_zmax_cm
        target = pyramid.level_resolutions[l]
        dv = upsample2x_zmax_cm(jnp.stack([dout, vout], axis=0))
        dup = dv[0, :target, :target]
        vup = dv[1, :target, :target]
        dfine, vfine = levels[l]
        front = dfine >= dup
        dout = jnp.where(front, dfine, dup)
        vout = jnp.where(front, vfine, vup)
    return jnp.stack([vout, dout], axis=-1)


def density_cut_percentiles(mass: np.ndarray, smooth: np.ndarray,
                            num_samples: int = 101) -> np.ndarray:
    """Density-percentile table for the surface density-cut slider
    (reference: sph.py:465-487)."""
    rho = np.asarray(mass, dtype=np.float64) / np.asarray(smooth, np.float64) ** 3
    return np.quantile(rho, np.linspace(0, 1, num_samples))
