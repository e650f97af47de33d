"""Image-space compositing helpers: fractional shifts and lattice sums.

Used by periodic tiling (reference: src/topsy/periodic_sph.py): the rendered
panel is replicated on a rotated lattice of offsets with per-instance
weights; a fractional pixel shift with bilinear filtering matches the
reference's linear-sampled instanced quads.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# The pyramid-collapse upsamples are float32 matmuls against small
# interpolation matrices; on a GPU a product without a precision may run in
# TF32, which would round every collapsed level to ~3 decimal digits.
UPSAMPLE_PRECISION = jax.lax.Precision.HIGHEST


def _catmull_weight(t: float) -> float:
    t = abs(t)
    if t < 1.0:
        return 1.5 * t**3 - 2.5 * t**2 + 1.0
    if t < 2.0:
        return -0.5 * t**3 + 2.5 * t**2 - 4.0 * t + 2.0
    return 0.0


def _bspline3(t: np.ndarray) -> np.ndarray:
    """Cubic B-spline basis (support |t| < 2, partition of unity)."""
    t = np.abs(t)
    return np.where(
        t < 1.0, 2.0 / 3.0 - t**2 + 0.5 * t**3,
        np.where(t < 2.0, (2.0 - t) ** 3 / 6.0, 0.0))


@functools.lru_cache(maxsize=32)
def _upsample2x_matrix(n: int, kind: str = "linear"):
    """(n, 2n) interpolation matrix: y = x @ M upsamples the last axis with
    half-pixel-centre sampling and edge clamp.  ``kind``:

    * 'linear': out[2k] = 0.75 in[k] + 0.25 in[k-1], out[2k+1] = 0.75 in[k]
      + 0.25 in[k+1];
    * 'catmull': 4-tap Catmull-Rom — third-order accurate, which the density
      pyramid collapse needs (bilinear's diffusion of coarse-level splats is
      a measured ~5% ring error against the reference's full-resolution
      rasterization; Catmull-Rom brings it under 0.5%);
    * 'spline': interpolating cubic spline — the cubic B-spline prefilter
      (collocation-matrix inverse) folded into the same (n, 2n) matmul, so
      it costs exactly what Catmull-Rom does at run time.  Exact at the
      coarse sample points and fourth-order between them (vs Catmull-Rom's
      third), which halves the pyramid-collapse reconstruction bias against
      the exact evaluator (benchmarks/pyramid_bias.py).

    All kinds preserve constants (rows of M sum to 2 in the interior), so
    the collapse conserves deposited mass up to edge clamping."""
    import numpy as np
    m = np.zeros((n, 2 * n), dtype=np.float32)
    if kind == "linear":
        k = np.arange(n)
        m[k, 2 * k] += 0.75
        m[np.maximum(k - 1, 0), 2 * k] += 0.25
        m[k, 2 * k + 1] += 0.75
        m[np.minimum(k + 1, n - 1), 2 * k + 1] += 0.25
    elif kind == "spline":
        if n < 2:
            m[:, :] = 1.0
            return m
        # collocation: f[r] = sum_k c[k] B3(r - k), basis clamped at edges
        # (out-of-range k lumped onto the edge sample, like the other kinds)
        r = np.arange(n)
        a = np.zeros((n, n))
        for k in range(-1, n + 1):
            a[:, min(max(k, 0), n - 1)] += _bspline3(r - k)
        # evaluation of the spline at fine half-pixel centres j/2 - 0.25
        xc = np.arange(2 * n) / 2.0 - 0.25
        e = np.zeros((n, 2 * n))
        for k in range(-1, n + 1):
            e[min(max(k, 0), n - 1), :] += _bspline3(xc - k)
        m[:, :] = np.linalg.solve(a.T, e)
    else:
        for j in range(2 * n):
            xc = j / 2.0 - 0.25  # coarse-grid coordinate of fine centre j
            k0 = int(np.floor(xc))
            for k in range(k0 - 1, k0 + 3):
                m[min(max(k, 0), n - 1), j] += _catmull_weight(xc - k)
    return m  # numpy: a jnp constant cached here would leak tracers under jit


def upsample2x_kind(x: jnp.ndarray, kind: str) -> jnp.ndarray:
    """2x upsample over the two leading axes of (H, W, C) with the given
    reconstruction filter (see _upsample2x_matrix).

    The density-pyramid reconstruction: above-first-order filters keep
    coarse-level splat deposits close to their kernel shape.  Small negative
    overshoots near sharp edges are possible (as with any interpolation
    above first order); the density channels tolerate them exactly as they
    tolerate zeros."""
    H, W = x.shape[0], x.shape[1]
    t = jnp.einsum("hw...,hH->Hw...", x, _upsample2x_matrix(H, kind),
                   preferred_element_type=jnp.float32,
                   precision=UPSAMPLE_PRECISION)
    return jnp.einsum("Hw...,wW->HW...", t, _upsample2x_matrix(W, kind),
                      preferred_element_type=jnp.float32,
                   precision=UPSAMPLE_PRECISION)


def upsample2x_kind_cm(x: jnp.ndarray, kind: str) -> jnp.ndarray:
    """2x upsample over the two trailing axes of (C, H, W)."""
    C, H, W = x.shape
    t = jnp.einsum("chw,hH->cHw", x, _upsample2x_matrix(H, kind),
                   preferred_element_type=jnp.float32,
                   precision=UPSAMPLE_PRECISION)
    return jnp.einsum("cHw,wW->cHW", t, _upsample2x_matrix(W, kind),
                      preferred_element_type=jnp.float32,
                   precision=UPSAMPLE_PRECISION)


def upsample2x_zmax_cm(dv: jnp.ndarray) -> jnp.ndarray:
    """Coverage-normalized 2x bilinear upsample of a (2=[depth, payload], H,
    W) z-buffer level (trailing axes; depth > 0 means covered).

    Raw bilinear interpolation of a z-level mixes covered depths with the
    empty background (depth 0), which both drags silhouette depths toward
    zero and leaks faint nonzero depth up to a coarse pixel beyond the true
    footprint.  Instead interpolate (depth·cov, payload·cov, cov) and
    normalize by the interpolated coverage; a fine pixel is covered iff the
    coverage weight exceeds 0.5 (majority vote — the silhouette lands
    within half a coarse pixel of the true edge instead of bleeding
    outward).

    The payload is NOT interpolated: blending the quantities of adjacent
    winning fragments would display a value no particle has (the reference
    shows the winner's quantity verbatim, and quantities can oscillate on
    sub-footprint scales).  Each fine pixel takes its nearest coarse
    pixel's payload, falling back to the coverage-weighted average only
    when the nearest coarse pixel is empty (diagonal silhouette corners)."""
    depth, val = dv[0], dv[1]
    cov = (depth > 0.0).astype(depth.dtype)
    packed = jnp.stack([depth * cov, val * cov, cov], axis=0)
    up = upsample2x_kind_cm(packed, "linear")
    covf = up[2]
    valid = covf > 0.5
    inv = 1.0 / jnp.maximum(covf, 1e-20)
    near_v = jnp.repeat(jnp.repeat(val, 2, axis=0), 2, axis=1)
    near_cov = jnp.repeat(jnp.repeat(cov, 2, axis=0), 2, axis=1) > 0.0
    payload = jnp.where(near_cov, near_v, up[1] * inv)
    return jnp.stack([jnp.where(valid, up[0] * inv, 0.0),
                      jnp.where(valid, payload, 0.0)], axis=0)


def _integer_shift(im: jnp.ndarray, iy: jnp.ndarray, ix: jnp.ndarray) -> jnp.ndarray:
    """Shift by whole pixels, zero-filling the vacated region."""
    H, W = im.shape[0], im.shape[1]
    rolled = jnp.roll(jnp.roll(im, iy, axis=0), ix, axis=1)
    rows = jnp.arange(H)[:, None]
    cols = jnp.arange(W)[None, :]
    valid_r = jnp.where(iy >= 0, rows >= iy, rows < H + iy)
    valid_c = jnp.where(ix >= 0, cols >= ix, cols < W + ix)
    return rolled * (valid_r & valid_c)[..., None]


def shift_bilinear(im: jnp.ndarray, dy: jnp.ndarray, dx: jnp.ndarray) -> jnp.ndarray:
    """Shift (H, W, C) by fractional (dy, dx) pixels with bilinear filtering."""
    iy = jnp.floor(dy).astype(jnp.int32)
    ix = jnp.floor(dx).astype(jnp.int32)
    fy = dy - iy
    fx = dx - ix
    s00 = _integer_shift(im, iy, ix)
    s01 = _integer_shift(im, iy, ix + 1)
    s10 = _integer_shift(im, iy + 1, ix)
    s11 = _integer_shift(im, iy + 1, ix + 1)
    return (s00 * (1 - fy) * (1 - fx) + s01 * (1 - fy) * fx
            + s10 * fy * (1 - fx) + s11 * fy * fx)


@functools.partial(jax.jit, static_argnames=())
def lattice_composite(image: jnp.ndarray, offsets_px: jnp.ndarray,
                      weights: jnp.ndarray) -> jnp.ndarray:
    """Sum weighted bilinear-shifted copies of ``image``.

    offsets_px: (K, 2) as (dy, dx) pixel shifts; weights: (K,), zero-weight
    instances are skipped numerically (they still cost a shift).
    """
    def body(acc, inp):
        off, w = inp
        shifted = shift_bilinear(image, off[0], off[1])
        return acc + shifted * w, None

    out, _ = jax.lax.scan(body, jnp.zeros_like(image), (offsets_px, weights))
    return out
