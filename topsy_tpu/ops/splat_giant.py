"""Exact full-support rendering of giant splats.

The windowed splat paths truncate a splat's footprint at the coarsest
pyramid level: the deposit evaluates the kernel only over a +-FOOT
level-pixel window and the discrete normalization table compensates, so
mass is conserved but the *shape* is wrong — wing mass is redistributed
inward.  The reference has no such truncation: every particle is an
instanced quad spanning its full +-2h support at full resolution
(reference: src/topsy/sph.py:221-259, shaders/sph.wgsl:54-66 — quad side
``2h * scale_factor`` with no upper clamp, ``max_pixels = inf`` at
sph.py:85).  Against the reference's committed pixel arrays the
truncation shows up as a ~20% mean / ~45% std disagreement dominated by
image corners (wings missing) and splat interiors (mass squeezed in).

This module restores exactness without scatters: splats whose support exceeds
the footprint window at their level (``h_l > GIANT_H``) are *excluded*
from the windowed deposit and instead accumulated densely over the full
fine-resolution framebuffer via the separable low-rank kernel:

    out[y, x, c] = sum_k s_k sum_i P_k[i, y] * coef[i, c] * Q_k[i, x]

i.e. ``rank * C`` matmuls of shape (res, cap) @ (cap, res) — pure matrix
work, no scatters, no dynamic shapes.  Full support is evaluated
implicitly: the profile polynomials are constrained to vanish at the
support edge, so off-support pixels contribute exactly zero and giants
whose centres are off-screen still deposit their on-screen wings (the
same viewport-clipping semantics as the reference's rasterizer).

Giants are normalized by the continuous kernel integral
(kernels.lowrank_integral): exact to <1e-4 for the h >= 8 px splats this
pass receives.

Static-shape capping: the number of giants is data- and zoom-dependent,
so callers compact to a compile-time cap.  Presorted layouts keep the
*real* particles' buckets ascending along the slot axis, so the CAP
largest-smoothing real particles are exactly the last CAP real slots —
a static set per layout (candidate_slots), gathered once at build time;
per frame the renderer picks a power-of-two prefix size from the current
zoom on the host (giant_plan) and renders one dense pass while the
windowed engines exclude by a plain slot-index threshold.  The legacy
sorted path pays a per-call top_k.  Beyond-cap giants (the *smallest*,
hence least-truncated, ones) stay on the windowed path — mass-conserving
graceful degradation, logged by the render loop.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import config
from . import kernels

# A splat is "giant" when its supported footprint KERNEL_SUPPORT * h_l
# exceeds the level deposit window's half-width FOOT (= splat_atlas.FOOT;
# asserted equal there).  Level assignment keeps h_l <= H_MAX except at
# the coarsest level, so giants are exactly the coarsest-level splats the
# windowed paths would truncate.
FOOT = 8.0
GIANT_H = FOOT / kernels.KERNEL_SUPPORT  # 4.0 level px

CAP = int(getattr(config, "SPLAT_GIANT_CAP", 8192))

# The giant pass can afford a much higher-rank separable fit than the
# windowed kernels (its cost is rank * C matmuls total, not per-window):
# rank 6 / degree 12 reproduces the projected kernel to 0.1% mean relative
# error over the support (rank 2: 2.9%), which matters because a giant's
# wings can singly dominate corner pixels of the image.
GIANT_RANK = 6
GIANT_DEGREE = 12

# The NBIG largest giants get an *exact* radial subpass: any separable
# product fit has unbounded relative error in the deep wings (q > 1.9),
# and the deep wings of precisely the biggest splats are what reaches the
# image corners.  The edge-factored radial polynomial
# (kernels.radial_edge_poly) is exact to 4e-4 everywhere; evaluating it
# densely costs NBIG * res^2 elementwise FLOPs — trivial at 64.
NBIG = 64


@functools.lru_cache(maxsize=None)
def _inv_integral() -> float:
    return 1.0 / kernels.lowrank_integral(GIANT_RANK, GIANT_DEGREE)


def giant_norm(h_px, px_per_world):
    """Deposit weight for a giant: ``c_inf / h_world^2`` (the analogue of
    splat_coefficients' ``c_norm / h_eff_world^2`` with the continuous
    normalization and the *unclamped* smoothing)."""
    inv_h_world = px_per_world / jnp.maximum(h_px, 1e-30)
    return _inv_integral() * inv_h_world * inv_h_world


def giant_image(cy, cx, h_px, coef, resolution: int):
    """Dense full-support accumulation of (capped) giant splats.

    cy, cx: (cap,) splat centres in fine pixels (pixel centres at
    integers; may be off-screen).  h_px: (cap,) smoothing in fine pixels.
    coef: (cap, C) deposit coefficients (values * giant_norm; zero rows
    are inactive slots).  Returns (res, res, C) f32.

    The matmuls run at float32 precision (HIGHEST): corner pixels are
    often dominated by one or two giants, so bf16 operand rounding would
    show up directly in the reference-parity distribution checks.
    """
    lrk = kernels.lowrank_kernel(GIANT_RANK, GIANT_DEGREE)
    cap = cy.shape[0]
    C = coef.shape[1]

    # route the biggest NBIG giants to the exact radial subpass (top_k over
    # the cap is cheap); the rest stay on the separable matmuls
    nbig = min(NBIG, cap)
    _, big_idx = jax.lax.top_k(jnp.where(jnp.isfinite(h_px), h_px, -1.0),
                               nbig)
    is_big = jnp.zeros((cap,), jnp.bool_).at[big_idx].set(True)
    exact = _exact_subpass(cy[big_idx], cx[big_idx], h_px[big_idx],
                           coef[big_idx], resolution)
    coef = jnp.where(is_big[:, None], 0.0, coef)

    inv_h = 1.0 / jnp.maximum(h_px, 1e-30)
    grid = jnp.arange(resolution, dtype=jnp.float32)

    def profiles(centre):
        t = (grid[None, :] - centre[:, None]) * inv_h[:, None]
        t2 = t * t
        # clamp instead of mask: profiles vanish exactly at the support
        # edge by construction (kernels.lowrank_kernel); non-finite
        # centres (padding slots) clamp to the edge -> exact zero
        t2 = jnp.clip(jnp.where(jnp.isfinite(t2), t2, kernels.KERNEL_SUPPORT**2),
                      0.0, kernels.KERNEL_SUPPORT**2)
        out = []
        for k in range(lrk.rank):
            acc = jnp.full_like(t2, float(lrk.coeffs[k][0]))
            for c in lrk.coeffs[k][1:]:
                acc = acc * t2 + float(c)
            out.append(acc)
        return out  # list of (cap, res)

    P = profiles(cy)
    Q = profiles(cx)
    out = exact
    for k in range(lrk.rank):
        sk = float(lrk.signs[k])
        for c in range(C):
            contrib = jax.lax.dot_general(
                P[k], Q[k] * (coef[:, c] * sk)[:, None],
                (((0,), (0,)), ((), ())),
                precision=jax.lax.Precision.HIGHEST)
            out = out.at[:, :, c].add(contrib)
    return out


def _exact_subpass(cy, cx, h_px, coef, resolution: int):
    """Exact radial accumulation of the few biggest giants.

    Evaluates ``k2(q) = g(q^2/2 - 1) * (4 - q^2)^3.5``
    (kernels.radial_edge_poly — exact to 4e-4 relative everywhere,
    including the deep wings no separable fit can represent) densely per
    pixel, scanning one giant at a time.  The continuous radial profile
    integrates to exactly 1, so the coefficient re-scales from the
    separable normalization by ``lowrank_integral``.
    """
    C = coef.shape[1]
    gcoeffs = kernels.radial_edge_poly()
    rescale = kernels.lowrank_integral(GIANT_RANK, GIANT_DEGREE)
    grid = jnp.arange(resolution, dtype=jnp.float32)

    def body(acc, args):
        cyi, cxi, hi, ci = args
        inv = 1.0 / jnp.maximum(hi, 1e-30)
        ty2 = ((grid - cyi) * inv) ** 2
        tx2 = ((grid - cxi) * inv) ** 2
        q2 = ty2[:, None] + tx2[None, :]
        q2 = jnp.clip(jnp.where(jnp.isfinite(q2), q2,
                                kernels.KERNEL_SUPPORT**2),
                      0.0, kernels.KERNEL_SUPPORT**2)
        u = q2 * 0.5 - 1.0
        g = jnp.full_like(u, float(gcoeffs[0]))
        for c in gcoeffs[1:]:
            g = g * u + float(c)
        t = kernels.KERNEL_SUPPORT**2 - q2
        k2 = g * (t * t * t) * jnp.sqrt(t)
        return acc + k2[:, :, None] * (ci * rescale)[None, None, :], None

    acc0 = jnp.zeros((resolution, resolution, C), dtype=jnp.float32)
    out, _ = jax.lax.scan(body, acc0, (cy, cx, h_px, coef))
    return out


def zsplat_giant_image(cy, cx, h_px, z01, h_clip_half, qty, active,
                       resolution: int, chunk: int = 16):
    """Dense full-support *z-buffered* giant pass for surface mode.

    The windowed hemisphere splatter (ops/zsplat_atlas.py) computes the
    fragment profile on the H_TRUNC-clamped effective smoothing, so a
    giant's hemisphere is squeezed as well as truncated; the reference
    rasterizes the true profile over the full quad (reference:
    shaders/sph.wgsl:96-124).  This pass evaluates ``depth = z01 +
    h_clip_half * sqrt(4 - q^2)`` with q on the TRUE pixel smoothing over
    the whole framebuffer and keeps the front-most fragment — max-combine,
    the same blending as the windowed path, so the caller simply
    max-composites the returned (res, res, 2) [value, depth] layer.

    Work is chunked ``chunk`` giants at a time ((chunk, res, res)
    intermediates) and scanned — elementwise work, used once per view.
    """
    from .zsplat import HEMI_SUPPORT
    cap = cy.shape[0]
    pad = (-cap) % chunk
    if pad:
        def p(a):
            return jnp.concatenate([a, jnp.zeros((pad,), a.dtype)])
        cy, cx, h_px, z01 = p(cy), p(cx), p(h_px), p(z01)
        h_clip_half, qty = p(h_clip_half), p(qty)
        active = jnp.concatenate([active, jnp.zeros((pad,), jnp.bool_)])
    grid = jnp.arange(resolution, dtype=jnp.float32)

    def body(carry, args):
        vbuf, dbuf = carry
        cyi, cxi, hi, zi, hci, qi, ai = args
        inv = 1.0 / jnp.maximum(hi, 1e-30)
        dy2 = ((grid[None, :] - cyi[:, None]) * inv[:, None]) ** 2
        dx2 = ((grid[None, :] - cxi[:, None]) * inv[:, None]) ** 2
        q2 = dy2[:, :, None] + dx2[:, None, :]
        q2 = jnp.where(jnp.isfinite(q2), q2, HEMI_SUPPORT * HEMI_SUPPORT)
        k = jnp.sqrt(jnp.maximum(HEMI_SUPPORT * HEMI_SUPPORT - q2, 0.0))
        inside = (q2 < HEMI_SUPPORT * HEMI_SUPPORT) & ai[:, None, None]
        depth = jnp.where(inside, zi[:, None, None] + k * hci[:, None, None],
                          -jnp.inf)
        di = jnp.max(depth, axis=0)
        win = jnp.argmax(depth, axis=0)
        vi = qi[win]
        take = di > dbuf
        return (jnp.where(take, vi, vbuf), jnp.where(take, di, dbuf)), None

    vbuf = jnp.zeros((resolution, resolution), jnp.float32)
    dbuf = jnp.full((resolution, resolution), -jnp.inf, jnp.float32)
    # (steps, chunk): plain row-major chunking
    args = tuple(a.reshape(-1, chunk) for a in (cy, cx, h_px, z01,
                                                h_clip_half, qty))
    act = active.reshape(-1, chunk)
    (vbuf, dbuf), _ = jax.lax.scan(body, (vbuf, dbuf), args + (act,))
    dbuf = jnp.maximum(dbuf, 0.0)
    vbuf = jnp.where(dbuf > 0.0, vbuf, 0.0)
    return jnp.stack([vbuf, dbuf], axis=-1)


def select_giants_topk(giant_mask, h_px, cap: int):
    """Compact giants to a static cap for layouts with no contiguity.

    Returns (idx (cap,), valid (cap,), excluded (n,) bool): ``idx`` rows
    gather the selected giants (largest h first), ``excluded`` marks
    exactly the selected particles for removal from the windowed path —
    beyond-cap giants stay excluded=False and render truncated.

    Above 2^18 particles an exact top_k would dominate the launch
    (effectively a device sort); ``approx_max_k`` (recall ~0.95) is safe here because consistency is by construction — whatever
    set it returns is both densely rendered and excluded — and a missed
    giant merely stays on the mass-conserving truncated path.
    """
    n = h_px.shape[0]
    cap = min(cap, n)
    score = jnp.where(giant_mask, h_px, -1.0)
    if n <= (1 << 18):
        top, idx = jax.lax.top_k(score, cap)
    else:
        top, idx = jax.lax.approx_max_k(score, cap)
    valid = top > 0.0
    idx = idx.astype(jnp.int32)
    excluded = jnp.zeros((n,), jnp.bool_).at[idx].set(valid)
    return idx, valid, excluded


# ---------------------------------------------------------------------------
# static per-layout candidate selection (presorted product paths)
# ---------------------------------------------------------------------------

#: bucket threshold meaning "exclude nothing" — far above any physical
#: 1/8-octave bucket of an f32 smoothing length (|bucket| <= ~1000)
BUCKET_DISABLED = 1 << 20


def candidate_slots(layout, cap: int = CAP):
    """Static giant-candidate metadata for a presorted layout.

    The candidate pool is the last ``min(cap, n_real)`` *real* slots: real
    particles' buckets ascend along the slot axis and pads sit at group
    tails (ops/morton.py), so these are exactly the cap largest-smoothing
    particles — the giant pool for every zoom.  Computed once per layout,
    host-side result.

    Returns (slots ascending (m,) int32, slot buckets (m,) int32,
    hist_buckets (B,) int32 ascending, hist_counts (B,) int64) where the
    histogram counts *all* real particles per bucket — giant_plan uses it
    to detect pool overflow (more capable particles than the pool holds).
    Works for both the host PresortedLayout (numpy dst) and the
    DevicePresortedLayout (gidx + sentinel); the device variant runs one
    tiny jit and reads back m ints plus the histogram.
    """
    import numpy as np
    m = int(min(cap, layout.n_real))
    z = np.zeros(0, np.int32)
    if m == 0:
        return z, z, z, np.zeros(0, np.int64)
    dst = getattr(layout, "dst", None)
    if dst is not None:  # host layout: dst lists the real slots directly
        real_slots = np.sort(np.asarray(dst))
        slots = real_slots[-m:].astype(np.int32)
        all_buckets = np.asarray(layout.buckets)[real_slots]
        buckets = all_buckets[-m:]
        hist_buckets, hist_counts = np.unique(all_buckets,
                                              return_counts=True)
    else:  # device layout: real slots are gidx < n_real
        gidx = layout.gidx
        bmin = int(jnp.min(layout.buckets))
        bmax = int(jnp.max(layout.buckets))

        @jax.jit
        def pick(gidx, buckets_slot):
            real = gidx < layout.n_real
            # count of real slots at-or-after each slot
            cum = jnp.cumsum(real[::-1].astype(jnp.int32))[::-1]
            sel = real & (cum <= m)
            slots = jnp.nonzero(sel, size=m, fill_value=0)[0].astype(jnp.int32)
            hist = jnp.zeros((bmax - bmin + 1,), jnp.int32).at[
                buckets_slot - bmin].add(real.astype(jnp.int32))
            return slots, jnp.take(buckets_slot, slots), hist

        slots_d, buckets_d, hist_d = pick(gidx, layout.buckets)
        slots, buckets = np.asarray(slots_d), np.asarray(buckets_d)
        hist = np.asarray(hist_d).astype(np.int64)
        nz = hist > 0
        hist_buckets = (np.arange(bmin, bmax + 1, dtype=np.int32))[nz]
        hist_counts = hist[nz]
    return (slots, buckets.astype(np.int32),
            hist_buckets.astype(np.int32), hist_counts.astype(np.int64))


def capable_buckets(buckets: np.ndarray, resolution: int, scale: float,
                    num_levels: int) -> np.ndarray:
    """Which buckets could contain giants at this zoom — host math only.

    Mirrors the device-side criterion exactly *at the bucket upper edge*
    (levels_from_buckets + ``h_l > GIANT_H``): a particle with ``h_l >
    GIANT_H`` always lies in a capable bucket, so a bucket threshold at
    the lowest capable bucket captures every giant."""
    import numpy as np
    from .morton import DELTA_OCTAVE
    from .splat import H_MAX
    ppw = resolution / (2.0 * float(scale))
    b = buckets.astype(np.float64)
    h_up_px = np.exp2((b + 1.0) * DELTA_OCTAVE) * ppw
    lev = np.clip(np.ceil((b + 1.0) * DELTA_OCTAVE + np.log2(ppw / H_MAX)),
                  0, num_levels - 1)
    return h_up_px * np.exp2(-lev) > GIANT_H


def plan_sizes(m: int) -> list[int]:
    """The compiled dense-pass sizes for a candidate pool of m slots:
    powers of two from 256 up to m (plus m itself) — a handful of jit
    variants instead of one always-CAP-sized pass."""
    sizes, s = [], 256
    while s < m:
        sizes.append(s)
        s *= 2
    sizes.append(m)
    return sizes


def giant_plan(meta, resolution: int, scale: float,
               num_levels: int) -> tuple[int, int]:
    """Per-frame host decision: (size, bucket_threshold).

    Render the dense pass over the last ``size`` pool candidates and have
    every windowed engine exclude ``giant & (bucket >= bucket_threshold)``
    — a criterion that survives column slicing, decimation-mip tiers and
    mesh slabs unchanged, because buckets travel with the data.  size == 0
    (threshold BUCKET_DISABLED) means skip the pass and exclude nothing:
    either no giants are possible at this zoom, or more capable particles
    exist than the pool holds (pathological zoom-in) — then *every* giant
    stays on the mass-conserving truncated path rather than some silently
    losing mass."""
    slots, cand_buckets, hist_buckets, hist_counts = meta
    m = len(cand_buckets)
    if m == 0:
        return 0, BUCKET_DISABLED
    cap_mask = capable_buckets(hist_buckets, resolution, scale, num_levels)
    if not cap_mask.any():
        return 0, BUCKET_DISABLED
    b_thresh = int(hist_buckets[cap_mask].min())
    # every particle at bucket >= b_thresh must be a pool member, or some
    # windowed-excluded giant would never be densely rendered
    k_total = int(hist_counts[hist_buckets >= b_thresh].sum())
    if k_total > m:
        return 0, BUCKET_DISABLED
    # pool members below the capable threshold deposit zero in the dense
    # pass (their giant mask is false), so a power-of-two size >= k_total
    # costs only matmul columns, never correctness
    for s in plan_sizes(m):
        if s >= k_total:
            return s, b_thresh
    return m, b_thresh
