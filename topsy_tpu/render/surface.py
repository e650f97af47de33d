"""Occlusion (surface) renderer: front-most-fragment semantics.

Mirrors the reference's DepthSPHWithOcclusion (reference: src/topsy/sph.py:
459-656): particles above a density-percentile cut render as hemispheres
with a greater-compare depth test; output channels are (quantity value,
surface depth).  Blocks combine by depth max-compositing instead of
accumulation, and the photometric mass scale is unity (max semantics).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..drawreason import DrawReason
from ..ops import zsplat, zsplat_atlas
from .sph import SPHRenderer
from .store import ParticleStore


@functools.partial(jax.jit, static_argnames=("resolution", "bucket"))
def _render_block_surface(pos_smooth, values, cell_ids, cell_table, matrix,
                          scale, density_cut, start, count, *,
                          resolution, bucket):
    n_pad = pos_smooth.shape[0]
    sl = jnp.clip(start, 0, n_pad - bucket)
    ps = jax.lax.dynamic_slice(pos_smooth, (sl, 0), (bucket, 4))
    vals = jax.lax.dynamic_slice(values, (sl, 0), (bucket, values.shape[1]))
    ids = jax.lax.dynamic_slice(cell_ids, (sl,), (bucket,))
    idx = sl + jnp.arange(bucket, dtype=jnp.int32)
    mask = (idx >= start) & (idx < start + count) & cell_table[ids]
    return zsplat.zsplat_scatter(ps, vals, matrix, resolution, scale,
                                 density_cut=density_cut, extra_mask=mask)


@functools.partial(jax.jit,
                   static_argnames=("resolution", "width", "pad_group"))
def _render_block_columns_surface(pos_smooth, values, buckets, cell_ids,
                                  cell_table, matrix, scale, density_cut,
                                  col0, giant_bucket, *, resolution, width,
                                  pad_group):
    """Column-slice z-buffered render (sort-free LOD, as sph.py's columns
    path) through the front-most atlas engine (ops/zsplat_atlas.py).
    ``cell_table`` (None = no culling) masks unselected cells.  Slices are
    NOT merged into pad_group-particle groups: zsplat_atlas groups the
    flat slice at ``group=width`` so each original group keeps its own
    tight window (any width works; the whole range is one launch)."""
    n_pad = pos_smooth.shape[0]
    ngr = n_pad // pad_group
    assert width <= pad_group
    c0 = jnp.clip(col0, 0, pad_group - width)

    if width == pad_group:
        def slice_cols(arr):
            return arr
    else:
        def slice_cols(arr):
            tail = arr.shape[1:]
            a = arr.reshape((ngr, pad_group) + tail)
            start = (0, c0) + (0,) * len(tail)
            return jax.lax.dynamic_slice(
                a, start, (ngr, width) + tail).reshape(
                (ngr * width,) + tail)

    mask = None if cell_table is None else cell_table[slice_cols(cell_ids)]
    # raised spill budgets: whole-tier CHANGE frames put every group of a
    # decimation tier in one launch, and those groups cover 8x the volume
    from .. import config
    return zsplat_atlas.zsplat_atlas(
        slice_cols(pos_smooth), slice_cols(values), matrix, resolution,
        scale, slice_cols(buckets), density_cut=density_cut,
        extra_mask=mask, giants=giant_bucket,
        group=None if width == pad_group else width,
        spill_group_cap=4 * config.SPLAT_SPILL_GROUP_CAP, t3_cap=4096)


@functools.partial(jax.jit, static_argnames=("resolution",))
def _render_giant_layer_surface(pos_smooth, values, buckets, cell_ids,
                                cell_table, matrix, scale, density_cut, *,
                                resolution):
    """Exact dense hemisphere layer for giant splats in surface mode
    (ops/splat_giant.zsplat_giant_image): full-support, true-h profile,
    max-composited over the windowed image like any other fragment set."""
    from ..ops import splat, splat_atlas as _sa, splat_giant
    pyramid = _sa.default_pyramid(resolution)
    cx, cy, z01, h_px, visible = splat.project(pos_smooth, matrix,
                                               resolution, scale)
    px_per_world = resolution / (2.0 * scale)
    lev = splat.levels_from_buckets(buckets, px_per_world,
                                    pyramid.num_levels)
    h_l = h_px * splat.exp2_int(-lev)
    mass, qty = values[:, 0], values[:, 1]
    h_world = pos_smooth[:, 3]
    rho = mass / jnp.maximum(h_world, 1e-30) ** 3
    active = (visible & (rho > density_cut) & cell_table[cell_ids]
              & (h_l > splat_giant.GIANT_H))
    h_clip_half = h_world / scale * 0.5
    return splat_giant.zsplat_giant_image(cy, cx, h_px, z01, h_clip_half,
                                          qty, active, resolution)


@jax.jit
def _max_composite(a, b):
    """Combine two (value, depth) maps keeping the front-most fragment."""
    front = b[..., 1] > a[..., 1]
    return jnp.where(front[..., None], b, a)


class SurfaceSPHRenderer(SPHRenderer):
    """Front-most surface renderer with density cut."""

    _buffer_name = "surface_values"  # (mass, RAW quantity): the z-buffer
    # winner displays the quantity itself (reference: sph.wgsl
    # vertex_depth_with_cut), not the additive modes' mass-weighted channel
    _rho_percentiles_num_samples = 101

    def __init__(self, store: ParticleStore, render_progression,
                 resolution: int, wrapping: bool = False,
                 backend: str | None = None, share_render_progression=None):
        super().__init__(store, render_progression, resolution,
                         wrapping=wrapping, backend=backend,
                         share_render_progression=share_render_progression)
        loader = store._loader
        self._percentile_to_den_cut = zsplat.density_cut_percentiles(
            loader.get_mass(), loader.get_smooth(),
            self._rho_percentiles_num_samples)
        lo, hi = self.get_density_cut_percentile_range()
        self._cut_val = 0.5 * (lo + hi)

    # -- density cut API (reference: sph.py:503-515) ----------------------------

    def get_density_cut_percentile(self):
        return self._cut_val

    def set_density_cut_percentile(self, value):
        self._cut_val = value

    def get_density_cut_percentile_range(self):
        return 0.0, 100.0

    def _density_cut_value(self) -> float:
        i = int(self._cut_val / 100.0 * (self._rho_percentiles_num_samples - 1))
        return float(self._percentile_to_den_cut[i])

    # -- render ------------------------------------------------------------------

    def render(self, draw_reason=DrawReason.CHANGE):
        if draw_reason == DrawReason.PRESENTATION_CHANGE:
            return
        # the presorted column path serves EXPORT too: the scatter-max
        # block path materializes a 16x16 window per particle twice
        columns = self._maybe_activate_columns(
            DrawReason.CHANGE if draw_reason == DrawReason.EXPORT
            else draw_reason)
        prog = self._render_progression
        if draw_reason != DrawReason.REFINE:
            prog.select_sphere(-np.asarray(self.position_offset), self.scale * 1.2)
            self._refresh_cell_table()

        matrix = jnp.asarray(self._matrix(), dtype=jnp.float32)
        scale = jnp.float32(self.scale)
        cut = jnp.float32(self._density_cut_value())
        values = self._store.values_for(self._buffer_name)

        import time as _time
        self._discard_pending_timing()
        self._frame_t0 = _time.perf_counter()

        if columns:
            self._prepare_surface_giants(
                matrix, scale, cut,
                keep=(draw_reason == DrawReason.REFINE
                      and self._image is not None))
        else:
            # the scatter fallback keeps the legacy truncated hemispheres
            self._giant_bucket = None
            self._surface_giant_layer = None

        prog.start_frame(draw_reason)
        first_block = draw_reason != DrawReason.REFINE or self._image is None

        from .store import bucket_size
        # column (whole-tier) interactive frames run barrier-free with
        # deferred timing, exactly as the additive path (render/sph.py):
        # one launch per frame, feedback from the frame's single natural
        # end-of-frame barrier
        defer_timing = columns and draw_reason != DrawReason.EXPORT
        sync_blocks = draw_reason != DrawReason.EXPORT and not defer_timing
        while (block := prog.get_block(self._render_timer.total_time_in_frame())) is not None:
            starts, lens = block
            for s, l in zip(starts, lens):
                if l <= 0:
                    continue
                if columns:
                    first_block = self._render_columns_surface(
                        matrix, scale, cut, s, l, first_block, sync_blocks)
                    continue
                bucket = bucket_size(l, self._store.n_pad)
                for piece in range(0, l, bucket):
                    with self._render_timer:
                        im = _render_block_surface(
                            self._store.pos_smooth, values,
                            self._store.cell_ids, self._cell_table,
                            matrix, scale, cut,
                            jnp.int32(s + piece),
                            jnp.int32(min(bucket, l - piece)),
                            resolution=self._resolution, bucket=bucket)
                        if first_block:
                            self._image = im
                            first_block = False
                        else:
                            self._image = _max_composite(self._image, im)
                    if sync_blocks:
                        self._render_timer.sync(self._image)
            prog.end_block(self._render_timer.total_time_in_frame())
        layer = getattr(self, "_surface_giant_layer", None)
        if layer is not None:
            # max-composite is idempotent, so re-compositing the layer on
            # every REFINE continuation is safe and keeps giants exact at
            # any partial coverage
            with self._render_timer:
                self._image = (layer if self._image is None
                               else _max_composite(self._image, layer))
        # EXPORT (sync_blocks=False) runs barrier-free (throughput mode,
        # SPHRenderer._finish_frame): callers barrier on the readback and
        # the enqueue-only timing is discarded
        self._finish_frame(prog, record_timing=sync_blocks,
                           defer_timing=defer_timing)
        self.last_render_mass_scale = 1.0  # max semantics need no rescale

    def _prepare_surface_giants(self, matrix, scale, cut, keep: bool):
        """Per-view giant planning for surface mode: sets the bucket
        exclusion threshold for the windowed column slices and builds the
        exact dense hemisphere layer (``keep`` reuses both across REFINE
        continuations — the view is unchanged)."""
        from ..ops import splat_atlas as _sa, splat_giant
        if keep and getattr(self, "_giant_bucket", None) is not None:
            return
        store = self._store
        num_levels = _sa.default_pyramid(self._resolution).num_levels
        size, b_thresh = splat_giant.giant_plan(
            store.giant_meta(), self._resolution, float(self.scale),
            num_levels)
        self._giant_bucket = b_thresh
        if size == 0:
            self._surface_giant_layer = None
            return
        with self._render_timer:
            cand = store.giant_candidates(size)
            self._surface_giant_layer = _render_giant_layer_surface(
                cand["pos"],
                store.giant_values_for(self._buffer_name, size),
                cand["buckets"], cand["cell_ids"], self._cell_table,
                matrix, scale, cut, resolution=self._resolution)

    def _render_columns_surface(self, matrix, scale, cut, col0: int,
                                ncols: int, first_block: bool,
                                sync_blocks: bool) -> bool:
        store = self._store
        prog = self._render_progression
        # decimation-mip tiers (render/sph.py _render_columns_range): the
        # progression's last block selects which tier the columns index
        mips = getattr(self, "_column_mips", None)
        if mips is None:
            mips = store.ensure_column_mips()
            self._column_mips = mips
        tier_idx = getattr(prog, "last_block_tier", len(mips))
        tier = mips[tier_idx] if tier_idx < len(mips) else None
        layout = store.presorted_layout if tier is None else tier.layout
        pad_group = layout.pad_group
        culling = prog.get_selected_cell_mask() is not None
        if tier is None:
            flat_args = (store.pos_smooth_presorted,
                         store.presorted_values_for(self._buffer_name),
                         store.presorted_buckets,
                         store.cell_ids_presorted if culling else None)
        else:
            flat_args = (tier.pos_smooth,
                         tier.values_for(self._buffer_name),
                         tier.buckets,
                         tier.cell_ids if culling else None)
        # ONE launch for the whole range (un-merged slices accept any
        # width)
        if ncols:
            with self._render_timer:
                from ..ops.splat_giant import BUCKET_DISABLED
                gb = self._giant_bucket
                im, dropped = _render_block_columns_surface(
                    *flat_args,
                    self._cell_table if culling else None,
                    matrix, scale, cut,
                    jnp.int32(col0),
                    jnp.int32(BUCKET_DISABLED if gb is None else gb),
                    resolution=self._resolution,
                    width=ncols, pad_group=pad_group)
                self._dropped_splats = dropped
                if first_block:
                    self._image = im
                    first_block = False
                else:
                    self._image = _max_composite(self._image, im)
            if sync_blocks:
                self._render_timer.sync(self._image)
        return first_block

    def get_image(self) -> np.ndarray:
        """No photometric rescaling (reference: sph.py:655-656)."""
        return self._get_image_unscaled()
