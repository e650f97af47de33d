"""SPH renderer classes: the render loop around the splat core.

Mirrors the reference render-core contract (reference: src/topsy/sph.py:22-
332): ``render(draw_reason)`` runs the adaptive block loop with per-block
device timing feeding the LOD scheduler; ``get_image()`` returns the raw
(unmapped) framebuffer scaled by the photometric mass factor; camera state
(rotation_matrix / position_offset / scale) lives on the renderer.  The
subclass grid selects channel semantics:

=====================  ===========================  =======================
class                  reference analogue           channels
=====================  ===========================  =======================
SPHRenderer            SPH (rg32float weighting)    (m, m*qty)
RGBSPHRenderer         RGBSPH (rgba32float)         (I, V, U) band masses
DepthSPHRenderer       DepthSPH                     (m, m*clip_z)
SurfaceSPHRenderer     DepthSPHWithOcclusion        see render/surface.py
=====================  ===========================  =======================
"""

from __future__ import annotations

import copy
import functools
import logging
import time

import jax
import jax.numpy as jnp
import numpy as np

from .. import config
from ..camera import world_to_clip_matrix
from ..drawreason import DrawReason
from ..ops import splat, splat_atlas
from ..util import TimeDeviceOperation
from .store import ParticleStore, bucket_size

logger = logging.getLogger(__name__)


@functools.partial(jax.jit,
                   static_argnames=("resolution", "bucket", "depth_channel",
                                    "backend"))
def _render_block(pos_smooth, values, cell_ids, cell_table, matrix, scale,
                  start, count, *, resolution, bucket, depth_channel, backend):
    """Render one LOD block [start, start+count) into a fresh framebuffer.

    All arrays are the full padded stores; the block is realized as a
    dynamic_slice of a static ``bucket`` length plus masking, so each bucket
    size compiles once.
    """
    n_pad = pos_smooth.shape[0]
    sl = jnp.clip(start, 0, n_pad - bucket)
    ps = jax.lax.dynamic_slice(pos_smooth, (sl, 0), (bucket, 4))
    vals = jax.lax.dynamic_slice(values, (sl, 0), (bucket, values.shape[1]))
    ids = jax.lax.dynamic_slice(cell_ids, (sl,), (bucket,))
    idx = sl + jnp.arange(bucket, dtype=jnp.int32)
    mask = (idx >= start) & (idx < start + count) & cell_table[ids]

    if backend == "atlas":
        im, dropped = splat_atlas.splat_atlas(ps, vals, matrix, resolution,
                                              scale, extra_mask=mask,
                                              depth_channel=depth_channel)
    else:
        im = splat.splat_scatter(ps, vals, matrix, resolution, scale,
                                 extra_mask=mask, depth_channel=depth_channel)
        dropped = jnp.int32(0)
    return im, dropped


@functools.partial(jax.jit,
                   static_argnames=("resolution", "bucket", "depth_channel"))
def _render_block_presorted(pos_smooth, values, buckets, cell_ids, cell_table,
                            matrix, scale, start, count, giant_bucket, *,
                            resolution, bucket, depth_channel):
    """Render one piece of the presorted arrays — no per-frame sort
    (ops/morton.py): the stored (smoothing-bucket, Morton) order is already
    group-local and single-level per run.

    ``giant_bucket``: smoothing-bucket threshold — giants in buckets >= it
    are excluded from the windowed deposit; the render loop holds one
    exact dense layer per frame over those candidates (_prepare_giants)."""
    n_pad = pos_smooth.shape[0]
    sl = jnp.clip(start, 0, n_pad - bucket)
    ps = jax.lax.dynamic_slice(pos_smooth, (sl, 0), (bucket, 4))
    vals = jax.lax.dynamic_slice(values, (sl, 0), (bucket, values.shape[1]))
    bks = jax.lax.dynamic_slice(buckets, (sl,), (bucket,))
    ids = jax.lax.dynamic_slice(cell_ids, (sl,), (bucket,))
    idx = sl + jnp.arange(bucket, dtype=jnp.int32)
    mask = (idx >= start) & (idx < start + count) & cell_table[ids]
    return splat_atlas.splat_atlas(ps, vals, matrix, resolution, scale,
                                   extra_mask=mask,
                                   depth_channel=depth_channel,
                                   presorted_buckets=bks,
                                   giants=giant_bucket)


@functools.partial(jax.jit,
                   static_argnames=("resolution", "width", "depth_channel",
                                    "pad_group"))
def _render_block_columns(pos_smooth, values, buckets, cell_ids, cell_table,
                          matrix, scale, col0, giant_bucket, *, resolution,
                          width, depth_channel, pad_group):
    """Render columns [col0, col0+width) of the presorted (groups x
    pad_group) matrix — the sort-free interactive LOD path.

    Particles are shuffled within groups at presort build (ops/morton.py),
    so a column slice is a spatially fair subsample; slicing keeps the
    group-merged Morton locality, so the splat kernel's window machinery
    works exactly as for full renders.  Each static ``width`` (a power of
    two, down to the layout's min_slice_width) compiles once.

    ``cell_table`` (None = no culling, a separate trace) masks unselected
    cells inside the splat — the columns analogue of the reference's
    per-frame spherical cell culling (reference:
    progressive_render.py:207-220).
    """
    n_pad = pos_smooth.shape[0]
    ngr = n_pad // pad_group
    # merged splat groups take pad_group/width adjacent original groups;
    # the caller guarantees the layout's run padding covers that merge
    # (ops/morton.min_slice_width)
    assert pad_group % width == 0, width
    c0 = jnp.clip(col0, 0, pad_group - width)

    if width == pad_group:
        def slice_cols(arr):  # full coverage: the slice is the identity
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
    return splat_atlas.splat_atlas(slice_cols(pos_smooth),
                                   slice_cols(values), matrix, resolution,
                                   scale, extra_mask=mask,
                                   depth_channel=depth_channel,
                                   presorted_buckets=slice_cols(buckets),
                                   giants=giant_bucket)


@functools.partial(jax.jit,
                   static_argnames=("resolution", "depth_channel"))
def _render_giant_layer(pos_smooth, values, buckets, cell_ids, cell_table,
                        matrix, scale, *, resolution, depth_channel):
    """The per-frame exact dense layer for giant splats.

    Renders the store's static candidate pool (store.giant_candidates —
    the largest-smoothing real particles) at full support via the
    separable-matmul pass (ops/splat_giant.giant_image); the windowed
    EXPORT pieces exclude exactly these particles by slot threshold, so
    the sum reproduces the reference's untruncated rasterization
    (reference: shaders/sph.wgsl:54-66, no footprint clamp)."""
    from ..ops import splat_giant
    pyramid = splat_atlas.default_pyramid(resolution)
    px_per_world = resolution / (2.0 * scale)
    lev = splat.levels_from_buckets(buckets, px_per_world,
                                    pyramid.num_levels)
    mask = cell_table[cell_ids]
    parts = splat.splat_coefficients(pos_smooth, values, matrix, resolution,
                                     scale, pyramid, mask, mode="lowrank",
                                     depth_channel=depth_channel,
                                     level_override=lev)
    return splat_giant.giant_image(parts["cy_fine"], parts["cx_fine"],
                                   parts["h_px"], parts["coef_giant"],
                                   resolution)


def default_backend() -> str:
    return "atlas"


class SPHRenderer:
    """Density / mass-weighted-quantity renderer (2 channels)."""

    _buffer_name = "mass_and_quantity"
    _depth_channel = False

    def __init__(self, store: ParticleStore, render_progression,
                 resolution: int, wrapping: bool = False,
                 backend: str | None = None,
                 share_render_progression=None):
        self._store = store
        self._resolution = resolution
        self._wrapping = wrapping
        self._backend = backend or default_backend()
        self._render_progression = (share_render_progression
                                    if share_render_progression is not None
                                    else render_progression)
        self._render_timer = TimeDeviceOperation(config.GPU_TIMING_SMOOTH_WINDOW)

        self.scale = config.DEFAULT_SCALE
        self.rotation_matrix = np.eye(3)
        self.position_offset = np.zeros(3)
        self.has_rendered = False
        self.last_render_mass_scale = 1.0
        self.last_render_fps = 0.0

        self._image = None
        self._giant_image = None          # exact dense giant layer (unscaled)
        self._giant_bucket = None         # exclusion bucket threshold
        self._cell_table = store.cell_mask_table(None)
        self._cell_table_generation = None

    # -- public API (reference: sph.py:100-144) --------------------------------

    @property
    def resolution(self) -> int:
        return self._resolution

    @property
    def render_progression(self):
        return self._render_progression

    def invalidate(self, draw_reason=DrawReason.CHANGE):
        if draw_reason not in (DrawReason.REFINE, DrawReason.PRESENTATION_CHANGE):
            self.has_rendered = False

    def needs_refine(self) -> bool:
        return self._render_progression.needs_refine()

    def get_output_image(self):
        """The raw framebuffer as a device array, pre-divided so that the
        downstream photometric mass scale reproduces exact giants.

        The windowed accumulation needs ``* last_render_mass_scale`` for
        partial LOD coverage; the dense giant layer (_prepare_giants) is
        always complete, so it is folded in divided by the scalefactor —
        consumers keep multiplying the whole thing by the scalefactor
        exactly as before and giants come out exact at any coverage."""
        if self._giant_image is None:
            return self._image
        ms = self.last_render_mass_scale
        return self._image + self._giant_image * (1.0 / ms if ms > 0 else 1.0)

    def get_image(self) -> np.ndarray:
        """Raw SPH map as numpy, photometrically rescaled for partial renders
        (reference: sph.py:118-125)."""
        return self._get_image_unscaled() * self.last_render_mass_scale

    def _get_image_unscaled(self) -> np.ndarray:
        if not self.has_rendered:
            logger.info("Triggering export-quality render (no render yet)")
            self.render(DrawReason.EXPORT)
        return np.asarray(self.get_output_image())

    def get_image_device(self):
        """Raw SPH map as a device array, photometrically rescaled — lets
        consumers (autorange) reduce on device without a readback."""
        if not self.has_rendered:
            self.render(DrawReason.EXPORT)
        return self.get_output_image() * self.last_render_mass_scale

    def get_depth_image(self, depth_renderer_reason=DrawReason.CHANGE) -> np.ndarray:
        """Weighted mean depth in world units, for UI point-of-interest picks
        (reference: sph.py:100-116)."""
        depth_renderer = self._get_depth_renderer()
        depth_renderer.render(depth_renderer_reason)
        image = depth_renderer.get_image()
        # empty pixels are NaN on purpose (no depth there — the picker
        # ignores them); suppress numpy's 0/0 warning only
        with np.errstate(invalid="ignore", divide="ignore"):
            depth_viewport = image[..., -1] / image[..., 0]
        return (depth_viewport - 0.5) * self.scale * 2.0

    def _get_depth_renderer(self) -> "DepthSPHRenderer":
        # cached: a fresh instance per double-click would re-trace the
        # depth-channel splat variant — a visible first-probe hitch.  The
        # store/resolution/backend are fixed for this renderer's lifetime;
        # only the view and the progression's culling state change per probe.
        r = getattr(self, "_depth_renderer", None)
        if r is None:
            r = DepthSPHRenderer(self._store, None, self._resolution,
                                 wrapping=self._wrapping,
                                 backend=self._backend,
                                 share_render_progression=copy.copy(
                                     self._render_progression))
            self._depth_renderer = r
        r._render_progression = copy.copy(self._render_progression)
        r.rotation_matrix = self.rotation_matrix
        r.position_offset = self.position_offset
        r.scale = self.scale
        return r

    # -- render loop (reference: sph.py:306-332) --------------------------------

    def render(self, draw_reason=DrawReason.CHANGE):
        if draw_reason == DrawReason.PRESENTATION_CHANGE:
            return

        columns = self._maybe_activate_columns(draw_reason)
        prog = self._render_progression
        if draw_reason != DrawReason.REFINE:
            prog.select_sphere(-np.asarray(self.position_offset), self.scale * 1.2)
            self._refresh_cell_table()

        matrix = jnp.asarray(self._matrix(), dtype=jnp.float32)
        scale = jnp.float32(self.scale)

        # any unobserved deferred measurement from the previous frame is
        # stale now (its image may already have been consumed elsewhere)
        self._discard_pending_timing()
        self._frame_t0 = time.perf_counter()

        clear = prog.start_frame(draw_reason)
        del clear  # framebuffer accumulation restarts unless REFINE continues

        if draw_reason not in (DrawReason.REFINE,) or self._image is None:
            first_block = True
        else:
            first_block = False

        # EXPORT frames need no per-block timing feedback: launches pipeline
        # asynchronously and sync once at the end.  Column (whole-tier)
        # interactive frames are a SINGLE launch, so they need no
        # intra-frame feedback either: they run barrier-free and their
        # device time is recovered from the frame's one natural barrier
        # (the presentation readback / the caller's sync) via
        # notify_frame_time — one host round-trip per frame, not two.
        defer_timing = columns and draw_reason != DrawReason.EXPORT
        sync_blocks = draw_reason != DrawReason.EXPORT and not defer_timing

        if draw_reason == DrawReason.EXPORT:
            use_presorted = self._use_presorted()
            self._export_renders = getattr(self, "_export_renders", 0) + 1
            if use_presorted:
                # sort-free full coverage over the static (bucket, Morton)
                # order; geometric culling still applies via the cell table
                self._render_presorted(matrix, scale, first_block)
                prog.mark_all_rendered(self._render_timer.total_time_in_frame())
                self._finish_frame(prog, record_timing=False)
                return

        if columns:
            # exact giants in interactive LOD too: one dense layer per view
            # (kept across REFINE continuations), exclusion by bucket in
            # every column slice — see _prepare_giants / get_output_image
            self._prepare_giants(matrix, scale,
                                 keep=(draw_reason == DrawReason.REFINE
                                       and self._image is not None))
        elif draw_reason != DrawReason.REFINE:
            # the sorted block path handles giants inside each block
            # (splat_atlas giants='auto'), scaled like its other particles
            self._giant_image = None
            self._giant_bucket = None

        while (block := prog.get_block(self._render_timer.total_time_in_frame())) is not None:
            starts, lens = block
            for s, l in zip(starts, lens):
                if l <= 0:
                    continue
                if columns:
                    first_block = self._render_columns_range(
                        matrix, scale, s, l, first_block, sync_blocks)
                    continue
                bucket = bucket_size(l, self._store.n_pad)
                # oversized blocks are rendered in bucket-sized pieces
                for piece in range(0, l, bucket):
                    with self._render_timer:
                        im = self._launch_block(matrix, scale,
                                                s + piece,
                                                min(bucket, l - piece),
                                                bucket)
                        if first_block:
                            self._image = im
                            first_block = False
                        else:
                            self._image = self._image + im
                    if sync_blocks:
                        # barrier so the scheduler's feedback sees real
                        # device time
                        self._render_timer.sync(self._image)
            prog.end_block(self._render_timer.total_time_in_frame())

        self._finish_frame(prog, record_timing=sync_blocks,
                           defer_timing=defer_timing)

    def _finish_frame(self, prog, record_timing: bool = True,
                      defer_timing: bool = False):
        """Close the frame.  EXPORT frames run barrier-free (throughput
        mode): callers barrier on the image readback, consecutive movie
        frames keep the device pipeline full, and their enqueue-only
        timing is discarded (``record_timing=False``) rather than fed to
        the fps display or the LOD scheduler.

        ``defer_timing=True`` (barrier-free interactive frames): the
        frame's device time will be reported later by whoever observes the
        frame's single end-of-frame barrier (``notify_frame_time`` /
        ``notify_presentation_barrier``); until then the LOD
        recommendation keeps its last value and the photometric scale
        factor is computed immediately as always."""
        if defer_timing:
            self._render_timer.end_frame(record=False)  # enqueue time only
            self._pending_timing_prog = prog
            self.last_render_mass_scale = prog.end_frame_get_scalefactor(
                defer_adapt=True)
        else:
            self._render_timer.end_frame(record=record_timing)
            self.last_render_mass_scale = prog.end_frame_get_scalefactor()
        mean = self._render_timer.running_mean_duration
        self.last_render_fps = 1.0 / mean if mean > 0 else 0.0
        self.has_rendered = True
        self._postprocess_frame()

    # -- deferred frame timing (one host round-trip per interactive frame) ------

    def notify_frame_time(self, seconds: float):
        """Report the measured device time of the last barrier-free
        interactive frame (the caller observed the frame's single natural
        barrier — presentation readback or an explicit sync).  Feeds the
        fps running mean and the LOD scheduler's deferred adaptation.
        No-op when no measurement is pending."""
        prog = getattr(self, "_pending_timing_prog", None)
        if prog is None:
            return
        self._pending_timing_prog = None
        self._render_timer.record_external(seconds)
        prog.report_deferred_timing(max(0.0, seconds))
        mean = self._render_timer.running_mean_duration
        self.last_render_fps = 1.0 / mean if mean > 0 else 0.0

    def notify_presentation_barrier(self, t_effective: float):
        """Presentation-pipeline hook: ``t_effective`` is the
        ``time.perf_counter`` timestamp at which the presentation readback
        completed, minus the calibrated pure-transfer cost of that
        readback.  Everything between the frame's first launch and that
        point is device work (render + colormap + fit), which is exactly
        the time the frame budget must cover."""
        if getattr(self, "_pending_timing_prog", None) is None:
            return
        self.notify_frame_time(max(0.0, t_effective - self._frame_t0))

    def _discard_pending_timing(self):
        prog = getattr(self, "_pending_timing_prog", None)
        if prog is not None:
            self._pending_timing_prog = None
            prog.discard_deferred_timing()

    # -- presorted (sort-free) export path --------------------------------------

    def _use_presorted(self) -> bool:
        """Sort-free exports pay a one-time host presort (~1 us/particle), so
        the order is built once exports repeat (movie rendering, repeated
        saves) — a one-shot save never pays it.  The layout is cached on the
        store, so later renderers (mode switches) reuse it immediately."""
        if self._backend != "atlas" or not config.EXPORT_USE_PRESORTED:
            return False
        if getattr(self._store, "_presorted_layout", None) is not None:
            return True
        return getattr(self, "_export_renders", 0) >= 1

    # -- sort-free interactive LOD over presorted columns -----------------------

    def _maybe_activate_columns(self, draw_reason) -> bool:
        """Switch the progression to sort-free column LOD when possible.

        The presorted (bucket, Morton) order with within-group shuffling
        makes any column slice of the (groups x 512) matrix a spatially
        fair subsample (ops/morton.py), so interactive frames need no
        per-frame sort: they render whole-column ranges through the same
        fast path as EXPORT.  Activation is once per renderer; a REFINE
        frame never switches mid-progression.
        """
        from ..progression import RenderProgressionColumns
        if isinstance(self._render_progression, RenderProgressionColumns):
            return True
        if draw_reason in (DrawReason.REFINE, DrawReason.EXPORT):
            return False
        if self._backend != "atlas" or not config.INTERACTIVE_USE_PRESORTED:
            return False
        store = self._store
        store.ensure_presorted()
        layout = store.presorted_layout
        if layout.real_per_column is None:
            return False  # layout without safe column slicing
        from ..ops.morton import min_slice_width
        # decimation-mip tiers let CHANGE blocks go below the 1/8 column
        # floor at 10^8-particle scale (store.ensure_column_mips; empty for
        # small snapshots)
        mips = store.ensure_column_mips()
        # cell culling carries over from the cell-aware progression
        self._render_progression = RenderProgressionColumns(
            layout.real_per_column,
            cell_layout=getattr(self._render_progression, "cell_layout", None),
            col_quantum=min_slice_width(layout),
            mip_tiers=[(m.layout.real_per_column,
                        min_slice_width(m.layout)) for m in mips])
        return True

    def _render_columns_range(self, matrix, scale, col0: int, ncols: int,
                              first_block: bool, sync_blocks: bool) -> bool:
        """Render columns [col0, col0+ncols), decomposed into power-of-two
        slice widths (each width compiles once).

        The progression's ``last_block_tier`` selects which decimation tier
        the columns index: a mip tier (store.ensure_column_mips) below the
        main layout's 1/8 slice floor, or the main presorted arrays."""
        from ..ops.morton import slice_widths
        store = self._store
        prog = self._render_progression
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
        launches = []
        off = 0
        for width in slice_widths(layout):
            while ncols - off >= width:
                launches.append((col0 + off, width))
                off += width
        if off != ncols:  # progression emits col_quantum multiples
            raise AssertionError(f"unrenderable column range {ncols}")
        for lc0, width in launches:
            with self._render_timer:
                im, dropped = _render_block_columns(
                    *flat_args,
                    self._cell_table if culling else None,
                    matrix, scale,
                    jnp.int32(lc0),
                    jnp.int32(self._giant_bucket),
                    resolution=self._resolution, width=width,
                    depth_channel=self._depth_channel,
                    pad_group=pad_group)
                self._dropped_splats = dropped
                if first_block:
                    self._image = im
                    first_block = False
                else:
                    self._image = self._image + im
            if sync_blocks:
                self._render_timer.sync(self._image)
        return first_block

    def _prepare_giants(self, matrix, scale, keep: bool):
        """Per-frame giant planning (ops/splat_giant.giant_plan).

        Sets ``self._giant_bucket`` (the exclusion bucket threshold every
        windowed presorted call uses this frame) and ``self._giant_image``
        (the exact dense layer, or None) — a SEPARATE framebuffer: the
        windowed accumulation gets the LOD mass scalefactor at display
        time, the giant layer is always complete and must not
        (get_output_image folds it in pre-divided).  ``keep`` (REFINE
        continuation) reuses the existing plan — the view is unchanged."""
        from ..ops import splat_giant
        if keep and getattr(self, "_giant_bucket", None) is not None:
            return
        store = self._store
        num_levels = splat_atlas.default_pyramid(self._resolution).num_levels
        size, b_thresh = splat_giant.giant_plan(
            store.giant_meta(), self._resolution, float(self.scale),
            num_levels)
        self._giant_bucket = b_thresh
        if size == 0:
            self._giant_image = None
            return
        with self._render_timer:
            cand = store.giant_candidates(size)
            self._giant_image = _render_giant_layer(
                cand["pos"], store.giant_values_for(self._buffer_name, size),
                cand["buckets"], cand["cell_ids"], self._cell_table, matrix,
                scale, resolution=self._resolution,
                depth_channel=self._depth_channel)

    def _render_presorted(self, matrix, scale, first_block: bool):
        store = self._store
        store.ensure_presorted()
        self._prepare_giants(matrix, scale, keep=False)
        total = store.n_presorted
        bucket = bucket_size(total, total)
        for piece in range(0, total, bucket):
            with self._render_timer:
                im, dropped = _render_block_presorted(
                    store.pos_smooth_presorted,
                    store.presorted_values_for(self._buffer_name),
                    store.presorted_buckets, store.cell_ids_presorted,
                    self._cell_table, matrix, scale,
                    jnp.int32(piece), jnp.int32(min(bucket, total - piece)),
                    jnp.int32(self._giant_bucket),
                    resolution=self._resolution, bucket=bucket,
                    depth_channel=self._depth_channel)
                self._dropped_splats = dropped
                if first_block:
                    self._image = im
                    first_block = False
                else:
                    self._image = self._image + im

    def _launch_block(self, matrix, scale, start: int, count: int,
                      bucket: int):
        """Render one LOD block into a fresh framebuffer (device array)."""
        im, dropped = _render_block(
            self._store.pos_smooth, self._store.values_for(self._buffer_name),
            self._store.cell_ids, self._cell_table,
            matrix, scale, jnp.int32(start), jnp.int32(count),
            resolution=self._resolution, bucket=bucket,
            depth_channel=self._depth_channel, backend=self._backend)
        self._dropped_splats = dropped  # device scalar; checked lazily
        return im

    @property
    def last_dropped_splats(self) -> int:
        """Splats dropped by the bounded spill tiers in the last block
        (normally 0; nonzero indicates a pathologically sparse scene)."""
        d = getattr(self, "_dropped_splats", None)
        return 0 if d is None else int(np.asarray(d))

    def _postprocess_frame(self):
        """Hook for subclasses (periodic tiling etc.)."""

    def _matrix(self) -> np.ndarray:
        return world_to_clip_matrix(self.rotation_matrix, self.position_offset,
                                    self.scale)

    def _refresh_cell_table(self):
        prog = self._render_progression
        gen = getattr(prog, "selection_generation", None)
        if gen != self._cell_table_generation or self._cell_table is None:
            mask = prog.get_selected_cell_mask()
            self._cell_table = self._store.cell_mask_table(mask)
            self._cell_table_generation = gen


class RGBSPHRenderer(SPHRenderer):
    """Three-band (I, V, U) stellar-light renderer (reference: sph.py:432-439)."""

    _buffer_name = "rgb"


class DepthSPHRenderer(SPHRenderer):
    """Adds a mass-weighted clip-depth channel (reference: sph.py:443-446)."""

    _depth_channel = True
