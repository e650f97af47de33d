"""Multi-chip SPH renderer: the standard render loop over a device mesh.

Drops into the Visualizer in place of the single-chip renderer (pass
``mesh=`` to the Visualizer): LOD blocks, cell culling, quantity switching
and photometric rescaling behave identically; each block is splatted by all
chips on their particle shards and psum-reduced over the mesh
(parallel/render_step.py).
"""

from __future__ import annotations

import jax
import numpy as np

from .. import config
from ..parallel.render_step import DistributedSplatter
from .periodic import PeriodicSPHRenderer
from .sph import SPHRenderer
from .store import ParticleStore
from .surface import SurfaceSPHRenderer


class MeshSplatterMixin:
    """Shared mesh plumbing for distributed renderers: owns the
    DistributedSplatter (rebuilt when the channel buffer changes) and the
    mesh-aware sort-free column activation."""

    def __init__(self, store: ParticleStore, render_progression,
                 resolution: int, mesh, wrapping: bool = False,
                 backend: str | None = None, share_render_progression=None):
        super().__init__(store, render_progression, resolution,
                         wrapping=wrapping, backend=backend,
                         share_render_progression=share_render_progression)
        self._mesh = mesh
        self._splatter = None
        self._splatter_version = None

    def _get_splatter(self) -> DistributedSplatter:
        version = (self._buffer_name, self._store.values_version)
        if self._splatter is None or self._splatter_version != version:
            loader = self._store._loader
            pos_smooth = loader.get_pos_smooth()
            if self._buffer_name == "rgb":
                values = loader.get_rgb_masses().astype(np.float32)
            else:
                mass = loader.get_mass().astype(np.float32)
                qname = self._store.quantity_name
                if qname is None:
                    qty = np.zeros_like(mass)
                else:
                    qty = loader.get_named_quantity(qname).astype(np.float32)
                if self._buffer_name == "surface_values":
                    # z-buffer winners display the raw quantity (see
                    # render/surface.py SurfaceSPHRenderer._buffer_name)
                    values = np.stack([mass, qty], axis=1)
                else:
                    values = np.stack([mass, mass * qty], axis=1)
            cell_ids = loader.get_cell_ids()
            self._splatter = DistributedSplatter(
                self._mesh, pos_smooth, values, self._resolution,
                cell_ids=cell_ids, depth_channel=self._depth_channel)
            self._splatter_version = version
        return self._splatter


    def _maybe_activate_columns(self, draw_reason) -> bool:
        """Sort-free column LOD over the mesh: each chip renders the column
        range of its Morton slab and the partial framebuffers reduce over
        the mesh (the per-group shuffle is global, so the union is the same fair
        subsample as single-chip)."""
        from ..drawreason import DrawReason
        from ..progression import RenderProgressionColumns
        if isinstance(self._render_progression, RenderProgressionColumns):
            return True
        if draw_reason in (DrawReason.REFINE, DrawReason.EXPORT):
            return False
        if self._backend != "atlas" or not config.INTERACTIVE_USE_PRESORTED:
            return False
        splatter = self._get_splatter()
        if not splatter.supports_presorted():
            splatter._warn_presorted_unavailable(
                "interactive sort-free column LOD")
            return False
        layout = splatter.presorted_layout
        if layout is None or layout.real_per_column is None:
            return False
        from ..ops.morton import min_slice_width
        # decimation-mip tiers (per-chip CHANGE floor below 1/(8D) of the
        # snapshot — engages only beyond ~10^9 particles on 8 chips)
        mips = splatter.presorted_mip_layouts()
        self._column_mip_count = len(mips)
        self._render_progression = RenderProgressionColumns(
            layout.real_per_column,
            cell_layout=getattr(self._render_progression, "cell_layout", None),
            col_quantum=min_slice_width(layout),
            mip_tiers=[(m.real_per_column, min_slice_width(m))
                       for m in mips])
        return True

    def _column_tier(self):
        """Map the progression's last block tier to the splatter's tier
        argument (None = main layout)."""
        n_mips = getattr(self, "_column_mip_count", 0)
        ti = getattr(self._render_progression, "last_block_tier", n_mips)
        return ti if ti < n_mips else None


class DistributedSPHRenderer(MeshSplatterMixin, SPHRenderer):
    """Density / weighted-quantity renderer over a particle-sharded mesh."""

    def _render_columns_range(self, matrix, scale, col0: int, ncols: int,
                              first_block: bool, sync_blocks: bool) -> bool:
        splatter = self._get_splatter()
        mask = self._render_progression.get_selected_cell_mask()
        with self._render_timer:
            # the base render loop prepared the per-frame dense giant layer
            # (_prepare_giants); exclude those giants from every shard's
            # windowed deposit by the same bucket threshold
            im, dropped = splatter.render_columns(
                np.asarray(matrix), float(scale), col0, ncols,
                cell_mask=mask, tier=self._column_tier(),
                giant_bucket=self._giant_bucket)
            self._dropped_splats = dropped
            if first_block:
                self._image = im
                first_block = False
            else:
                self._image = self._image + im
        if sync_blocks:
            self._render_timer.sync(self._image)
        return first_block

    def _use_presorted(self) -> bool:
        # the sharded splatter owns its own presorted slabs (contiguous
        # Morton slices per device), not the store's single-device copies
        if self._backend != "atlas" or not config.EXPORT_USE_PRESORTED:
            return False
        splatter = self._get_splatter()
        if not splatter.supports_presorted():
            splatter._warn_presorted_unavailable("sort-free EXPORT")
            return False
        if splatter.has_presorted():
            return True
        return getattr(self, "_export_renders", 0) >= 1

    def _render_presorted(self, matrix, scale, first_block: bool):
        splatter = self._get_splatter()
        mask = self._render_progression.get_selected_cell_mask()
        # same contract as the single-chip _render_presorted: plan the
        # frame's giant set, render the dense exact layer once (folded in
        # by get_output_image), exclude those giants from the slab deposits
        self._prepare_giants(matrix, scale, keep=False)
        with self._render_timer:
            im, dropped = splatter.render_presorted(
                np.asarray(matrix), float(scale), cell_mask=mask,
                giant_bucket=self._giant_bucket)
            self._dropped_splats = dropped
            self._image = im if first_block else self._image + im
        # no end-of-frame barrier: EXPORT runs in throughput mode (see
        # SPHRenderer._finish_frame) — callers barrier on the readback

    def _launch_block(self, matrix, scale, start: int, count: int,
                      bucket: int):
        prog = self._render_progression
        mask = prog.get_selected_cell_mask()
        return self._get_splatter().render(np.asarray(matrix), float(scale),
                                           start, count, cell_mask=mask)

    def _get_depth_renderer(self):
        # cached for the same reason as SPHRenderer._get_depth_renderer —
        # and more so: a fresh instance per probe would rebuild the
        # DistributedSplatter (full device_put of every shard) and re-jit
        # the shard_map pipeline through the remote compile service.
        import copy
        r = getattr(self, "_depth_renderer", None)
        if r is None:
            r = DistributedDepthSPHRenderer(
                self._store, None, self._resolution, self._mesh,
                wrapping=self._wrapping, backend=self._backend,
                share_render_progression=copy.copy(self._render_progression))
            self._depth_renderer = r
        r._render_progression = copy.copy(self._render_progression)
        r.rotation_matrix = self.rotation_matrix
        r.position_offset = self.position_offset
        r.scale = self.scale
        return r


class DistributedRGBSPHRenderer(DistributedSPHRenderer):
    _buffer_name = "rgb"


class DistributedDepthSPHRenderer(DistributedSPHRenderer):
    _depth_channel = True


class DistributedSurfaceSPHRenderer(MeshSplatterMixin, SurfaceSPHRenderer):
    """Front-most (z-buffered) surface renderer over a particle-sharded mesh.

    The cross-shard combine is an elementwise depth arg-max instead of the
    additive psum (SURVEY §5 last bullet; reference z-buffer semantics:
    src/topsy/sph.py:606-610,467-478), implemented inside the splatter's
    surface column step.  Requires the sort-free presorted column path (the
    scatter-max fallback is orders of magnitude slower and is never sharded);
    if the layout cannot be built the render falls back to the single-chip
    surface machinery with a warning.
    """

    def _maybe_activate_columns(self, draw_reason) -> bool:
        ok = MeshSplatterMixin._maybe_activate_columns(self, draw_reason)
        if not ok:
            import logging
            logging.getLogger(__name__).warning(
                "distributed surface mode needs the presorted column path; "
                "rendering single-chip")
        return ok

    def _render_columns_surface(self, matrix, scale, cut, col0: int,
                                ncols: int, first_block: bool,
                                sync_blocks: bool) -> bool:
        splatter = self._get_splatter()
        mask = self._render_progression.get_selected_cell_mask()
        with self._render_timer:
            # exclude the prepared giants (dense hemisphere layer is
            # max-composited in by the base surface render loop)
            im, dropped = splatter.render_columns_surface(
                np.asarray(matrix), float(scale), float(cut), col0, ncols,
                cell_mask=mask, tier=self._column_tier(),
                giant_bucket=self._giant_bucket)
            self._dropped_splats = dropped
            if first_block:
                self._image = im
                first_block = False
            else:
                from .surface import _max_composite
                self._image = _max_composite(self._image, im)
        if sync_blocks:
            self._render_timer.sync(self._image)
        return first_block


class DistributedPeriodicSPHRenderer(PeriodicSPHRenderer,
                                     DistributedSPHRenderer):
    """Periodic lattice compositing of the mesh-rendered panel.

    The base panel is splatted across the mesh's particle shards and
    psum-reduced over the mesh exactly as DistributedSPHRenderer does (whose
    _render_columns_range/_launch_block/_render_presorted this class
    inherits — PeriodicSPHRenderer contributes only the lattice
    post-processing); the (2n+1)^3 composite (reference:
    src/topsy/periodic_sph.py:74-88) then runs on the reduced panel, so it
    needs no mesh awareness of its own."""

    def __init__(self, store: ParticleStore, render_progression,
                 resolution: int, mesh, periodicity_scale: float,
                 backend: str | None = None):
        # PeriodicSPHRenderer.__init__ forwards mesh through **kwargs to
        # MeshSplatterMixin (via the DistributedSPHRenderer leg of the MRO)
        super().__init__(store, render_progression, resolution,
                         periodicity_scale=periodicity_scale,
                         backend=backend, mesh=mesh)
