"""Device-resident particle storage.

The analogue of the reference's GPU vertex buffers (reference:
src/topsy/particle_buffers.py, split_buffers.py): positions+smoothing,
channel values and cell ids live in HBM, uploaded once (values lazily
re-uploaded when the selected quantity changes).  There is no buffer-size
splitting — XLA manages HBM — but arrays are padded to a group multiple so
the splatter never re-pads, and dynamic LOD ranges are realized as
``dynamic_slice`` + masking over static "bucket" sizes so each bucket
compiles exactly once (the analogue of the reference's indirect-draw-buffer
trick, reference: particle_buffers.py:27-46).
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np

from ..loaders import AbstractDataLoader

logger = logging.getLogger(__name__)

PAD_MULTIPLE = 512
MIN_BUCKET = 4096
MAX_BUCKET = 1 << 22
# per-launch particle cap: larger blocks are rendered in bucket-sized pieces
# by the render loop, which bounds each launch's intermediates (the sort
# operands, the per-group window arrays) and the number of compiled sizes.


def bucket_size(n: int, n_max: int) -> int:
    """Smallest power-of-two bucket >= n, in [MIN_BUCKET, min(n_max, MAX_BUCKET)]."""
    b = MIN_BUCKET
    while b < n and b < MAX_BUCKET:
        b *= 2
    return min(b, n_max, MAX_BUCKET)


class ParticleStore:
    """Uploads and owns the device particle arrays for one loader."""

    def __init__(self, data_loader: AbstractDataLoader, device=None):
        self._loader = data_loader
        self._device = device
        self.n = len(data_loader)
        self.n_pad = max(MIN_BUCKET,
                         ((self.n + PAD_MULTIPLE - 1) // PAD_MULTIPLE) * PAD_MULTIPLE)
        self._quantity_name: str | None = None
        self.values_version = 0  # bumped whenever channel buffers change

        dev = data_loader.device_arrays()
        if dev is not None:
            # device-resident loader (loaders.AbstractDataLoader
            # .device_arrays): adopt the arrays in place — no host upload
            self._dev_quantities = dict(dev.get("quantities", {}))
            self.pos_smooth = self._pad_dev(
                jnp.asarray(dev["pos_smooth"], jnp.float32))
            self._mass = None  # device path: host mass never materialized
            self._mass_dev = self._pad_dev(
                jnp.asarray(dev["mass"], jnp.float32))
            self.mass_and_quantity = jnp.stack(
                [self._mass_dev, jnp.zeros_like(self._mass_dev)], axis=1)
        else:
            self._dev_quantities = None
            self._mass_dev = None
            pos_smooth = data_loader.get_pos_smooth()
            self.pos_smooth = self._put(self._pad(pos_smooth))

            self._mass = data_loader.get_mass().astype(np.float32)
            # the quantity column is zeros until a quantity is selected —
            # built on device so only the mass bytes cross the upload path
            m = self._put(self._pad(self._mass))
            self.mass_and_quantity = jnp.stack([m, jnp.zeros_like(m)],
                                               axis=1)
        self._rgb = None

        cell_ids = data_loader.get_cell_ids()
        if cell_ids is None:
            # no spatial index: a single cell — synthesized on device (a
            # host zeros array would ship n*4 bytes over the upload path)
            self.n_cells = 1
            self.cell_ids = jnp.zeros(self.n_pad, dtype=jnp.int32)
            if self._device is not None:
                self.cell_ids = jax.device_put(self.cell_ids, self._device)
        else:
            self.n_cells = int(cell_ids.max()) + 1 if len(cell_ids) else 1
            self.cell_ids = self._put(self._pad(cell_ids.astype(np.int32)))
        self._all_cells_mask = self._put(np.ones(self.n_cells, dtype=bool))

    def _pad(self, arr: np.ndarray) -> np.ndarray:
        pad = self.n_pad - len(arr)
        if pad == 0:
            return arr
        return np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])

    def _pad_dev(self, arr):
        """Zero-pad a device array to n_pad rows without a host round trip."""
        pad = self.n_pad - arr.shape[0]
        if pad == 0:
            return arr
        return jnp.concatenate(
            [arr, jnp.zeros((pad,) + arr.shape[1:], arr.dtype)])

    def _put(self, arr: np.ndarray):
        return jax.device_put(arr, self._device)

    # -- channel buffers -------------------------------------------------------

    @property
    def quantity_name(self) -> str | None:
        return self._quantity_name

    @quantity_name.setter
    def quantity_name(self, name: str | None):
        """Lazily rebuild the (mass, mass*quantity) channel buffer
        (reference: particle_buffers.py:93-102)."""
        if name == self._quantity_name:
            return
        if self._mass_dev is not None:
            m = self._mass_dev
            if name is None:
                q = jnp.zeros_like(m)
            else:
                q = m * self._pad_dev(jnp.asarray(
                    self._dev_quantities[name], jnp.float32))
            self.mass_and_quantity = jnp.stack([m, q], axis=1)
        elif name is None:
            m = self._put(self._pad(self._mass))
            self.mass_and_quantity = jnp.stack([m, jnp.zeros_like(m)],
                                               axis=1)
        else:
            qty = self._loader.get_named_quantity(name).astype(np.float32)
            mq = np.stack([self._mass, self._mass * qty], axis=1)
            self.mass_and_quantity = self._put(self._pad(mq))
        self._quantity_name = name
        self._surface_values = None
        self.values_version += 1
        logger.info("Rebuilt quantity channel buffer for %r", name)

    @property
    def rgb(self):
        if self._rgb is None:
            self._rgb = self._put(self._pad(
                self._loader.get_rgb_masses().astype(np.float32)))
        return self._rgb

    def values_for(self, buffer_name: str):
        if buffer_name == "mass_and_quantity":
            return self.mass_and_quantity
        if buffer_name == "surface_values":
            return self.surface_values
        if buffer_name == "rgb":
            return self.rgb
        raise KeyError(buffer_name)

    @property
    def surface_values(self):
        """(mass, raw quantity) channels for the z-buffered surface mode.

        The surface winner displays the particle's quantity itself
        (reference: shaders/sph.wgsl vertex_depth_with_cut forwards
        input.quantities.y untouched), unlike the additive modes' weighted
        (mass, mass*quantity) — built lazily, invalidated on quantity
        switch."""
        if getattr(self, "_surface_values", None) is None:
            name = self._quantity_name
            if self._mass_dev is not None:
                m = self._mass_dev
                q = (jnp.zeros_like(m) if name is None
                     else self._pad_dev(jnp.asarray(
                         self._dev_quantities[name], jnp.float32)))
                self._surface_values = jnp.stack([m, q], axis=1)
            else:
                m = self._pad(self._mass)
                q = (np.zeros_like(m) if name is None
                     else self._pad(self._loader.get_named_quantity(name)
                                    .astype(np.float32)))
                self._surface_values = self._put(np.stack([m, q], axis=1))
        return self._surface_values

    # -- presorted (bucket, Morton) copies for sort-free full renders ----------

    def ensure_presorted(self):
        """Lazily build the static (smoothing-bucket, Morton) ordering used
        by sort-free EXPORT renders.  Built ON DEVICE (ops/morton_device.py:
        a handful of lax.sorts + cumulative passes, ~0.3 s at 2^24) with the
        host numpy path (ops/morton.py) as fallback; cached per snapshot."""
        if getattr(self, "_presorted_layout", None) is not None:
            return
        from ..ops import morton, morton_device
        # the positions already live on device (padded with zero rows the
        # builder masks via n_real) — never re-upload them
        layout = morton_device.build_presorted_device(self.pos_smooth,
                                                      n_real=self.n)
        if layout is None:
            ps = self._loader.get_pos_smooth().astype(np.float32)
            layout = morton.build_presorted(ps)
        self._presorted_layout = layout
        self.n_presorted = layout.n_out
        if isinstance(layout, morton_device.DevicePresortedLayout):
            # the (n_out, 4) copy is built lazily (see pos_smooth_presorted)
            self._pos_smooth_presorted = None
            self.presorted_buckets = layout.buckets
            self.cell_ids_presorted = layout.apply(self.cell_ids)
        else:
            self._pos_smooth_presorted = self._put(
                layout.apply(ps, fill=morton.PAD_POS))
            self.presorted_buckets = self._put(layout.buckets)
            self.cell_ids_presorted = self._put(
                layout.apply(np.asarray(self.cell_ids[:self.n])
                             .astype(np.int32)))
        self._presorted_values = {}
        logger.info("Built presorted (bucket, Morton) order: %d -> %d slots",
                    self.n, self.n_presorted)

    @property
    def presorted_layout(self):
        """The cached PresortedLayout (call ensure_presorted() first)."""
        return self._presorted_layout

    @property
    def pos_smooth_presorted(self):
        """(n_out, 4) presorted positions, materialized on first use."""
        p = self._pos_smooth_presorted
        if p is None:
            from ..ops import morton
            p = self._presorted_layout.apply(self.pos_smooth,
                                             fill=morton.PAD_POS)
            self._pos_smooth_presorted = p
        return p

    def presorted_values_for(self, buffer_name: str):
        """Presorted copy of a channel buffer, cached per values_version."""
        self.ensure_presorted()
        key = (buffer_name, self.values_version)
        cached = self._presorted_values.get(key)
        if cached is None:
            from ..ops import morton_device
            layout = self._presorted_layout
            if isinstance(layout, morton_device.DevicePresortedLayout):
                # device-side permute: no host round trip
                cached = layout.apply(self.values_for(buffer_name))
            else:
                vals = np.asarray(self.values_for(buffer_name))[:self.n]
                cached = self._put(layout.apply(vals))
            self._presorted_values = {key: cached}
        return cached

    # -- giant-splat candidate pool (static per layout; ops/splat_giant.py) ----

    def giant_meta(self):
        """Static giant candidate metadata (slots, slot buckets, bucket
        histogram): the last min(CAP, n_real) real slots of the presorted
        layout — the largest smoothing buckets (see
        ops/splat_giant.candidate_slots).  Host numpy, once per layout."""
        self.ensure_presorted()
        meta = getattr(self, "_giant_meta", None)
        if meta is None:
            from ..ops import splat_giant
            meta = splat_giant.candidate_slots(self._presorted_layout)
            self._giant_meta = meta
        return meta

    def _gather_presorted_rows(self, arr, slots_d, fill: float):
        """Rows of a presorted-order view of ``arr`` (original order,
        length >= n) at the given slots — without materializing the full
        (n_out, ...) presorted copy."""
        from ..ops import morton_device
        layout = self._presorted_layout
        if isinstance(layout, morton_device.DevicePresortedLayout):
            src = jnp.take(layout.gidx, slots_d)
            base = jnp.concatenate(
                [jnp.asarray(arr)[:layout.n_real],
                 jnp.full((1,) + arr.shape[1:], fill, arr.dtype)])
            return jnp.take(base, jnp.minimum(src, layout.n_real), axis=0)
        # host layout: candidate slots are real by construction, and the
        # full presorted copy already exists
        if arr is self.pos_smooth:
            return jnp.take(self.pos_smooth_presorted, slots_d, axis=0)
        full = layout.apply(np.asarray(arr)[:self.n], fill=fill)
        return jnp.take(self._put(full), slots_d, axis=0)

    def giant_candidates(self, size: int):
        """Gathered arrays for the dense giant pass over the last ``size``
        candidate slots: dict(pos (size, 4), buckets (size,), cell_ids
        (size,)).  Cached per size (sizes are the power-of-two plan steps,
        ops/splat_giant.plan_sizes, so a handful of variants exist)."""
        from ..ops import morton
        cache = getattr(self, "_giant_candidates", None)
        if cache is None:
            cache = self._giant_candidates = {}
        got = cache.get(size)
        if got is None:
            slots, buckets = self.giant_meta()[:2]
            sl = jnp.asarray(slots[len(slots) - size:], jnp.int32)
            got = dict(
                pos=self._gather_presorted_rows(self.pos_smooth, sl,
                                                morton.PAD_POS),
                buckets=jnp.asarray(buckets[len(buckets) - size:]),
                cell_ids=jnp.take(jnp.asarray(self.cell_ids_presorted), sl))
            cache[size] = got
        return got

    def giant_values_for(self, buffer_name: str, size: int):
        """(size, C) candidate channel values, cached per values_version."""
        cache = getattr(self, "_giant_values", None)
        if cache is None:
            cache = self._giant_values = {}
        key = (buffer_name, size, self.values_version)
        got = cache.get(key)
        if got is None:
            slots = self.giant_meta()[0]
            sl = jnp.asarray(slots[len(slots) - size:], jnp.int32)
            got = jnp.take(self.presorted_values_for(buffer_name), sl,
                           axis=0)
            # insert (alternating buffer/size lookups must all stay warm);
            # evict only entries from superseded values versions
            for k in [k for k in cache if k[2] != self.values_version]:
                del cache[k]
            cache[key] = got
        return got

    # -- decimation-mip tiers for interactive LOD below the 1/8 floor ----------

    def ensure_column_mips(self) -> list["PresortedMipTier"]:
        """Lazily build the chain of decimation-mip tiers (deepest first).

        Each tier is a presorted layout over the particles in the first
        min_slice_width columns of its parent — a spatially fair 1/8
        subsample (ops/morton_device.build_mip_layout).  Tiers are chained
        until the smallest interactive column block drops below
        config.COLUMN_MIP_FLOOR_TARGET, bounding per-frame work at
        100M-particle scale (the sort-free column floor is otherwise 1/8
        of the snapshot)."""
        tiers = getattr(self, "_mip_tiers", None)
        if tiers is not None:
            return tiers
        from .. import config
        from ..ops import morton, morton_device
        self.ensure_presorted()
        tiers = []
        layout = self._presorted_layout
        if isinstance(layout, morton_device.DevicePresortedLayout):
            while len(tiers) < config.COLUMN_MIP_MAX_TIERS:
                w = morton.min_slice_width(layout)
                floor = int(layout.real_per_column[:w].sum()) if w < layout.pad_group \
                    else int(layout.real_per_column.sum())
                if floor <= config.COLUMN_MIP_FLOOR_TARGET:
                    break
                mip = morton_device.build_mip_layout(layout, self.pos_smooth)
                if mip is None:
                    break
                tiers.insert(0, PresortedMipTier(self, mip))
                logger.info("Built column-mip tier %d: %d real particles",
                            len(tiers), int(mip.real_per_column.sum()))
                layout = mip
        self._mip_tiers = tiers
        return tiers

    def cell_mask_table(self, selected_mask: np.ndarray | None):
        """Device bool table over cells (True = render), for geometric culling."""
        if selected_mask is None:
            return self._all_cells_mask
        return self._put(np.asarray(selected_mask, dtype=bool))


class PresortedMipTier:
    """Device arrays for one decimation tier: the same presorted-array
    surface as the store's main presorted path, built from a mip
    DevicePresortedLayout whose gidx composes to the ORIGINAL arrays."""

    def __init__(self, store: ParticleStore, layout):
        self._store = store
        self.layout = layout
        self.n_out = layout.n_out
        self._pos_smooth = None
        self._cell_ids = None
        self._values = {}

    @property
    def buckets(self):
        return self.layout.buckets

    @property
    def pos_smooth(self):
        if self._pos_smooth is None:
            from ..ops import morton
            self._pos_smooth = self.layout.apply(self._store.pos_smooth,
                                                 fill=morton.PAD_POS)
        return self._pos_smooth

    @property
    def cell_ids(self):
        if self._cell_ids is None:
            self._cell_ids = self.layout.apply(self._store.cell_ids)
        return self._cell_ids

    def values_for(self, buffer_name: str):
        key = (buffer_name, self._store.values_version)
        cached = self._values.get(key)
        if cached is None:
            cached = self.layout.apply(self._store.values_for(buffer_name))
            self._values = {key: cached}
        return cached
