"""Multi-chip rendering: particle-sharded splatting with a framebuffer
all-reduce.

The reference is single-GPU; its particle-axis scaling constructs (split
buffers, chunked export calls — reference: src/topsy/split_buffers.py,
config.py:18-25) map here onto *data parallelism over particles*
(SURVEY.md §2.10): each chip splats its particle shard into a full-resolution
partial framebuffer, and because the blending is order-independent additive,
``psum`` over the mesh reproduces the single-chip image exactly.

Particles are sharded **round-robin over the interleaved LOD order**
(``strided_shard``): device d owns global indices i with i % D == d, so any
progressive-LOD prefix [0, K) stays load-balanced across chips AND maps to a
*contiguous local prefix* on every shard — the same bucketed dynamic-slice
trick as the single-chip store works per shard, with only the LOD mask
translated to global indices.

Multi-host note: each host builds its process-local rows (global indices
i with (i % D) owned by its local devices) and assembles the global array
with ``jax.make_array_from_process_local_data`` using the same
NamedSharding; the render step is unchanged (the host network is touched
only at load).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import splat_atlas, splat_giant



def strided_shard(arr: np.ndarray, n_devices: int) -> np.ndarray:
    """Rearrange (N, ...) into (D, ceil(N/D), ...) with round-robin rows:
    out[d, j] = arr[j * D + d]; padded with zeros."""
    n = len(arr)
    per = -(-n // n_devices)
    padded = np.zeros((per * n_devices,) + arr.shape[1:], dtype=arr.dtype)
    padded[:n] = arr
    return np.ascontiguousarray(
        padded.reshape(per, n_devices, *arr.shape[1:]).swapaxes(0, 1))


def unstride(arr: np.ndarray) -> np.ndarray:
    """Inverse of strided_shard (up to padding)."""
    d, per = arr.shape[:2]
    return arr.swapaxes(0, 1).reshape(d * per, *arr.shape[2:])


def _giant_mode(giant_bucket):
    """Resolve the raw-API giant contract to (auto: bool, gb_thresh).

    ``giant_bucket`` is uniform across render()/render_presorted()/
    render_columns(): ``None`` (default) renders giants exactly in-call on
    each shard (splat_atlas giants='auto'; each particle lives on exactly
    one shard, so the psum of per-shard exact layers is exact) — the same
    default as the sorted render() path; the string ``'none'`` keeps the
    truncated windowed deposit (A/B tests); an integer smoothing-bucket
    threshold excludes giants from the windowed deposit and renders nothing
    for them — the caller owns one dense exact layer per frame
    (render/sph._prepare_giants, the product renderers' contract)."""
    if giant_bucket is None:
        return True, jnp.int32(splat_giant.BUCKET_DISABLED)
    if isinstance(giant_bucket, str):
        if giant_bucket != "none":
            raise ValueError(f"giant_bucket {giant_bucket!r} invalid "
                             "(None, 'none', or a bucket threshold)")
        return False, jnp.int32(splat_giant.BUCKET_DISABLED)
    return False, jnp.int32(giant_bucket)


def local_bucket_size(count_hint: int, local_n: int) -> int:
    """Power-of-two local bucket covering a global range on one shard."""
    from ..render.store import MAX_BUCKET, MIN_BUCKET
    b = MIN_BUCKET
    while b < count_hint and b < MAX_BUCKET:
        b *= 2
    return min(b, local_n, MAX_BUCKET)


class DistributedSplatter:
    """Owns particle shards on a mesh and a jitted sharded render step.

    Supports the full renderer contract: LOD prefix ranges (bucketed
    locally), per-cell geometric culling, and the optional depth channel.
    """

    @classmethod
    def from_process_local(cls, mesh: Mesh, local_pos_smooth: np.ndarray,
                           local_values: np.ndarray, resolution: int,
                           global_n: int, **kwargs) -> "DistributedSplatter":
        """Multi-host construction: each process supplies the rows owned by
        its local devices (global indices i with i % D giving a local
        device, already padded to n_local_devices * ceil(global_n / D)
        rows), assembled with jax.make_array_from_process_local_data so no
        host ever materializes the full snapshot.  The host network is
        touched only here; the render step's psum stays between devices.

        Pass ``n_cells`` explicitly when cell culling is used — the local
        rows only see a subset of cells, so the constructor must not infer
        the global count from them.  The sort-free presorted paths remain
        available: each process later builds the (bucket, Morton) layout of
        its OWN rows (see ensure_presorted), which is exact for the additive
        render because per-process layouts permute disjoint subsets.
        """
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        self = cls.__new__(cls)
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.n_devices = int(mesh.shape[self.axis])
        self.resolution = resolution
        self.n = global_n
        self.local_n = -(-global_n // self.n_devices)
        self._depth_channel = kwargs.get("depth_channel", False)
        self._backend = kwargs.get("backend", "atlas")
        sharding = NamedSharding(mesh, P(self.axis))
        n_local_dev = len([d for d in mesh.devices.flat
                           if d.process_index == jax.process_index()])
        local_pos_smooth = np.asarray(local_pos_smooth, np.float32)
        local_values = np.asarray(local_values, np.float32)
        shape4 = (self.n_devices, self.local_n, 4)
        shapeC = (self.n_devices, self.local_n, local_values.shape[-1])
        self.pos_smooth = jax.make_array_from_process_local_data(
            sharding, local_pos_smooth.reshape(n_local_dev, self.local_n, 4),
            shape4)
        self.values = jax.make_array_from_process_local_data(
            sharding, local_values.reshape(n_local_dev, self.local_n, -1),
            shapeC)
        cell_ids = kwargs.get("cell_ids")
        if cell_ids is None:
            self.n_cells = kwargs.get("n_cells", 1)
            cell_ids = np.zeros(n_local_dev * self.local_n, dtype=np.int32)
        else:
            cell_ids = np.asarray(cell_ids, np.int32)
            self.n_cells = kwargs.get(
                "n_cells",
                int(cell_ids.max()) + 1 if cell_ids.size else 1)
        self.cell_ids = jax.make_array_from_process_local_data(
            sharding, cell_ids.reshape(n_local_dev, self.local_n),
            (self.n_devices, self.local_n))
        self._all_cells = jnp.ones((self.n_cells,), dtype=bool)
        self._steps = {}
        # presorted state: the full-snapshot host arrays never exist here;
        # the per-process rows take their place (ensure_presorted)
        self._host_pos_smooth = None
        self._host_values = None
        self._host_cell_ids = None
        self._local_pos_smooth = local_pos_smooth
        self._local_values = local_values
        self._local_cell_ids = cell_ids
        self._n_local_dev = n_local_dev
        self._presorted = None
        self._presorted_steps = {}
        self._column_steps = {}
        return self

    def __init__(self, mesh: Mesh, pos_smooth: np.ndarray, values: np.ndarray,
                 resolution: int, cell_ids: np.ndarray | None = None,
                 backend: str = "atlas", depth_channel: bool = False):
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.n_devices = int(mesh.shape[self.axis])
        self.resolution = resolution
        self.n = len(pos_smooth)
        self.local_n = -(-self.n // self.n_devices)
        self._depth_channel = depth_channel
        self._backend = backend
        # host copies kept for the lazily-built presorted (sort-free) layout
        self._host_pos_smooth = np.asarray(pos_smooth, np.float32)
        self._host_values = np.asarray(values, np.float32)
        self._host_cell_ids = (np.asarray(cell_ids, np.int32)
                               if cell_ids is not None else None)
        self._presorted = None
        self._presorted_steps: dict[int, object] = {}
        self._column_steps: dict[int, object] = {}

        sharding = NamedSharding(mesh, P(self.axis))
        self.pos_smooth = jax.device_put(
            strided_shard(np.asarray(pos_smooth, np.float32), self.n_devices),
            sharding)
        self.values = jax.device_put(
            strided_shard(np.asarray(values, np.float32), self.n_devices),
            sharding)
        if cell_ids is None:
            cell_ids = np.zeros(self.n, dtype=np.int32)
        self.n_cells = int(cell_ids.max()) + 1 if len(cell_ids) else 1
        self.cell_ids = jax.device_put(
            strided_shard(np.asarray(cell_ids, np.int32), self.n_devices),
            sharding)
        self._all_cells = jnp.ones((self.n_cells,), dtype=bool)
        self._steps: dict[int, object] = {}

    def _build_step(self, bucket: int):
        axis = self.axis
        resolution = self.resolution
        depth_channel = self._depth_channel
        n_dev = self.n_devices
        local_n = self.local_n
        C = int(self.values.shape[-1])

        def local_render(pos, vals, ids, cell_table, matrix, scale,
                         start, count):
            pos = pos[0]
            vals = vals[0]
            ids = ids[0]
            d = jax.lax.axis_index(axis).astype(jnp.int32)
            # global range [start, start+count) covers local indices
            # [ceil((start-d)/D), ...): slice a bucket around it
            lstart = (start - d + n_dev - 1) // n_dev
            sl = jnp.clip(lstart, 0, local_n - bucket)
            p = jax.lax.dynamic_slice(pos, (sl, 0), (bucket, 4))
            v = jax.lax.dynamic_slice(vals, (sl, 0), (bucket, C))
            cid = jax.lax.dynamic_slice(ids, (sl,), (bucket,))
            gidx = (sl + jnp.arange(bucket, dtype=jnp.int32)) * n_dev + d
            mask = (gidx >= start) & (gidx < start + count) & cell_table[cid]
            im, _ = splat_atlas.splat_atlas(p, v, matrix, resolution,
                                            scale, extra_mask=mask,
                                            depth_channel=depth_channel)
            # additive blending is exactly a sum-reduction: the partial
            # framebuffer all-reduce reproduces single-chip output
            return jax.lax.psum(im, axis)

        shard_fn = jax.shard_map(
            local_render, mesh=self.mesh,
            in_specs=(P(self.axis), P(self.axis), P(self.axis), P(), P(), P(),
                      P(), P()),
            out_specs=P(),
            check_vma=False)
        return jax.jit(shard_fn)

    # -- presorted (sort-free) full renders ------------------------------------

    def supports_presorted(self) -> bool:
        """True for single-host construction (global host arrays kept) AND
        for from_process_local (each process presorts its own rows; with
        more than one process ensure_presorted negotiates the shared
        ``padded_local_len`` automatically via an allgather-max, so the
        automatic render paths work unmodified across hosts).

        False only when construction kept no host rows at all — then the
        fast paths fall back to the unsorted block renderer, loudly
        (_warn_presorted_unavailable)."""
        if self.has_presorted():
            return True
        return (getattr(self, "_host_pos_smooth", None) is not None
                or getattr(self, "_local_pos_smooth", None) is not None)

    def _warn_presorted_unavailable(self, what: str):
        """One-shot warning when a fast path silently drops to the unsorted
        block renderer (an order-of-magnitude throughput loss at scale must
        never be silent — SURVEY §2.10 row 8)."""
        if getattr(self, "_warned_presorted", False):
            return
        self._warned_presorted = True
        import logging
        logging.getLogger(__name__).warning(
            "presorted Morton slabs unavailable (construction kept no host "
            "rows): %s falls back to the unsorted block renderer "
            "(~10x slower at scale)", what)

    def has_presorted(self) -> bool:
        return getattr(self, "_presorted", None) is not None

    def ensure_presorted(self, padded_local_len: int | None = None):
        """Shard the static (bucket, Morton) order (ops/morton.py) as
        contiguous per-device slabs.  Morton slabs are spatially coherent, so
        each shard's groups stay window-local without any per-frame sort;
        the framebuffer psum is unchanged.

        Single-host: one global layout, cut into contiguous slabs.
        Process-local: each process presorts its OWN rows and contributes
        them via jax.make_array_from_process_local_data — exact, because
        the blend is additive over disjoint subsets, and column slices stay
        fair subsamples (the per-group shuffle is per-layout but every
        layout's columns are fair).  With more than one process the padded
        per-device length is data-dependent per host; it is negotiated
        automatically (allgather-max of the natural lengths across hosts,
        _negotiate_padded_len) — ``padded_local_len`` remains available to
        skip the collective when callers already agreed on a length.
        """
        if self._presorted is not None:
            return
        if (self._host_pos_smooth is None
                and getattr(self, "_local_pos_smooth", None) is None):
            return  # construction kept no host rows; nothing to presort
        from ..ops import morton
        sharding = NamedSharding(self.mesh, P(self.axis))

        if self._host_pos_smooth is not None:
            from ..ops import morton_device
            cell_ids = (self._host_cell_ids
                        if self._host_cell_ids is not None
                        else np.zeros(self.n, dtype=np.int32))
            # build on the default device (ops/morton_device.py), then
            # reshard contiguous Morton slabs over the mesh — the host
            # numpy build costs minutes at >= 2^24 on slow hosts.  Each
            # source array crosses the upload path exactly once (reused
            # for the build, the apply and the mip tiers).
            ps_dev = jnp.asarray(self._host_pos_smooth)
            dlayout = morton_device.build_presorted_device(
                ps_dev, pad_total=4096 * self.n_devices)
            if dlayout is not None:
                vals_dev = jnp.asarray(self._host_values)
                cid_dev = jnp.asarray(cell_ids.astype(np.int32))

                def slab_dev(applied, ln):
                    return jax.device_put(
                        applied.reshape(self.n_devices, ln,
                                        *applied.shape[1:]), sharding)

                def tier_dict(layout):
                    ln = layout.n_out // self.n_devices
                    return dict(
                        local_n=ln,
                        layout=layout,
                        pos=slab_dev(layout.apply(ps_dev,
                                                  fill=morton.PAD_POS), ln),
                        values=slab_dev(layout.apply(vals_dev), ln),
                        buckets=slab_dev(layout.buckets, ln),
                        cell_ids=slab_dev(layout.apply(cid_dev), ln),
                    )

                self._presorted = tier_dict(dlayout)
                self._presorted["mips"] = self._build_mesh_mips(
                    dlayout, ps_dev, tier_dict)
                return
            layout = morton.build_presorted(self._host_pos_smooth,
                                            pad_total=4096 * self.n_devices)
            ln = layout.n_out // self.n_devices

            def slab(arr):
                return jax.device_put(
                    arr.reshape(self.n_devices, ln, *arr.shape[1:]),
                    sharding)

            self._presorted = dict(
                local_n=ln,
                layout=layout,
                pos=slab(layout.apply(self._host_pos_smooth,
                                      fill=morton.PAD_POS)),
                values=slab(layout.apply(self._host_values)),
                buckets=slab(layout.buckets),
                cell_ids=slab(layout.apply(cell_ids)),
            )
            return

        # -- process-local rows: per-process layout ------------------------
        nl_dev = self._n_local_dev
        layout = morton.build_presorted(self._local_pos_smooth,
                                        pad_total=4096 * nl_dev)
        natural = layout.n_out // nl_dev
        if padded_local_len is None:
            if jax.process_count() > 1:
                padded_local_len = self._negotiate_padded_len(natural)
        if padded_local_len is None:
            ln = natural
        else:
            if padded_local_len < natural or padded_local_len % 4096:
                raise ValueError(
                    f"padded_local_len {padded_local_len} invalid "
                    f"(needs multiple of 4096 >= {natural})")
            ln = padded_local_len
        extra = ln * nl_dev - layout.n_out

        def slab(applied, fill):
            if extra:
                tail = np.full((extra,) + applied.shape[1:], fill,
                               applied.dtype)
                applied = np.concatenate([applied, tail])
            local = applied.reshape(nl_dev, ln, *applied.shape[1:])
            return jax.make_array_from_process_local_data(
                sharding, local,
                (self.n_devices, ln) + applied.shape[1:])

        cell_ids = (self._local_cell_ids
                    if self._local_cell_ids is not None
                    else np.zeros(len(self._local_pos_smooth),
                                  dtype=np.int32))

        def local_tier_dict(lay, tier_ln):
            extra_t = tier_ln * nl_dev - lay.n_out

            def slab_t(applied, fill):
                if extra_t:
                    tail = np.full((extra_t,) + applied.shape[1:], fill,
                                   applied.dtype)
                    applied = np.concatenate([applied, tail])
                local = applied.reshape(nl_dev, tier_ln,
                                        *applied.shape[1:])
                return jax.make_array_from_process_local_data(
                    sharding, local,
                    (self.n_devices, tier_ln) + applied.shape[1:])

            return dict(
                local_n=tier_ln,
                layout=lay,
                pos=slab_t(lay.apply(self._local_pos_smooth,
                                     fill=morton.PAD_POS), morton.PAD_POS),
                values=slab_t(lay.apply(self._local_values), 0.0),
                buckets=slab_t(lay.buckets, 0),
                cell_ids=slab_t(lay.apply(cell_ids), 0),
            )

        self._presorted = local_tier_dict(layout, ln)
        # decimation-mip tiers for the multi-host path: each process
        # builds a host mip over its own slab (ops/morton.build_mip_host)
        # and the per-tier slab lengths are negotiated like the main one;
        # a tier exists only if EVERY host could build it and at least one
        # wants it (all-or-nothing, agreed collectively below)
        from .. import config as _config
        mips = []
        lay = layout
        while len(mips) < _config.COLUMN_MIP_MAX_TIERS:
            w = morton.min_slice_width(lay)
            floor = (int(lay.real_per_column[:w].sum())
                     if w < lay.pad_group
                     else int(lay.real_per_column.sum()))
            want = floor > _config.COLUMN_MIP_FLOOR_TARGET * nl_dev
            # every host attempts the build so the group decision below
            # can require all of them; local floors differ across hosts,
            # so the decision MUST be collective — a host-local break here
            # would desynchronize the negotiation collectives and hang
            mip = morton.build_mip_host(lay, self._local_pos_smooth,
                                        pad_total=4096 * nl_dev)
            if jax.process_count() > 1:
                from jax.experimental import multihost_utils
                flags = multihost_utils.process_allgather(np.asarray(
                    [int(want), int(mip is not None)], dtype=np.int64))
                proceed = bool(flags[:, 0].max()) and bool(
                    flags[:, 1].min())
            else:
                proceed = want and mip is not None
            if not proceed:
                break
            nat_m = mip.n_out // nl_dev
            if jax.process_count() > 1:
                ln_m = self._negotiate_padded_len(nat_m)
            else:
                ln_m = nat_m
            mips.insert(0, local_tier_dict(mip, ln_m))
            lay = mip
        self._presorted["mips"] = mips

    @staticmethod
    def _negotiate_padded_len(natural: int) -> int:
        """Allgather-max of this process's natural per-device slab length.

        Every host must build identically-shaped slabs for
        make_array_from_process_local_data; the natural lengths are
        data-dependent per host, so agree on their maximum across hosts
        (jax.experimental.multihost_utils — one tiny collective at load
        time; render steps need no host collective).  Lengths are
        multiples of 4096 by construction, so the max stays valid."""
        from jax.experimental import multihost_utils
        lens = multihost_utils.process_allgather(
            np.asarray(natural, dtype=np.int64))
        return int(np.max(lens))

    def _build_mesh_mips(self, dlayout, ps_dev, tier_dict) -> list:
        """Decimation-mip tiers for the mesh column path (the multi-chip
        analogue of store.ensure_column_mips): chained presorted layouts
        over the parent's floor columns, slabbed over the mesh exactly like
        the main arrays.  The per-chip CHANGE-frame floor is 1/(8D) of the
        snapshot without tiers, so tiers engage only when even that exceeds
        COLUMN_MIP_FLOOR_TARGET per chip (i.e. >~10^9 particles on 8
        chips)."""
        from .. import config
        from ..ops import morton, morton_device
        mips = []  # deepest first, as the tiered progression indexes them
        layout = dlayout
        while len(mips) < config.COLUMN_MIP_MAX_TIERS:
            w = morton.min_slice_width(layout)
            floor = (int(layout.real_per_column[:w].sum())
                     if w < layout.pad_group
                     else int(layout.real_per_column.sum()))
            if floor <= config.COLUMN_MIP_FLOOR_TARGET * self.n_devices:
                break
            mip = morton_device.build_mip_layout(
                layout, ps_dev, pad_total=4096 * self.n_devices)
            if mip is None:
                break
            mips.insert(0, tier_dict(mip))
            layout = mip
        return mips

    def presorted_mip_layouts(self) -> list:
        """Mip-tier layouts, deepest first (the progression's tier order) —
        [] when no tiers were built or slabs are unavailable."""
        if not self.supports_presorted():
            self._warn_presorted_unavailable("decimation-mip tiers")
            return []
        self.ensure_presorted()
        if not self._presorted:
            return []
        return [m["layout"] for m in self._presorted.get("mips", [])]

    def _tier(self, tier: int | None) -> dict:
        """The presorted dict for a tier index (None = the main layout;
        otherwise an index into the deepest-first mips list)."""
        if tier is None:
            return self._presorted
        return self._presorted.get("mips", [])[tier]

    def _build_presorted_step(self, bucket: int, auto_giants: bool):
        axis = self.axis
        resolution = self.resolution
        depth_channel = self._depth_channel
        local_n = self._presorted["local_n"]
        C = int(self.values.shape[-1])

        def local_render(pos, vals, buckets, ids, cell_table, matrix, scale,
                         start, count, gb_thresh):
            pos, vals, buckets, ids = pos[0], vals[0], buckets[0], ids[0]
            sl = jnp.clip(start, 0, local_n - bucket)
            p = jax.lax.dynamic_slice(pos, (sl, 0), (bucket, 4))
            v = jax.lax.dynamic_slice(vals, (sl, 0), (bucket, C))
            b = jax.lax.dynamic_slice(buckets, (sl,), (bucket,))
            cid = jax.lax.dynamic_slice(ids, (sl,), (bucket,))
            idx = sl + jnp.arange(bucket, dtype=jnp.int32)
            mask = (idx >= start) & (idx < start + count) & cell_table[cid]
            im, dropped = splat_atlas.splat_atlas(
                p, v, matrix, resolution, scale, extra_mask=mask,
                depth_channel=depth_channel, presorted_buckets=b,
                giants="auto" if auto_giants else gb_thresh)
            return jax.lax.psum(im, axis), jax.lax.psum(dropped, axis)

        shard_fn = jax.shard_map(
            local_render, mesh=self.mesh,
            in_specs=(P(self.axis), P(self.axis), P(self.axis), P(self.axis),
                      P(), P(), P(), P(), P(), P()),
            out_specs=(P(), P()),
            check_vma=False)
        return jax.jit(shard_fn)

    @property
    def presorted_layout(self):
        """The PresortedLayout backing the slabs (after ensure_presorted);
        None when construction kept no host rows to presort."""
        if not self.supports_presorted():
            self._warn_presorted_unavailable("presorted_layout")
            return None
        self.ensure_presorted()
        return self._presorted["layout"] if self._presorted else None

    def _build_columns_step(self, width: int, pad_group: int,
                            auto_giants: bool):
        """shard_map step rendering columns [col0, col0+width) of every
        device slab's (groups x pad_group) matrix, psum-reduced — the
        multi-chip analogue of render/sph.py's sort-free column LOD (the
        per-group shuffle is global, so the union over devices of a column
        range is the same fair subsample).  Slab shapes come from the
        operands, so one step per width serves every decimation tier (jit
        re-specializes per shape)."""
        axis = self.axis
        resolution = self.resolution
        depth_channel = self._depth_channel
        C = int(self.values.shape[-1])

        def local_render(pos, vals, buckets, ids, cell_table, matrix, scale,
                         col0, gb_thresh):
            pos, vals, buckets, ids = pos[0], vals[0], buckets[0], ids[0]
            ngr = pos.shape[0] // pad_group
            c0 = jnp.clip(col0, 0, pad_group - width)

            def slice_cols(arr):
                tail = arr.shape[1:]
                a = arr.reshape((ngr, pad_group) + tail)
                start = (0, c0) + (0,) * len(tail)
                return jax.lax.dynamic_slice(
                    a, start, (ngr, width) + tail).reshape(
                    (ngr * width,) + tail)

            if width == pad_group:
                p, v, b, cid = pos, vals, buckets, ids
            else:
                p, v, b, cid = (slice_cols(pos), slice_cols(vals),
                                slice_cols(buckets), slice_cols(ids))
            mask = cell_table[cid]
            # giant handling per _giant_mode; threshold mode matches the
            # single-chip column path (render/sph._render_block_columns):
            # the render loop's dense layer (_prepare_giants) covers the
            # exact giants
            im, dropped = splat_atlas.splat_atlas(
                p, v, matrix, resolution, scale, extra_mask=mask,
                depth_channel=depth_channel, presorted_buckets=b,
                giants="auto" if auto_giants else gb_thresh)
            return jax.lax.psum(im, axis), jax.lax.psum(dropped, axis)

        shard_fn = jax.shard_map(
            local_render, mesh=self.mesh,
            in_specs=(P(self.axis), P(self.axis), P(self.axis), P(self.axis),
                      P(), P(), P(), P(), P()),
            out_specs=(P(), P()),
            check_vma=False)
        return jax.jit(shard_fn)

    def _build_columns_surface_step(self, width: int, pad_group: int):
        """shard_map step for surface (front-most fragment) column renders.

        Each shard z-splats its slab's column slice through the front-most
        atlas engine (ops/zsplat_atlas.py); the cross-mesh reduce is
        an elementwise depth arg-max instead of the additive psum (SURVEY §5
        last bullet; reference z-buffer semantics: src/topsy/sph.py:606-610,
        467-478): ``pmax`` the depth channel, then ``pmax`` the payload
        masked to the shards holding the winning depth (exact float ties
        across shards would pick the larger payload — measure-zero for real
        particle depths).
        """
        from ..ops import zsplat_atlas
        axis = self.axis
        resolution = self.resolution

        def local_render(pos, vals, buckets, ids, cell_table, matrix, scale,
                         cut, col0, gb_thresh):
            pos, vals, buckets, ids = pos[0], vals[0], buckets[0], ids[0]
            ngr = pos.shape[0] // pad_group
            c0 = jnp.clip(col0, 0, pad_group - width)

            def slice_cols(arr):
                tail = arr.shape[1:]
                a = arr.reshape((ngr, pad_group) + tail)
                start = (0, c0) + (0,) * len(tail)
                return jax.lax.dynamic_slice(
                    a, start, (ngr, width) + tail).reshape(
                    (ngr * width,) + tail)

            if width == pad_group:
                p, v, b, cid = pos, vals, buckets, ids
            else:
                p, v, b, cid = (slice_cols(pos), slice_cols(vals),
                                slice_cols(buckets), slice_cols(ids))
            # giants excluded by bucket threshold; the render loop's dense
            # hemisphere layer (surface._prepare_surface_giants) is
            # max-composited in by the caller — same contract, grouping and
            # spill budgets as the single-chip surface column path
            # (render/surface._render_block_columns_surface)
            from .. import config as _config
            im, dropped = zsplat_atlas.zsplat_atlas(
                p, v, matrix, resolution, scale, b, density_cut=cut,
                extra_mask=cell_table[cid], giants=gb_thresh,
                group=None if width == pad_group else width,
                spill_group_cap=4 * _config.SPLAT_SPILL_GROUP_CAP,
                t3_cap=4096)
            depth = im[..., -1]
            dmax = jax.lax.pmax(depth, axis)
            payload = jnp.where((depth == dmax)[..., None], im[..., :-1],
                                -jnp.inf)
            payload = jax.lax.pmax(payload, axis)
            out = jnp.concatenate([payload, dmax[..., None]], axis=-1)
            return out, jax.lax.psum(dropped, axis)

        shard_fn = jax.shard_map(
            local_render, mesh=self.mesh,
            in_specs=(P(self.axis), P(self.axis), P(self.axis), P(self.axis),
                      P(), P(), P(), P(), P(), P()),
            out_specs=(P(), P()),
            check_vma=False)
        return jax.jit(shard_fn)

    def render_columns_surface(self, matrix, scale, density_cut, col0: int,
                               ncols: int, cell_mask=None, tier=None,
                               giant_bucket=None):
        """Front-most surface render of columns [col0, col0+ncols) across
        the mesh; returns (image (res, res, C), dropped).  Pieces combine
        host-side with the same strictly-greater depth compare as the
        single-chip renderer.  ``tier`` selects a decimation-mip tier's
        slabs (deepest first; None = main layout).  ``giant_bucket``: an
        int smoothing-bucket threshold excludes giants for the caller's
        dense hemisphere layer (render/surface._prepare_surface_giants);
        None/'none' keep the truncated/squeezed windowed hemisphere — the
        z-buffered kernel has no in-call exact mode (ops/zsplat_atlas.py)."""
        self.ensure_presorted()
        ps = self._tier(tier)
        layout = ps["layout"]
        table = self._all_cells if cell_mask is None else jnp.asarray(cell_mask)
        steps = getattr(self, "_column_surface_steps", None)
        if steps is None:
            steps = self._column_surface_steps = {}
        gb_thresh = jnp.int32(splat_giant.BUCKET_DISABLED
                              if giant_bucket in (None, "none")
                              else giant_bucket)
        # ONE launch for the whole range (un-merged slices accept any
        # width; launch cost is flat in width)
        step = steps.get(ncols)
        if step is None:
            step = steps[ncols] = \
                self._build_columns_surface_step(ncols, layout.pad_group)
        return step(ps["pos"], ps["values"], ps["buckets"],
                    ps["cell_ids"], table,
                    jnp.asarray(matrix, jnp.float32),
                    jnp.float32(scale), jnp.float32(density_cut),
                    jnp.int32(col0), gb_thresh)

    def render_columns(self, matrix, scale, col0: int, ncols: int,
                       cell_mask=None, tier=None, giant_bucket=None):
        """Render whole columns [col0, col0+ncols) across the mesh,
        decomposed into power-of-two slice widths; returns (image, dropped).
        ``tier`` selects a decimation-mip tier's slabs (deepest first;
        None = main layout).  ``giant_bucket`` follows the uniform raw-API
        contract (_giant_mode): None renders giants exactly in-call like
        render(); an int threshold excludes them for a caller-owned dense
        layer (render/sph._prepare_giants); 'none' keeps the truncated
        deposit."""
        from ..ops.morton import slice_widths
        self.ensure_presorted()
        ps = self._tier(tier)
        layout = ps["layout"]
        table = self._all_cells if cell_mask is None else jnp.asarray(cell_mask)
        auto, gb_thresh = _giant_mode(giant_bucket)
        total = None
        dropped = jnp.int32(0)
        off = 0
        for width in slice_widths(layout):
            while ncols - off >= width:
                key = (width, auto)
                step = self._column_steps.get(key)
                if step is None:
                    step = self._column_steps[key] = \
                        self._build_columns_step(width, layout.pad_group,
                                                 auto)
                im, d = step(ps["pos"], ps["values"], ps["buckets"],
                             ps["cell_ids"], table,
                             jnp.asarray(matrix, jnp.float32),
                             jnp.float32(scale), jnp.int32(col0 + off),
                             gb_thresh)
                total = im if total is None else total + im
                dropped = dropped + d
                off += width
        if off != ncols:
            raise AssertionError(f"unrenderable column range {ncols}")
        return total, dropped

    def render_presorted(self, matrix, scale, cell_mask=None,
                         giant_bucket=None):
        """Full-coverage sort-free render of all particles across the mesh;
        returns (image, dropped).  ``giant_bucket`` as in render_columns."""
        self.ensure_presorted()
        ps = self._presorted
        ln = ps["local_n"]
        bucket = local_bucket_size(ln, ln)
        table = self._all_cells if cell_mask is None else jnp.asarray(cell_mask)
        auto, gb_thresh = _giant_mode(giant_bucket)
        total = None
        dropped = jnp.int32(0)
        for piece in range(0, ln, bucket):
            key = (bucket, auto)
            step = self._presorted_steps.get(key)
            if step is None:
                step = self._presorted_steps[key] = \
                    self._build_presorted_step(bucket, auto)
            im, d = step(ps["pos"], ps["values"], ps["buckets"],
                         ps["cell_ids"], table,
                         jnp.asarray(matrix, jnp.float32), jnp.float32(scale),
                         jnp.int32(piece), jnp.int32(min(bucket, ln - piece)),
                         gb_thresh)
            total = im if total is None else total + im
            dropped = dropped + d
        return total, dropped

    def render(self, matrix, scale, start: int = 0, count: int | None = None,
               cell_mask=None):
        """Render the global LOD range [start, start+count) across the mesh."""
        if count is None:
            count = self.n
        from ..render.store import MAX_BUCKET
        local_needed = -(-int(count) // self.n_devices) + 2
        if local_needed > MAX_BUCKET:
            # piece ranges larger than one launch and sum (additive blending)
            piece = MAX_BUCKET * self.n_devices // 2
            total = None
            for s in range(int(start), int(start + count), piece):
                im = self.render(matrix, scale, s,
                                 min(piece, start + count - s), cell_mask)
                total = im if total is None else total + im
            return total
        bucket = local_bucket_size(local_needed, self.local_n)
        step = self._steps.get(bucket)
        if step is None:
            step = self._steps[bucket] = self._build_step(bucket)
        table = self._all_cells if cell_mask is None else jnp.asarray(cell_mask)
        return step(self.pos_smooth, self.values, self.cell_ids, table,
                    jnp.asarray(matrix, jnp.float32), jnp.float32(scale),
                    jnp.int32(start), jnp.int32(count))
