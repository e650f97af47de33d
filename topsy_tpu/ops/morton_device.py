"""On-device (bucket, Morton) presort build — the device replacement for
the host-side ``ops/morton.build_presorted``.

The host build is memory-bandwidth bound numpy: measured ~210 s at 2^24 on
the dev host (radix 15 s, run padding + shuffle ~66 s, each array apply
~45 s), which would be tens of minutes at 100M particles.  On the device
the same construction is a handful of ``lax.sort`` calls and
elementwise/cumulative passes, and per-quantity applies are single row
gathers.  Raw arrays are uploaded once (the same
bytes the host path would upload anyway) and never touched again by the
host.

Semantics match ``build_presorted`` (same bucket quantization, same Morton
key, same run padding and within-group shuffle semantics); only the
tie-break order inside equal (bucket, morton) keys and the shuffle's random
draws differ — both are irrelevant to the layout contract (see
PresortedLayout's docstring).

Static-shape strategy: inputs are padded to a power-of-two capacity N_CAP
(fake particles carry a +huge bucket so they sort last and form a trailing
run that is simply never addressed), and every build array has static shape
N_CAP or N_OUT_CAP = N_CAP + slack.  One compile per capacity, reused
across snapshots via the persistent compile cache.  The actual ``n_out`` is
read back (one scalar) and the outputs sliced to it.

Algorithm (all O(n) passes + three sorts, no large scatters):

1. key = (bucket, morton_hi24, morton_lo24) int32 triple; ``lax.sort`` with
   the particle index as payload -> sorted buckets + permutation.
2. run starts by neighbour comparison; run padding via a cumulative sum of
   per-run pad deltas placed at run starts -> monotone destinations
   ``dst0`` (pre-shuffle!), all per-particle.
3. run table compaction by a second sort (run starts to the front), then
   R_CAP-sized scatters of each run's (real_end, bucket) at its output
   start; cumulative max over slots (both are ascending across runs)
   yields per-slot realness and bucket without any searchsorted/gather.
4. slot -> source rank: ``cumsum(real) - 1`` (dst0 is monotone, so the
   k-th real slot holds the k-th sorted particle).
5. within-group shuffle: a row-wise ``lax.sort`` of random keys (pads
   keyed +2.0 stay at the tail) permutes the source ranks inside each
   pad_group row.
6. gather-compose with the sort permutation -> ``gidx``: per-slot source
   index into the ORIGINAL arrays (sentinel n for pads).

Reference: the reference has no analogue (its renderer re-sorts on the GPU
every frame, src/topsy/sph.py:332-345); this order is what makes the
sort-free splat path possible (ops/morton.py).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .morton import DELTA_OCTAVE, PAD_POS

logger = logging.getLogger(__name__)

R_CAP = 2048          # max runs (f32 smoothing supports <= 2032 buckets)
BIG_BUCKET = 1 << 28  # fake-particle bucket: sorts after every real bucket


def _spread8(v):
    """Interleave the low 8 bits of v to stride 3 (bits 0..21)."""
    x = v & 0xFF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _morton_keys(pos, real):
    """(hi24, lo24) int32 Morton key halves over the real bounding box."""
    lo = jnp.min(jnp.where(real[:, None], pos, jnp.inf), axis=0)
    hi = jnp.max(jnp.where(real[:, None], pos, -jnp.inf), axis=0)
    span = hi - lo + 1e-30
    q = jnp.clip((pos - lo) / span * 65535.0, 0.0, 65535.0).astype(jnp.int32)
    lo24 = (_spread8(q[:, 0]) | (_spread8(q[:, 1]) << 1)
            | (_spread8(q[:, 2]) << 2))
    hi24 = (_spread8(q[:, 0] >> 8) | (_spread8(q[:, 1] >> 8) << 1)
            | (_spread8(q[:, 2] >> 8) << 2))
    return hi24, lo24


def _ceil_to(x, q):
    return ((x + q - 1) // q) * q


@partial(jax.jit, static_argnames=("n_real",))
def _sort_stage(ps, *, n_real: int):
    """Key + three-key sort.  Separately jitted: the build is split at its
    natural barriers rather than fused into one program."""
    n_cap = ps.shape[0]
    idx = jnp.arange(n_cap, dtype=jnp.int32)
    real_in = idx < n_real

    h = jnp.maximum(ps[:, 3], 1e-30)
    buckets = jnp.floor(jnp.log2(h) * (1.0 / DELTA_OCTAVE)).astype(jnp.int32)
    buckets = jnp.where(real_in, buckets, BIG_BUCKET)
    hi24, lo24 = _morton_keys(ps[:, :3], real_in)
    hi24 = jnp.where(real_in, hi24, 0)
    lo24 = jnp.where(real_in, lo24, 0)

    b_sorted, _, _, perm = jax.lax.sort((buckets, hi24, lo24, idx),
                                        num_keys=3)
    return b_sorted, perm


@partial(jax.jit, static_argnames=("n_real", "run_quantum", "pad_total"))
def _run_stage(b_sorted, *, n_real: int, run_quantum: int, pad_total: int):
    """Run boundaries, padded destinations, compacted run table."""
    n_cap = b_sorted.shape[0]
    pos = jnp.arange(n_cap, dtype=jnp.int32)
    real_in = pos < n_real
    is_start = jnp.concatenate([jnp.ones((1,), bool),
                                b_sorted[1:] != b_sorted[:-1]])
    start_pos = jnp.where(is_start, pos, 0)
    run_start = jax.lax.cummax(start_pos)
    # padding added before each run: at run starts (pos > 0), the previous
    # run [prev_start, pos) is padded to a run_quantum multiple
    rs_prev = jnp.concatenate([jnp.zeros((1,), jnp.int32), run_start[:-1]])
    len_prev = pos - rs_prev
    pad_prev = jnp.where(is_start & (pos > 0),
                         _ceil_to(len_prev, run_quantum) - len_prev, 0)
    dst0 = pos + jnp.cumsum(pad_prev)

    # actual output length: end of the last real run, padded
    last = n_real - 1
    len_last = n_real - run_start[last]
    n_out = _ceil_to(dst0[last] + 1 + _ceil_to(len_last, run_quantum)
                     - len_last, pad_total)
    n_runs = jnp.sum((is_start & real_in).astype(jnp.int32))

    # ---- compact the run table (R_CAP) by sorting starts to the front ----
    ckey = jnp.where(is_start & real_in, pos, n_cap)
    ckey_sorted, c_dst0, c_bucket = jax.lax.sort(
        (ckey, dst0, b_sorted), num_keys=1)
    starts_r = ckey_sorted[:R_CAP]
    os_r = c_dst0[:R_CAP]                       # run output starts
    bucket_r = c_bucket[:R_CAP]
    next_start = jnp.concatenate([starts_r[1:], jnp.full((1,), n_cap,
                                                         jnp.int32)])
    len_r = jnp.minimum(next_start, n_real) - jnp.minimum(starts_r, n_real)
    return os_r, bucket_r, len_r, n_out, n_runs


@partial(jax.jit, static_argnames=("n_real", "n_cap", "n_out_cap",
                                   "pad_group", "seed"))
def _slot_stage(perm, os_r, bucket_r, len_r, *, n_real: int, n_cap: int,
                n_out_cap: int, pad_group: int, seed: int):
    """Per-slot realness/bucket, within-group shuffle, final gather map."""
    valid_r = len_r > 0
    re_r = os_r + len_r                          # real end per run

    # ---- per-slot realness + bucket via ascending cummax ------------------
    slot = jnp.arange(n_out_cap, dtype=jnp.int32)
    tgt = jnp.where(valid_r, os_r, n_out_cap)
    re_scat = jnp.zeros((n_out_cap,), jnp.int32).at[tgt].max(
        jnp.where(valid_r, re_r, 0), mode="drop")
    real_end_slot = jax.lax.cummax(re_scat)
    real = slot < real_end_slot
    # bucket deltas: buckets ascend across runs; +1 offset so cummax(0)
    # means "before the first run" (never addressed)
    bmin = bucket_r[0]
    b_scat = jnp.zeros((n_out_cap,), jnp.int32).at[tgt].max(
        jnp.where(valid_r, bucket_r - bmin + 1, 0), mode="drop")
    buckets_slot = jax.lax.cummax(b_scat) - 1 + bmin

    # ---- source rank per slot, then within-group shuffle ------------------
    src_rank = jnp.cumsum(real.astype(jnp.int32)) - 1
    n_groups_cap = n_out_cap // pad_group
    key = jax.random.PRNGKey(seed)
    rnd = jax.random.uniform(key, (n_out_cap,), jnp.float32)
    shuf_key = jnp.where(real, rnd, 2.0).reshape(n_groups_cap, pad_group)
    _, rank_shuf = jax.lax.sort(
        (shuf_key, src_rank.reshape(n_groups_cap, pad_group)),
        dimension=1, num_keys=1)
    rank_shuf = rank_shuf.reshape(n_out_cap)

    # compose with the sort permutation -> original-array source index
    # (sentinel n_real for pads: real gather targets are < n_real, so
    # apply() only appends a single fill row)
    gidx = jnp.where(real, jnp.take(perm, jnp.clip(rank_shuf, 0, n_cap - 1),
                                    mode="clip"), n_real)

    # per-column real counts across groups: real slots are group prefixes,
    # so counts[c] == number of groups with more than c real members
    counts = real.reshape(n_groups_cap, pad_group).sum(axis=0,
                                                       dtype=jnp.int32)
    return gidx, buckets_slot, real, counts


def _build_device(ps, *, n_real: int, n_out_cap: int, pad_group: int,
                  run_quantum: int, pad_total: int, seed: int):
    """The staged build at static capacity shapes.  ps: (N_CAP, 4) f32 with
    rows >= n_real arbitrary.  Returns (gidx, buckets_slot, real, counts,
    n_out, n_runs) with slot arrays at n_out_cap length."""
    n_cap = ps.shape[0]
    b_sorted, perm = _sort_stage(ps, n_real=n_real)
    os_r, bucket_r, len_r, n_out, n_runs = _run_stage(
        b_sorted, n_real=n_real, run_quantum=run_quantum,
        pad_total=pad_total)
    gidx, buckets_slot, real, counts = _slot_stage(
        perm, os_r, bucket_r, len_r, n_real=n_real, n_cap=n_cap,
        n_out_cap=n_out_cap, pad_group=pad_group, seed=seed)
    return gidx, buckets_slot, real, counts, n_out, n_runs


@dataclass(frozen=True)
class DevicePresortedLayout:
    """Device-resident presorted layout: per-slot gather index + buckets.

    ``gidx[s]`` is the source row of output slot s (== capacity sentinel
    for pads — ``apply`` appends a fill row so the gather is branch-free);
    interface mirrors morton.PresortedLayout where renderers need it."""

    gidx: jnp.ndarray      # (n_out,) int32, sentinel == n_real for pads
    buckets: jnp.ndarray   # (n_out,) int32, device
    n_out: int
    pad_group: int
    run_quantum: int
    real_per_column: np.ndarray   # (pad_group,) int64, host
    n_real: int

    def apply(self, arr, fill: float = 0.0):
        """Permute a device (or host) array of length >= n_real into the
        padded presorted order — one row gather."""
        arr = jnp.asarray(arr)
        assert arr.shape[0] >= self.n_real, (arr.shape, self.n_real)
        fill_row = jnp.full((1,) + arr.shape[1:], fill, arr.dtype)
        arr = jnp.concatenate([arr[:self.n_real], fill_row])
        return jnp.take(arr, self.gidx, axis=0)


def build_presorted_device(ps, pad_group: int = 512, pad_total: int = 4096,
                           run_quantum: int | None = None,
                           seed: int = 1337,
                           n_real: int | None = None
                           ) -> DevicePresortedLayout | None:
    """Build the presorted layout on the accelerator.

    ps: (n, 4) [x, y, z, h] — numpy (uploaded once) or already on device.
    ``n_real`` (default: all rows) marks rows >= n_real as padding whose
    contents are ignored (they must still be finite, e.g. PAD_POS rows).
    Returns None when the snapshot needs the host fallback (more runs than
    R_CAP or pathological padding beyond the slack capacity)."""
    if n_real is None:
        n_real = int(ps.shape[0])
    n = n_real
    if run_quantum is None:
        run_quantum = 8 * pad_group if n >= (1 << 23) else 4 * pad_group
    run_quantum = max(run_quantum, pad_group)

    n_cap = max(pad_total, 1 << (max(int(ps.shape[0]), 1) - 1).bit_length())
    n_out_cap = _ceil_to(n_cap + max(n_cap // 4, 64 * run_quantum),
                         pad_total)

    ps = jnp.asarray(ps, jnp.float32)
    if ps.shape[0] != n_cap:
        ps = jnp.concatenate(
            [ps, jnp.full((n_cap - ps.shape[0], 4), PAD_POS, jnp.float32)])

    for _attempt in range(2):
        gidx, buckets_slot, real, counts, n_out, n_runs = _build_device(
            ps, n_real=n, n_out_cap=n_out_cap, pad_group=pad_group,
            run_quantum=run_quantum, pad_total=pad_total, seed=seed)
        n_out = int(n_out)
        n_runs = int(n_runs)
        if n_runs > R_CAP:
            logger.warning("Device presort fallback: %d runs > %d",
                           n_runs, R_CAP)
            return None
        if n_out <= n_out_cap:
            break
        # pad-dominated small snapshot: n_out is exact — retry once at a
        # quantized capacity that covers it (one extra compile, cached)
        n_out_cap = _ceil_to(n_out, max(pad_total, n_cap // 8))
        logger.info("Device presort retry at capacity %d", n_out_cap)
    else:
        logger.warning("Device presort fallback: n_out %d > capacity %d",
                       n_out, n_out_cap)
        return None

    real_per_column = np.asarray(counts).astype(np.int64)

    return DevicePresortedLayout(
        gidx=gidx[:n_out], buckets=buckets_slot[:n_out], n_out=n_out,
        pad_group=pad_group, run_quantum=run_quantum,
        real_per_column=real_per_column, n_real=n)


def build_mip_layout(layout: DevicePresortedLayout, pos_smooth,
                     seed: int = 1337, pad_total: int = 4096
                     ) -> DevicePresortedLayout | None:
    """Decimation-mip layout: a presorted layout over the particles in the
    first ``min_slice_width`` columns of ``layout`` — a spatially fair
    1/(pad_group/w) subsample thanks to the within-group shuffle.

    The mip's gidx composes back to the ORIGINAL arrays (same sentinel
    semantics as the parent), so it is itself a DevicePresortedLayout over
    the snapshot and can be chained (a mip of a mip).  The union of the mip
    and the parent's columns [w, pad_group) is exactly the snapshot, so an
    interactive progression can render mip columns first and continue into
    parent columns with every particle rendered exactly once — the particle
    analogue of texture mip levels (the reference has no analogue: its
    rasterizer re-culls per draw, reference: src/topsy/sph.py:306-332).

    ``pos_smooth``: (>= layout.n_real, 4) device/host positions in the
    ORIGINAL order.  Returns None when the subsample cannot build (host
    fallback cases or a degenerate subsample).
    """
    from .morton import PAD_POS, min_slice_width

    w = min_slice_width(layout)
    if w >= layout.pad_group:
        return None  # no safe column slicing: nothing to decimate
    ng = layout.n_out // layout.pad_group
    sub = layout.gidx.reshape(ng, layout.pad_group)[:, :w].reshape(-1)
    n_full = layout.n_real
    is_pad = (sub >= n_full).astype(jnp.int32)
    # compact real slots to the front (deterministic: slot index tiebreak)
    _, _, sub_c = jax.lax.sort(
        (is_pad, jnp.arange(sub.shape[0], dtype=jnp.int32), sub), num_keys=2)
    m_real = int(sub.shape[0] - jnp.sum(is_pad))
    if m_real < 2 * layout.pad_group:
        return None  # degenerate subsample: not worth a tier

    ps = jnp.asarray(pos_smooth, jnp.float32)
    base = jnp.concatenate(
        [ps[:n_full], jnp.full((1, 4), PAD_POS, jnp.float32)])
    ps_sub = jnp.take(base, jnp.minimum(sub_c, n_full), axis=0)
    inner = build_presorted_device(ps_sub, pad_group=layout.pad_group,
                                   pad_total=pad_total, seed=seed,
                                   n_real=m_real)
    if inner is None:
        return None
    # compose inner gather (into the compacted subsample) with the
    # subsample's source indices -> indices into the ORIGINAL arrays.
    # inner pads carry sentinel m_real; sub_c[m_real] (the first compacted
    # pad) already holds the parent sentinel n_full — and when the
    # subsample has no pads at all, the appended row provides it.
    ext = jnp.concatenate([sub_c, jnp.full((1,), n_full, sub_c.dtype)])
    gidx = jnp.take(ext, inner.gidx)
    return DevicePresortedLayout(
        gidx=gidx, buckets=inner.buckets, n_out=inner.n_out,
        pad_group=inner.pad_group, run_quantum=inner.run_quantum,
        real_per_column=inner.real_per_column, n_real=n_full)
