"""Decimation-mip tiers for the sort-free column LOD (ops/morton_device.
build_mip_layout, store.ensure_column_mips, tiered RenderProgressionColumns).

A mip tier is a presorted layout over the particles in the first
min_slice_width columns of its parent — exactly the set a parent column
slice at the LOD floor would render — so interactive frames can go below
1/8 coverage while the full progression still renders every particle
exactly once.  The reference has no analogue (its rasterizer draws
arbitrary index ranges, reference: src/topsy/progressive_render.py:8-137);
this is the substitute for sub-floor LOD at 10^8-particle scale.
"""

import numpy as np
import pytest

import jax.numpy as jnp

import topsy_tpu
from topsy_tpu import camera, config
from topsy_tpu.canvas import OffscreenCanvas
from topsy_tpu.drawreason import DrawReason
from topsy_tpu.loaders import TestDataLoader
from topsy_tpu.ops import morton, morton_device
from topsy_tpu.progression import RenderProgressionColumns


@pytest.fixture(scope="module")
def snap():
    loader = TestDataLoader(60000, seed=1337)
    return loader.get_pos_smooth().astype(np.float32)


@pytest.fixture(scope="module")
def parent(snap):
    layout = morton_device.build_presorted_device(snap)
    assert layout is not None
    return layout


def test_mip_layout_is_exact_parent_prefix(snap, parent):
    """The mip holds exactly the particles of the parent's first
    min_slice_width columns, each once."""
    mip = morton_device.build_mip_layout(parent, snap)
    assert mip is not None
    n = parent.n_real
    w = morton.min_slice_width(parent)
    ng = parent.n_out // parent.pad_group
    parent_gidx = np.asarray(parent.gidx).reshape(ng, parent.pad_group)
    expected = parent_gidx[:, :w].ravel()
    expected = np.sort(expected[expected < n])
    got = np.asarray(mip.gidx)
    got = np.sort(got[got < n])
    assert np.array_equal(got, expected)
    assert mip.n_real == n  # composed to the ORIGINAL arrays
    assert int(mip.real_per_column.sum()) == len(expected)
    # mip slots carry the correct smoothing bucket for their particle
    ps = np.asarray(snap)
    real_slots = np.asarray(mip.gidx) < n
    b_in = morton.smoothing_buckets(ps[np.asarray(mip.gidx)[real_slots], 3])
    assert np.array_equal(np.asarray(mip.buckets)[real_slots], b_in)
    # runs padded: buckets non-decreasing over real slots
    assert np.all(np.diff(np.asarray(mip.buckets)[real_slots]) >= 0)


def test_store_builds_mip_chain(monkeypatch):
    """ensure_column_mips chains tiers until the interactive floor is below
    COLUMN_MIP_FLOOR_TARGET, and each tier is the prefix of its parent."""
    from topsy_tpu.render.store import ParticleStore
    monkeypatch.setattr(config, "COLUMN_MIP_FLOOR_TARGET", 1500)
    store = ParticleStore(TestDataLoader(60000, seed=1337))
    tiers = store.ensure_column_mips()
    assert len(tiers) == config.COLUMN_MIP_MAX_TIERS
    # deepest first: each tier's total equals its parent's prefix columns
    layouts = [t.layout for t in tiers] + [store.presorted_layout]
    for child, parent_l in zip(layouts[:-1], layouts[1:]):
        w = morton.min_slice_width(parent_l)
        assert int(child.real_per_column.sum()) == \
            int(parent_l.real_per_column[:w].sum())
    # small snapshots build no tiers (floor already under the target)
    store2 = ParticleStore(TestDataLoader(4000, seed=1))
    monkeypatch.setattr(config, "COLUMN_MIP_FLOOR_TARGET", 1 << 21)
    assert store2.ensure_column_mips() == []


def test_tiered_progression_exact_coverage(monkeypatch):
    """Walking the tiered progression to completion renders every particle
    exactly once (mips first, then parent columns above each floor)."""
    from topsy_tpu.render.store import ParticleStore
    monkeypatch.setattr(config, "COLUMN_MIP_FLOOR_TARGET", 1500)
    n = 60000
    store = ParticleStore(TestDataLoader(n, seed=1337))
    mips = store.ensure_column_mips()
    assert len(mips) >= 1
    main = store.presorted_layout
    prog = RenderProgressionColumns(
        main.real_per_column, col_quantum=morton.min_slice_width(main),
        mip_tiers=[(m.layout.real_per_column,
                    morton.min_slice_width(m.layout)) for m in mips],
        initial_particles=700)
    assert prog._total == n

    layouts = [m.layout for m in mips] + [main]
    counts = np.zeros(n, dtype=np.int64)
    tiers_seen = set()
    prog.start_frame(DrawReason.CHANGE)
    for _ in range(300):
        block = prog.get_block(0.0)
        if block is None:
            if not prog.needs_refine():
                break
            prog.end_frame_get_scalefactor()
            prog.start_frame(DrawReason.REFINE)
            continue
        (c0,), (nc,) = block
        ti = prog.last_block_tier
        tiers_seen.add(ti)
        lay = layouts[ti]
        ng = lay.n_out // lay.pad_group
        gidx = np.asarray(lay.gidx).reshape(ng, lay.pad_group)
        got = gidx[:, c0:c0 + nc].ravel()
        got = got[got < n]
        np.add.at(counts, got, 1)
        # block length accounting matches the real particles it covers
        assert prog._last_block_len == len(got)
        prog.end_block(0.005)
    assert tiers_seen == set(range(len(layouts)))
    assert prog.end_frame_get_scalefactor() == 1.0
    assert (counts == 1).all()


def test_interactive_mip_render_matches_export(monkeypatch):
    """A CHANGE frame starting in the deepest mip tier, refined to
    completion, reproduces the EXPORT image — and the first partial frame
    is a fair subsample under the exact photometric scale factor."""
    monkeypatch.setattr(config, "COLUMN_MIP_FLOOR_TARGET", 1500)
    monkeypatch.setattr(config, "INITIAL_PARTICLES_TO_RENDER", 500)
    vis = topsy_tpu.test(60000, render_resolution=128,
                         canvas_class=OffscreenCanvas)
    vis.show_status = False
    sph = vis._sph
    sph.render(DrawReason.CHANGE)
    assert isinstance(sph.render_progression, RenderProgressionColumns)
    assert len(sph.render_progression._tiers) == \
        config.COLUMN_MIP_MAX_TIERS + 1

    # first frame: partial coverage, exact scale factor, fair subsample
    scale0 = sph.last_render_mass_scale
    assert scale0 > 1.0
    im0 = np.asarray(sph.get_output_image())[..., 0] * scale0

    for _ in range(300):
        if not sph.needs_refine():
            break
        sph.render(DrawReason.REFINE)
    assert not sph.needs_refine()
    assert sph.last_render_mass_scale == pytest.approx(1.0)
    im_cols = np.asarray(sph.get_output_image()).copy()

    sph.render(DrawReason.EXPORT)
    im_export = np.asarray(sph.get_output_image())
    assert im_cols[..., 0].sum() == pytest.approx(im_export[..., 0].sum(),
                                                  rel=1e-4)
    corr = np.corrcoef(im_cols[..., 0].ravel(),
                       im_export[..., 0].ravel())[0, 1]
    assert corr > 0.9999

    # the deepest-tier first frame is a statistically fair subsample
    assert im0.sum() == pytest.approx(im_export[..., 0].sum(), rel=0.05)
    corr0 = np.corrcoef(im0.ravel(), im_export[..., 0].ravel())[0, 1]
    assert corr0 > 0.9


def test_distributed_mip_render_matches_export(monkeypatch):
    """The mesh column path routes mip tiers per shard (each chip renders
    its slab's tier columns, psum over the mesh): refining a mip-started
    CHANGE progression to completion reproduces the mesh EXPORT image."""
    from topsy_tpu.parallel import make_mesh
    # per-chip floor threshold: 8 devices multiply the target
    monkeypatch.setattr(config, "COLUMN_MIP_FLOOR_TARGET", 200)
    monkeypatch.setattr(config, "INITIAL_PARTICLES_TO_RENDER", 500)
    vis = topsy_tpu.test(60000, render_resolution=128,
                         canvas_class=OffscreenCanvas, mesh=make_mesh(8))
    vis.show_status = False
    sph = vis._sph
    sph.render(DrawReason.CHANGE)
    assert isinstance(sph.render_progression, RenderProgressionColumns)
    assert len(sph.render_progression._tiers) >= 2  # >= 1 mip + main
    assert sph.last_render_mass_scale > 1.0

    for _ in range(300):
        if not sph.needs_refine():
            break
        sph.render(DrawReason.REFINE)
    assert not sph.needs_refine()
    assert sph.last_render_mass_scale == pytest.approx(1.0)
    im_cols = np.asarray(sph.get_output_image()).copy()

    sph.render(DrawReason.EXPORT)
    im_export = np.asarray(sph.get_output_image())
    assert im_cols[..., 0].sum() == pytest.approx(im_export[..., 0].sum(),
                                                  rel=1e-4)
    corr = np.corrcoef(im_cols[..., 0].ravel(),
                       im_export[..., 0].ravel())[0, 1]
    assert corr > 0.9999


def _tier_specs():
    """Synthetic 3-tier chain honouring the mip invariant: each tier's
    first-quantum columns hold exactly the deeper tiers' reals."""
    rpc0 = np.full(512, 2, np.int64)            # deepest: 1024 reals
    rpc1 = np.full(512, 16, np.int64)           # [0,64) holds 1024 = rpc0
    rpc_main = np.full(512, 100, np.int64)
    rpc_main[:64] = 128                         # 8192 = rpc0 + rpc1[64:]
    assert rpc1[:64].sum() == rpc0.sum()
    assert rpc_main[:64].sum() == rpc0.sum() + rpc1[64:].sum()
    return rpc0, rpc1, rpc_main


def test_whole_tier_blocks_one_per_frame():
    """Interactive blocks snap to whole tiers (launch cost is flat in
    column width) and frames render at most one block; REFINE completes
    one parent tier per frame, exactly once overall."""
    from topsy_tpu.drawreason import DrawReason
    from topsy_tpu.progression import RenderProgressionColumns
    rpc0, rpc1, rpc_main = _tier_specs()
    prog = RenderProgressionColumns(
        rpc_main, col_quantum=64,
        mip_tiers=[(rpc0, 64), (rpc1, 64)], initial_particles=10)
    total = prog._total

    prog.start_frame(DrawReason.CHANGE)
    (c0,), (nc,) = prog.get_block(0.0)
    assert (c0, nc) == (0, 512)                 # whole deepest tier
    assert prog.last_block_tier == 0
    assert prog._last_block_len == int(rpc0.sum())
    prog.end_block(0.005)
    assert prog.get_block(0.0) is None          # one block per frame
    scale = prog.end_frame_get_scalefactor()
    assert scale == pytest.approx(total / rpc0.sum())

    seen = [(0, 0, 512)]
    while prog.needs_refine():
        prog.start_frame(DrawReason.REFINE)
        (c0,), (nc,) = prog.get_block(0.0)
        seen.append((prog.last_block_tier, c0, nc))
        prog.end_block(0.005)
        assert prog.get_block(0.0) is None
        prog.end_frame_get_scalefactor()
    # whole-tier refinement: each parent renders its own columns once
    assert seen == [(0, 0, 512), (1, 64, 448), (2, 64, 448)]


def test_budget_promotes_to_parent_tier():
    """A recommendation covering a parent tier's full fair subsample
    renders that parent from column 0 (covering the deeper tiers'
    logical ranges in one launch — a mip holds exactly its parent's
    prefix columns)."""
    from topsy_tpu.drawreason import DrawReason
    from topsy_tpu.progression import RenderProgressionColumns
    rpc0, rpc1, rpc_main = _tier_specs()

    def make(budget):
        return RenderProgressionColumns(
            rpc_main, col_quantum=64,
            mip_tiers=[(rpc0, 64), (rpc1, 64)], initial_particles=budget)

    # budget covers tier1's full subsample (1024 + 7168 = 8192)
    prog = make(9000)
    prog.start_frame(DrawReason.CHANGE)
    (c0,), (nc,) = prog.get_block(0.0)
    assert (c0, nc) == (0, 512) and prog.last_block_tier == 1
    assert prog._last_block_len == 8192
    prog.end_block(0.005)
    prog.end_frame_get_scalefactor()
    # REFINE continues at the main tier — deeper ranges are already covered
    prog.start_frame(DrawReason.REFINE)
    assert prog.get_block(0.0)[0] == [64]
    assert prog.last_block_tier == 2

    # budget >= everything: CHANGE covers the whole snapshot, scale 1
    prog = make(10**9)
    prog.start_frame(DrawReason.CHANGE)
    (c0,), (nc,) = prog.get_block(0.0)
    assert (c0, nc) == (0, 512) and prog.last_block_tier == 2
    prog.end_block(0.005)
    assert prog.end_frame_get_scalefactor() == 1.0
    assert not prog.needs_refine()


def test_export_blocks_keep_quantum_chunking():
    """EXPORT still chunks by column quanta (piece-loop economics differ:
    its launches scale with groups, not width)."""
    from topsy_tpu import config
    from topsy_tpu.drawreason import DrawReason
    from topsy_tpu.progression import RenderProgressionColumns
    rpc0, rpc1, rpc_main = _tier_specs()
    prog = RenderProgressionColumns(
        rpc_main, col_quantum=64,
        mip_tiers=[(rpc0, 64), (rpc1, 64)], initial_particles=10)
    covered = 0
    prog.start_frame(DrawReason.EXPORT)
    for _ in range(1000):
        block = prog.get_block(0.0)
        if block is None:
            break
        (c0,), (nc,) = block
        assert nc % 64 == 0
        covered += prog._last_block_len
        prog.end_block(0.005)
    assert covered == prog._total
    assert prog.end_frame_get_scalefactor() == 1.0
