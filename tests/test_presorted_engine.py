"""The presorted XLA splat path (splat_atlas with ``presorted_buckets``,
and the renderer's jitted piece and column launches around it).

Checks it against the scatter ground truth, and checks the launch
decompositions the renderers use — bucket pieces, particle ranges, column
slices — against one full render."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from topsy_tpu import camera
from topsy_tpu.loaders import TestDataLoader
from topsy_tpu.ops import morton, splat, splat_atlas
from topsy_tpu.ops.splat_giant import BUCKET_DISABLED

RES, SCALE = 128, 120.0


@pytest.fixture(scope="module")
def presorted():
    loader = TestDataLoader(30000, seed=1337)
    ps = loader.get_pos_smooth().astype(np.float32)
    mass = loader.get_mass().astype(np.float32)
    qty = loader.get_named_quantity("test-quantity").astype(np.float32)
    values = np.stack([mass, mass * qty], axis=1)
    layout = morton.build_presorted(ps)
    ps_p = layout.apply(ps, fill=morton.PAD_POS)
    vals_p = layout.apply(values)
    return ps, values, layout, ps_p, vals_p


def _matrix(rot_deg=0.0):
    if rot_deg:
        import scipy.spatial.transform as sst
        rot = sst.Rotation.from_euler("xy", [rot_deg, rot_deg * 0.7],
                                      degrees=True).as_matrix()
    else:
        rot = np.eye(3)
    return jnp.asarray(camera.world_to_clip_matrix(rot, np.zeros(3), SCALE),
                       jnp.float32)


def _direct(ps_p, vals_p, layout, matrix, **kw):
    return jax.jit(lambda a, b, m, k: splat_atlas.splat_atlas(
        a, b, m, RES, SCALE, presorted_buckets=k, **kw))(
        jnp.asarray(ps_p), jnp.asarray(vals_p), matrix,
        jnp.asarray(layout.buckets))


def _block(ps_p, vals_p, layout, matrix, start, count, bucket):
    """One piece through the renderer's EXPORT launch."""
    from topsy_tpu.render.sph import _render_block_presorted
    n = len(ps_p)
    return _render_block_presorted(
        jnp.asarray(ps_p), jnp.asarray(vals_p), jnp.asarray(layout.buckets),
        jnp.zeros(n, jnp.int32), jnp.ones(1, bool), matrix,
        jnp.float32(SCALE), jnp.int32(start), jnp.int32(count),
        jnp.int32(BUCKET_DISABLED), resolution=RES, bucket=bucket,
        depth_channel=False)


def _assert_close_image(im, ref, rel_sum=1e-3, rel_max=0.01):
    im, ref = np.asarray(im), np.asarray(ref)
    for c in range(ref.shape[-1]):
        assert im[..., c].sum() == pytest.approx(ref[..., c].sum(),
                                                 rel=rel_sum)
    assert np.abs(im - ref).max() <= rel_max * np.abs(ref).max()


def _assert_matches_scatter(im, ref):
    """Same distribution as the exact scatter path (levels come from the
    smoothing buckets and the deposit from the low-rank profiles)."""
    im, ref = np.asarray(im), np.asarray(ref)
    for c in range(ref.shape[-1]):
        assert im[..., c].sum() == pytest.approx(ref[..., c].sum(), rel=0.01)
    corr = np.corrcoef(im[..., 0].ravel(), ref[..., 0].ravel())[0, 1]
    assert corr > 0.999


@pytest.mark.parametrize("rot_deg", [0.0, 35.0])
def test_block_launch_matches_direct(presorted, rot_deg):
    """The renderer's full-range EXPORT launch is the direct presorted
    splat (giants excluded by a disabled threshold keep the same image as
    'auto' when the scene has none above the windowed footprint)."""
    ps, values, layout, ps_p, vals_p = presorted
    matrix = _matrix(rot_deg)
    n = len(ps_p)
    im_b, d0 = _block(ps_p, vals_p, layout, matrix, 0, n, n)
    im_d, d1 = _direct(ps_p, vals_p, layout, matrix, giants="none")
    assert int(d0) == 0 and int(d1) == 0
    np.testing.assert_allclose(np.asarray(im_b), np.asarray(im_d),
                               rtol=1e-5, atol=1e-6 * np.abs(im_d).max())


def test_presorted_mass_conservation(presorted):
    ps, values, layout, ps_p, vals_p = presorted
    matrix = _matrix()
    im, dropped = _direct(ps_p, vals_p, layout, matrix)
    assert int(dropped) == 0
    ref = splat.splat_scatter(jnp.asarray(ps), jnp.asarray(values), matrix,
                              RES, SCALE)
    _assert_matches_scatter(im, ref)


def test_piece_loop_sums_to_full(presorted):
    """EXPORT pieces (bucket-sized launches at increasing starts) sum to
    the one-launch render."""
    ps, values, layout, ps_p, vals_p = presorted
    matrix = _matrix(20.0)
    n = len(ps_p)
    bucket = 1 << (n - 1).bit_length() - 1
    im_full, _ = _block(ps_p, vals_p, layout, matrix, 0, n, n)
    acc = None
    for start in range(0, n, bucket):
        im, d = _block(ps_p, vals_p, layout, matrix, start,
                       min(bucket, n - start), bucket)
        assert int(d) == 0
        acc = im if acc is None else acc + im
    np.testing.assert_allclose(np.asarray(acc), np.asarray(im_full),
                               rtol=1e-4, atol=1e-5 * np.abs(im_full).max())


def test_particle_range(presorted):
    """Two masked ranges of one full-size launch sum to the full range."""
    ps, values, layout, ps_p, vals_p = presorted
    matrix = _matrix()
    n = len(ps_p)
    half = (n // 2 // 4096) * 4096
    im_full, _ = _block(ps_p, vals_p, layout, matrix, 0, n, n)
    im_a, _ = _block(ps_p, vals_p, layout, matrix, 0, half, n)
    im_b, _ = _block(ps_p, vals_p, layout, matrix, half, n - half, n)
    np.testing.assert_allclose(np.asarray(im_a + im_b), np.asarray(im_full),
                               rtol=1e-4, atol=1e-5 * np.abs(im_full).max())


def test_depth_channel_matches_scatter(presorted):
    """The depth channel (values0 * clip_z) of the presorted path."""
    ps, values, layout, ps_p, vals_p = presorted
    matrix = _matrix(15.0)
    im, dropped = _direct(ps_p, vals_p, layout, matrix, depth_channel=True)
    assert int(dropped) == 0
    ref = splat.splat_scatter(jnp.asarray(ps), jnp.asarray(values), matrix,
                              RES, SCALE, depth_channel=True)
    assert np.asarray(im).shape[-1] == 3
    _assert_matches_scatter(im, ref)


def test_renderer_presorted_export_matches_sorted():
    """A repeated EXPORT switches the renderer to the presorted launches;
    its image agrees with the first (per-frame sorted) EXPORT."""
    import topsy_tpu
    from topsy_tpu.canvas import OffscreenCanvas

    vis = topsy_tpu.test(20000, render_resolution=128,
                         canvas_class=OffscreenCanvas)
    vis.show_status = False
    im_sorted = np.asarray(vis.get_sph_image())
    assert getattr(vis._sph._store, "_presorted_layout", None) is None
    vis._sph.invalidate()
    im_pre = np.asarray(vis.get_sph_image())
    assert getattr(vis._sph._store, "_presorted_layout", None) is not None
    assert vis._sph.last_dropped_splats == 0
    assert np.nansum(im_pre) == pytest.approx(np.nansum(im_sorted), rel=1e-2)
    corr = np.corrcoef(np.nan_to_num(im_pre).ravel(),
                       np.nan_to_num(im_sorted).ravel())[0, 1]
    assert corr > 0.999


@pytest.mark.parametrize("width", [256, 128])
def test_column_slices_sum_to_full(presorted, width):
    """Every column slice of a width, through the renderer's column launch,
    together deposit the full presorted render."""
    from topsy_tpu.render.sph import _render_block_columns
    ps, values, layout, ps_p, vals_p = presorted
    matrix = _matrix(10.0)
    pg = layout.pad_group
    im_full, _ = _direct(ps_p, vals_p, layout, matrix, giants="none")
    acc = None
    for col0 in range(0, pg, width):
        im, d = _render_block_columns(
            jnp.asarray(ps_p), jnp.asarray(vals_p),
            jnp.asarray(layout.buckets), None, None, matrix,
            jnp.float32(SCALE), jnp.int32(col0), jnp.int32(BUCKET_DISABLED),
            resolution=RES, width=width, depth_channel=False, pad_group=pg)
        assert int(d) == 0
        acc = im if acc is None else acc + im
    _assert_close_image(acc, im_full)


def test_three_channels_match_scatter(presorted):
    """C=3 (the RGB renderer's shape) through the presorted path."""
    ps, values, layout, ps_p, vals_p = presorted
    rng = np.random.RandomState(11)
    v3 = np.stack([values[:, 0],
                   values[:, 0] * rng.random_sample(len(values)),
                   values[:, 0] * rng.random_sample(len(values))],
                  axis=1).astype(np.float32)
    matrix = _matrix()
    im, dropped = _direct(ps_p, layout.apply(v3), layout, matrix)
    assert int(dropped) == 0
    ref = splat.splat_scatter(jnp.asarray(ps), jnp.asarray(v3), matrix,
                              RES, SCALE)
    assert np.asarray(im).shape[-1] == 3
    _assert_matches_scatter(im, ref)


def test_mask_culls(presorted):
    """A per-particle cull mask through the presorted path removes the
    same particles as in the scatter path."""
    ps, values, layout, ps_p, vals_p = presorted
    matrix = _matrix()
    rng = np.random.RandomState(3)
    keep = rng.random_sample(len(ps)) < 0.5
    keep_p = layout.apply(keep.astype(np.float32)) > 0
    im, dropped = _direct(ps_p, vals_p, layout, matrix,
                          extra_mask=jnp.asarray(keep_p))
    assert int(dropped) == 0
    ref = splat.splat_scatter(jnp.asarray(ps), jnp.asarray(values), matrix,
                              RES, SCALE, extra_mask=jnp.asarray(keep))
    _assert_matches_scatter(im, ref)
    full, _ = _direct(ps_p, vals_p, layout, matrix)
    assert np.asarray(im)[..., 0].sum() < 0.6 * np.asarray(full)[..., 0].sum()
