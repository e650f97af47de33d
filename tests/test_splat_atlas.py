import numpy as np
import pytest

import jax.numpy as jnp

from topsy_tpu import camera
from topsy_tpu.loaders import TestDataLoader
from topsy_tpu.ops import morton, splat, splat_atlas


RES = 128
SCALE = 200.0


def make_matrix(rot=None, offset=(0, 0, 0), scale=SCALE):
    return camera.world_to_clip_matrix(np.eye(3) if rot is None else rot,
                                       np.asarray(offset, dtype=float), scale)


def render_atlas(ps, vals, matrix, res=RES, scale=SCALE):
    im, dropped = splat_atlas.splat_atlas(jnp.asarray(ps), jnp.asarray(vals),
                                          jnp.asarray(matrix), res, scale)
    return np.asarray(im), int(dropped)


def render_path(path, ps, vals, matrix, res=RES, scale=SCALE):
    """The windowed engine through the per-frame sorted scan, or through
    the static presorted order (ops/morton.py) with its bucket levels."""
    if path == "scan":
        im, dropped = splat_atlas.splat_atlas(
            jnp.asarray(ps), jnp.asarray(vals), jnp.asarray(matrix), res,
            scale)
    else:
        layout = morton.build_presorted(np.asarray(ps, np.float32))
        im, dropped = splat_atlas.splat_atlas(
            jnp.asarray(layout.apply(np.asarray(ps, np.float32),
                                     fill=morton.PAD_POS)),
            jnp.asarray(layout.apply(np.asarray(vals, np.float32))),
            jnp.asarray(matrix), res, scale,
            presorted_buckets=jnp.asarray(layout.buckets))
    return np.asarray(im), int(dropped)


def render_scatter(ps, vals, matrix, res=RES, scale=SCALE):
    return np.asarray(splat.splat_scatter(jnp.asarray(ps), jnp.asarray(vals),
                                          jnp.asarray(matrix), res, scale))


def pixel_area(scale=SCALE, res=RES):
    return (2.0 * scale / res) ** 2


def test_atlas_single_particle_mass():
    for h in [4.0, 16.0, 60.0, 150.0]:
        ps = np.array([[0.0, 0.0, 0.0, h]], dtype=np.float32)
        vals = np.array([[3.0]], dtype=np.float32)
        im, dropped = render_atlas(ps, vals, make_matrix())
        assert dropped == 0
        total = im[:, :, 0].sum() * pixel_area()
        # giants render at full support: wings past the viewport edge carry
        # mass off screen, exactly as the reference's clipped quads do —
        # the exact evaluator gives the on-screen expectation
        expect = 3.0
        if h * RES / (2 * SCALE) > 8.0:
            from topsy_tpu.ops import splat
            bf = np.asarray(splat.splat_bruteforce(
                jnp.asarray(ps), jnp.asarray(vals),
                jnp.asarray(make_matrix()), RES, SCALE))[:, :, 0]
            expect = bf.sum() * pixel_area()
        assert total == pytest.approx(expect, rel=0.02), f"h={h}"
        ys, xs = np.mgrid[0:RES, 0:RES]
        assert (im[:, :, 0] * xs).sum() / im[:, :, 0].sum() == pytest.approx(63.5, abs=0.1)
        assert (im[:, :, 0] * ys).sum() / im[:, :, 0].sum() == pytest.approx(63.5, abs=0.1)


def test_atlas_matches_scatter_gmm():
    loader = TestDataLoader(20000, seed=1337)
    ps = loader.get_pos_smooth()
    mass = loader.get_mass()
    qty = loader.get_named_quantity("test-quantity")
    vals = np.stack([mass, mass * qty], axis=1)
    m = make_matrix()
    im_a, dropped = render_atlas(ps, vals, m)
    im_s = render_scatter(ps, vals, m)
    assert dropped == 0
    # same distribution (the two paths use slightly different kernel
    # evaluation — low-rank polynomials vs radial table)
    assert im_a[:, :, 0].mean() == pytest.approx(im_s[:, :, 0].mean(), rel=0.005)
    assert im_a[:, :, 0].std() == pytest.approx(im_s[:, :, 0].std(), rel=0.02)
    corr = np.corrcoef(im_a[:, :, 0].ravel(), im_s[:, :, 0].ravel())[0, 1]
    assert corr > 0.999
    # weighted-quantity channel agrees too
    valid = (im_a[:, :, 0] > im_a[:, :, 0].max() * 1e-3)
    qa = im_a[:, :, 1][valid] / im_a[:, :, 0][valid]
    qs = im_s[:, :, 1][valid] / im_s[:, :, 0][valid]
    assert np.median(np.abs(qa - qs)) < 2e-7


@pytest.mark.parametrize("path", ["scan", "presorted"])
def test_atlas_sparse_scene_spills_but_conserves(path):
    """Very sparse scenes exercise the spill pass; mass must be conserved."""
    rng = np.random.RandomState(0)
    n = 300
    ps = np.zeros((n, 4), dtype=np.float32)
    ps[:, :3] = rng.uniform(-150, 150, (n, 3))
    ps[:, 3] = rng.uniform(3.0, 8.0, n)  # small splats at level 0, sparse
    vals = np.ones((n, 1), dtype=np.float32)
    im, dropped = render_path(path, ps, vals, make_matrix())
    assert dropped == 0
    ref = render_scatter(ps, vals, make_matrix())
    assert im[:, :, 0].sum() == pytest.approx(ref[:, :, 0].sum(), rel=0.01)
    corr = np.corrcoef(im[:, :, 0].ravel(), ref[:, :, 0].ravel())[0, 1]
    assert corr > 0.999


def test_non_power_of_two_resolution_mass_exact():
    """Level upsampling must be an exact 2x (then crop) so odd resolutions
    conserve mass (regression: floor-sized levels inflated it ~1.5%)."""
    rng = np.random.RandomState(0)
    n = 2000
    ps = np.zeros((n, 4), dtype=np.float32)
    ps[:, :3] = rng.uniform(-80, 80, (n, 3))
    ps[:, 3] = rng.uniform(0.2, 30.0, n)
    vals = np.ones((n, 1), dtype=np.float32)
    for res in (333, 250):
        im, dropped = splat_atlas.splat_atlas(
            jnp.asarray(ps), jnp.asarray(vals),
            jnp.asarray(make_matrix()), res, SCALE)
        pix = (2 * SCALE / res) ** 2
        assert int(dropped) == 0
        assert float(np.asarray(im[:, :, 0]).sum()) * pix / n == \
            pytest.approx(1.0, rel=0.005)


def test_atlas_z_culling_and_mask():
    ps = np.array([[0.0, 0.0, 0.0, 5.0],
                   [0.0, 0.0, 500.0, 5.0]], dtype=np.float32)  # second z-culled
    vals = np.ones((2, 1), dtype=np.float32)
    im, _ = render_atlas(ps, vals, make_matrix())
    assert im.sum() * pixel_area() == pytest.approx(1.0, rel=0.02)

    mask = jnp.asarray([False, True])
    im2, _ = splat_atlas.splat_atlas(jnp.asarray(ps), jnp.asarray(vals),
                                     jnp.asarray(make_matrix()), RES, SCALE,
                                     extra_mask=mask)
    assert float(np.asarray(im2).sum()) == 0.0


@pytest.mark.parametrize("path", ["scan", "presorted"])
def test_atlas_giant_splats_masked_path(path):
    """Splats whose smoothing clamps above SPLAT_MAX_HALF_SIZE_PX at the
    coarsest level take the footprint-masked kernel path; the truncation is
    exactly compensated by the normalization table (mass conserved)."""
    rng = np.random.RandomState(1)
    n = 600
    ps = np.zeros((n, 4), dtype=np.float32)
    ps[:, :3] = rng.uniform(-60, 60, (n, 3))
    # smoothing spanning moderate to box-scale: the largest land on the
    # clamped coarsest level (h_eff in (3.5, 16])
    ps[:, 3] = np.exp(rng.uniform(np.log(5.0), np.log(400.0), n)).astype(np.float32)
    vals = np.ones((n, 1), dtype=np.float32)
    im, dropped = render_path(path, ps, vals, make_matrix())
    assert dropped == 0
    ref = render_scatter(ps, vals, make_matrix())
    # mass parity with the exact-giant scatter path (full-support giants
    # lose their off-screen wings, so the total is below n where supports
    # cross the viewport — identically in both engines)
    assert im[:, :, 0].sum() == pytest.approx(ref[:, :, 0].sum(), rel=0.03)
    corr = np.corrcoef(im[:, :, 0].ravel(), ref[:, :, 0].ravel())[0, 1]
    assert corr > 0.995


@pytest.mark.parametrize("path", ["scan", "presorted"])
def test_atlas_heavy_spill_stress(path):
    """A scene engineered so group windows misfit en masse (alternating
    distant clusters interleaved in memory): the group-gathered spill tiers
    must still conserve mass and match the exact scatter path."""
    rng = np.random.RandomState(2)
    n = 4096
    ps = np.zeros((n, 4), dtype=np.float32)
    # interleave four corners so consecutive particles are far apart and no
    # 512-group fits one accumulation window
    corners = np.array([[-120, -120], [120, -120], [-120, 120], [120, 120]])
    c = corners[np.arange(n) % 4]
    ps[:, 0] = c[:, 0] + rng.uniform(-20, 20, n)
    ps[:, 1] = c[:, 1] + rng.uniform(-20, 20, n)
    ps[:, 2] = rng.uniform(-50, 50, n)
    ps[:, 3] = rng.uniform(2.0, 6.0, n)
    vals = np.ones((n, 1), dtype=np.float32)
    im, dropped = render_path(path, ps, vals, make_matrix())
    assert dropped == 0
    ref = render_scatter(ps, vals, make_matrix())
    assert im[:, :, 0].sum() == pytest.approx(ref[:, :, 0].sum(), rel=0.01)
    corr = np.corrcoef(im[:, :, 0].ravel(), ref[:, :, 0].ravel())[0, 1]
    assert corr > 0.999
