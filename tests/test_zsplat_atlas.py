"""Front-most (z-buffered) atlas splatter vs the exact scatter-max
reference (ops/zsplat.py).

With matched pyramid levels the two paths implement identical hemisphere
depth-test semantics, so agreement is exact (to f32), including winner
selection; the product paths differ only in the presorted path's
1/8-octave bucket-derived level choice (same approximation as the additive
presorted splatter, tests/test_presorted.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from topsy_tpu import camera
from topsy_tpu.loaders import TestDataLoader
from topsy_tpu.ops import morton, zsplat, zsplat_atlas
from topsy_tpu.ops.splat import default_pyramid, levels_from_buckets

RES = 128
SCALE = 120.0


def _presorted(n=30000, seed=1337):
    loader = TestDataLoader(n, seed=seed)
    ps_np = loader.get_pos_smooth().astype(np.float32)
    mass = loader.get_mass()
    qty = loader.get_named_quantity("test-quantity")
    vals_np = np.stack([mass, qty], axis=1).astype(np.float32)
    layout = morton.build_presorted(ps_np)
    return (jnp.asarray(layout.apply(ps_np, fill=morton.PAD_POS)),
            jnp.asarray(layout.apply(vals_np)),
            jnp.asarray(layout.buckets))


def _matrix(rot_deg=0.0):
    import scipy.spatial.transform as sst
    rot = sst.Rotation.from_euler("xy", [rot_deg, rot_deg * 0.6],
                                  degrees=True).as_matrix()
    return jnp.asarray(camera.world_to_clip_matrix(rot, np.zeros(3), SCALE),
                       jnp.float32)


@pytest.mark.parametrize("rot_deg", [0.0, 30.0])
def test_matches_scatter_matched_levels(rot_deg):
    ps, vals, buckets = _presorted()
    m = _matrix(rot_deg)
    pyr = default_pyramid(RES)
    lev_o = levels_from_buckets(buckets, RES / (2 * SCALE), pyr.num_levels)

    im_ref = np.asarray(zsplat.zsplat_scatter(ps, vals, m, RES, SCALE,
                                              level_override=lev_o))
    im_new, dropped = zsplat_atlas.zsplat_atlas(ps, vals, m, RES, SCALE,
                                                buckets)
    im_new = np.asarray(im_new)
    assert int(dropped) == 0
    d_ref, d_new = im_ref[..., 1], im_new[..., 1]
    assert ((d_ref > 0) == (d_new > 0)).all()
    both = d_ref > 0
    np.testing.assert_allclose(d_new[both], d_ref[both], rtol=1e-5,
                               atol=1e-4)
    # identical winners everywhere
    assert np.isclose(im_new[..., 0][both], im_ref[..., 0][both],
                      rtol=1e-5, atol=1e-6).all()


def test_density_cut_respected():
    ps, vals, buckets = _presorted()
    m = _matrix()
    # clip h to keep pad sentinels (1e30) from overflowing the cube; pads
    # carry zero mass and are excluded below anyway
    rho = np.asarray(vals[:, 0]) / np.clip(np.asarray(ps[:, 3]),
                                           1e-30, 1e10) ** 3
    cut = float(np.quantile(rho[np.asarray(vals[:, 0]) > 0], 0.8))
    im_cut, d0 = zsplat_atlas.zsplat_atlas(ps, vals, m, RES, SCALE, buckets,
                                           density_cut=cut)
    im_all, d1 = zsplat_atlas.zsplat_atlas(ps, vals, m, RES, SCALE, buckets)
    assert int(d0) == 0 and int(d1) == 0
    # cutting reduces coverage
    assert (np.asarray(im_cut)[..., 1] > 0).sum() < \
        (np.asarray(im_all)[..., 1] > 0).sum()


def test_heavy_spill_scene_conserves_winners():
    """Interleaved distant clusters force group-window misfits en masse:
    the max-composite spill tiers must still find the same winners."""
    rng = np.random.RandomState(2)
    n = 4096
    ps_np = np.zeros((n, 4), dtype=np.float32)
    corners = np.array([[-80, -80], [80, -80], [-80, 80], [80, 80]])
    c = corners[np.arange(n) % 4]
    ps_np[:, 0] = c[:, 0] + rng.uniform(-15, 15, n)
    ps_np[:, 1] = c[:, 1] + rng.uniform(-15, 15, n)
    ps_np[:, 2] = rng.uniform(-40, 40, n)
    ps_np[:, 3] = rng.uniform(2.0, 6.0, n)
    vals_np = np.stack([np.ones(n), rng.uniform(0, 1, n)],
                       axis=1).astype(np.float32)
    layout = morton.build_presorted(ps_np)
    ps = jnp.asarray(layout.apply(ps_np, fill=morton.PAD_POS))
    vals = jnp.asarray(layout.apply(vals_np))
    buckets = jnp.asarray(layout.buckets)
    m = _matrix()
    pyr = default_pyramid(RES)
    lev_o = levels_from_buckets(buckets, RES / (2 * SCALE), pyr.num_levels)
    im_ref = np.asarray(zsplat.zsplat_scatter(ps, vals, m, RES, SCALE,
                                              level_override=lev_o))
    im_new, dropped = zsplat_atlas.zsplat_atlas(ps, vals, m, RES, SCALE,
                                                buckets)
    im_new = np.asarray(im_new)
    assert int(dropped) == 0
    both = im_ref[..., 1] > 0
    assert ((im_ref[..., 1] > 0) == (im_new[..., 1] > 0)).all()
    np.testing.assert_allclose(im_new[..., 1][both], im_ref[..., 1][both],
                               rtol=1e-5, atol=1e-4)


def test_surface_renderer_column_path():
    """The surface renderer's sort-free column path covers the surface and
    refines to the full front-most image."""
    import topsy_tpu
    from topsy_tpu.canvas import OffscreenCanvas
    from topsy_tpu.drawreason import DrawReason
    from topsy_tpu.progression import RenderProgressionColumns

    vis = topsy_tpu.test(20000, render_resolution=96,
                         canvas_class=OffscreenCanvas)
    vis.show_status = False
    vis.render_mode = "surface"
    sph = vis._sph
    sph.render(DrawReason.CHANGE)
    assert isinstance(sph.render_progression, RenderProgressionColumns)
    for _ in range(20):
        if not sph.needs_refine():
            break
        sph.render(DrawReason.REFINE)
    im_cols = np.asarray(sph.get_output_image()).copy()

    sph.render(DrawReason.EXPORT)
    im_export = np.asarray(sph.get_output_image())
    # full-coverage interactive == export (same path, same full column set)
    np.testing.assert_allclose(im_cols, im_export, rtol=1e-5, atol=1e-6)
    # the dense-core surface is present (the default 50th-percentile density
    # cut leaves a compact core at the default zoom — same coverage as the
    # scatter path, verified manually)
    assert (im_export[..., 1] > 0).mean() > 0.005
