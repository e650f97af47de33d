"""Measure the pyramid-collapse reconstruction bias per filter and level.

The density parity test (tests/test_reference_parity.py) decomposes its
mean-ratio deviation from the reference's committed pixels into (a) the
reference's own mip-sampled kernel texture (the exact evaluator
splat.splat_bruteforce sits at -0.0008 from their values) and (b) this
renderer's pyramid reconstruction bias.  This harness measures (b) in
isolation: the product render vs the exact evaluator on the parity scene
(TestDataLoader(1000), scale=200, 200px), for each collapse filter
(ops/composite._upsample2x_matrix) and per pyramid-level class.

Usage:
  python benchmarks/pyramid_bias.py            # all filters, one JSON line each
  python benchmarks/pyramid_bias.py spline     # one filter

Each line: {"filter": ..., "mean_bias": ..., "std": ..., "per_level": {...}}
mean_bias = mean(sampled product/exact ratio) - 1 on the [::20, ::20] grid.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

FILTERS = ("linear", "catmull", "spline")


def measure(filter_kind: str) -> dict:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    import topsy_tpu
    from topsy_tpu import config
    from topsy_tpu.drawreason import DrawReason
    from topsy_tpu.loaders import TestDataLoader
    from topsy_tpu.ops import splat, splat_atlas

    config.PYRAMID_COLLAPSE_FILTER = filter_kind

    n, res, scale = 1000, 200, 200.0
    vis = topsy_tpu.test(n, render_resolution=res, canvas_class=None)
    vis.scale = scale
    vis.render_sph(DrawReason.EXPORT)
    im = np.asarray(vis.get_sph_image())

    loader = TestDataLoader(n)
    ps = loader.get_pos_smooth().astype(np.float32)
    mass = loader.get_mass().astype(np.float32)[:, None]
    matrix = vis._sph._matrix()
    exact = np.asarray(splat.splat_bruteforce(ps, mass, matrix, res,
                                              scale))[:, :, 0]

    samp = np.s_[::20, ::20]
    ratio = im[samp] / exact[samp]
    out = {"filter": filter_kind,
           "mean_bias": round(float(ratio.mean() - 1.0), 6),
           "ratio_std": round(float(ratio.std()), 6)}

    # per-level decomposition: particles of one pyramid level at a time,
    # product path (splat_atlas, the same engine+collapse the Visualizer
    # uses) vs the exact evaluator on the same subset
    h_px = ps[:, 3] * (res / (2.0 * scale))
    pyramid = splat.default_pyramid(res)
    lev, _, tiny = splat.assign_levels(jnp.asarray(h_px), pyramid.num_levels)
    lev = np.where(np.asarray(tiny), -1, np.asarray(lev))  # -1 = CIC deposit
    per_level = {}
    for l in sorted(set(lev.tolist())):
        mask = lev == l
        im_l = np.asarray(splat_atlas.splat_atlas(
            jnp.asarray(ps), jnp.asarray(mass), jnp.asarray(matrix), res,
            scale, extra_mask=jnp.asarray(mask))[0])[:, :, 0]
        exact_l = np.asarray(splat.splat_bruteforce(
            ps[mask], mass[mask], matrix, res, scale))[:, :, 0]
        s_im, s_ex = im_l[samp], exact_l[samp]
        covered = s_ex > s_ex.max() * 1e-6
        r = s_im[covered] / s_ex[covered]
        area = (2.0 * scale / res) ** 2
        per_level[str(l)] = {
            "n_particles": int(mask.sum()),
            "mean_bias": round(float(r.mean() - 1.0), 6),
            "sampled_covered": int(covered.sum()),
            "mass_err": round(float(im_l.sum() / max(exact_l.sum(), 1e-30)
                                    - 1.0), 6),
            "_area": area,
        }
        del per_level[str(l)]["_area"]
    out["per_level"] = per_level
    return out


def main():
    if len(sys.argv) > 1 and sys.argv[1] in FILTERS:
        print(json.dumps(measure(sys.argv[1])))
        return
    # one subprocess per filter: the collapse filter is read at jit trace
    # time, so switching it in-process would hit stale compiled programs
    for f in FILTERS:
        subprocess.run([sys.executable, __file__, f], check=True)


if __name__ == "__main__":
    main()
