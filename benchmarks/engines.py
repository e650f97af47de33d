"""Time the splat engines and the smoothing-length search on one card.

Each pair runs in one process, on one card, warm (compiles excluded),
median of several runs ending in ``jax.block_until_ready``:

* additive EXPORT at 2^N particles, 1024^2, C=2: the presorted windowed
  scan engine (the renderer's EXPORT path) against ``splat.splat_scatter``
  over the same particles in pieces of 2^21 rows, and the scan engine's
  image error against the scatter reference (at HIGHEST precision) with
  the deposit matmul at HIGHEST and at DEFAULT precision;
* surface EXPORT at 2^(N-2) particles: the front-most atlas engine against
  the block path through ``zsplat.zsplat_scatter``;
* kNN smoothing lengths at 2^18 and 2^20: ``ops/knn_device`` against the
  host search (``topsy_tpu.native``).

Prints one line per measurement and writes them to
``chiprun_out/engines.json``.

Usage:  python benchmarks/engines.py [--log2n 24] [--reps 5]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

RESULTS = {}


def record(key, value):
    value = value.item() if hasattr(value, "item") else value
    RESULTS[key] = value
    print(f"{key} = {value!r}", flush=True)


def timed(fn, reps):
    """(cold seconds, median warm seconds) of fn(), each ending in a
    block_until_ready of its result."""
    import jax
    import numpy as np
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    cold = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        warm.append(time.perf_counter() - t0)
    return cold, float(np.median(warm)), out


def additive(log2n, reps):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from topsy_tpu.canvas import OffscreenCanvas
    from topsy_tpu.drawreason import DrawReason
    from topsy_tpu.loaders import TestDataDeviceLoader
    from topsy_tpu.ops import splat, splat_atlas
    from topsy_tpu.visualizer import Visualizer

    n, res = 1 << log2n, 1024
    vis = Visualizer(data_loader_class=TestDataDeviceLoader,
                     data_loader_args=(n,), data_loader_kwargs={"seed": 1337},
                     render_resolution=res, canvas_class=OffscreenCanvas)
    vis.show_status = vis.show_colorbar = vis.show_scalebar = False
    vis.quantity_name = "test-quantity"
    vis.store.ensure_presorted()
    sph = vis._sph

    def export():
        sph.render(DrawReason.EXPORT)
        return sph.get_output_image()

    store = vis.store
    matrix = jnp.asarray(sph._matrix(), jnp.float32)
    scale = float(sph.scale)
    ps, vals = store.pos_smooth, store.values_for("mass_and_quantity")
    piece = 1 << 21
    ref_fn = jax.jit(lambda p, v, m: splat.splat_scatter(p, v, m, res, scale))

    def scatter():
        out = None
        for s in range(0, ps.shape[0], piece):
            im = ref_fn(ps[s:s + piece], vals[s:s + piece], matrix)
            out = im if out is None else out + im
        return out

    _, t_scatter, _ = timed(scatter, max(1, reps // 2))
    record("additive.scatter_export_s", t_scatter)
    with jax.default_matmul_precision("highest"):
        ref_fn = jax.jit(
            lambda p, v, m: splat.splat_scatter(p, v, m, res, scale))
        ref = np.asarray(jax.block_until_ready(scatter()))

    chosen = splat_atlas.DEPOSIT_PRECISION
    for name, prec in (("highest", jax.lax.Precision.HIGHEST),
                       ("default", jax.lax.Precision.DEFAULT)):
        splat_atlas.DEPOSIT_PRECISION = prec
        jax.clear_caches()
        cold, warm, im = timed(export, reps)
        im = np.asarray(im)
        a0, s0 = im[..., 0].astype(np.float64), ref[..., 0].astype(np.float64)
        record(f"additive.scan_export_{name}.cold_s", cold)
        record(f"additive.scan_export_{name}.warm_s", warm)
        record(f"additive.scan_export_{name}.dropped",
               sph.last_dropped_splats)
        record(f"additive.scan_export_{name}.mean_rel",
               abs(a0.mean() / s0.mean() - 1.0))
        record(f"additive.scan_export_{name}.std_rel",
               abs(a0.std() / s0.std() - 1.0))
        record(f"additive.scan_export_{name}.corr",
               float(np.corrcoef(a0.ravel(), s0.ravel())[0, 1]))
        valid = a0 > a0.max() * 1e-3
        qa = im[..., 1][valid] / im[..., 0][valid]
        qs = ref[..., 1][valid] / ref[..., 0][valid]
        record(f"additive.scan_export_{name}.quantity_median",
               float(np.median(np.abs(qa - qs))))
    splat_atlas.DEPOSIT_PRECISION = chosen
    jax.clear_caches()


def surface(log2n, reps):
    import jax
    import jax.numpy as jnp

    from topsy_tpu.canvas import OffscreenCanvas
    from topsy_tpu.loaders import TestDataDeviceLoader
    from topsy_tpu.ops import zsplat_atlas
    from topsy_tpu.render.surface import _render_block_surface
    from topsy_tpu.visualizer import Visualizer

    n, res = 1 << log2n, 1024
    vis = Visualizer(data_loader_class=TestDataDeviceLoader,
                     data_loader_args=(n,), data_loader_kwargs={"seed": 7},
                     render_resolution=res, canvas_class=OffscreenCanvas,
                     render_mode="surface")
    vis.show_status = vis.show_colorbar = vis.show_scalebar = False
    vis.quantity_name = "test-quantity"
    sph, store = vis._sph, vis.store
    store.ensure_presorted()
    cut = jnp.float32(sph._density_cut_value())
    matrix = jnp.asarray(sph._matrix(), jnp.float32)
    scale = jnp.float32(sph.scale)
    ps = store.pos_smooth_presorted
    vals = store.presorted_values_for("surface_values")
    buckets = store.presorted_buckets
    engine = jax.jit(lambda p, v, b, m, s, c: zsplat_atlas.zsplat_atlas(
        p, v, m, res, s, b, density_cut=c))
    cold, warm, _ = timed(lambda: engine(ps, vals, buckets, matrix, scale,
                                         cut), reps)
    record("surface.atlas_export.cold_s", cold)
    record("surface.atlas_export.warm_s", warm)
    values = store.values_for("surface_values")
    cold, warm, _ = timed(lambda: _render_block_surface(
        store.pos_smooth, values, store.cell_ids, store.cell_mask_table(None),
        matrix, scale, cut, jnp.int32(0), jnp.int32(store.n),
        resolution=res, bucket=store.n_pad), max(1, reps // 2))
    record("surface.scatter_block.cold_s", cold)
    record("surface.scatter_block.warm_s", warm)


def knn(reps, sizes=(18, 20)):
    import numpy as np

    from topsy_tpu import native
    from topsy_tpu.loaders import TestDataLoader
    from topsy_tpu.ops.knn_device import knn_smooth_device

    for log2n in sizes:
        pos = TestDataLoader(1 << log2n, seed=5).get_pos_smooth()[:, :3]
        pos = np.ascontiguousarray(pos, np.float32)
        t0 = time.perf_counter()
        h_host = native.knn_smooth(pos, 64)
        record(f"knn.2^{log2n}.host_first_s", time.perf_counter() - t0)
        if h_host is not None:
            t0 = time.perf_counter()
            native.knn_smooth(pos, 64)
            record(f"knn.2^{log2n}.host_s", time.perf_counter() - t0)
        cold, warm, h_dev = timed(lambda: knn_smooth_device(pos, 64),
                                  max(1, reps // 2))
        record(f"knn.2^{log2n}.device_cold_s", cold)
        record(f"knn.2^{log2n}.device_warm_s", warm)
        if h_host is not None:
            rel = np.abs(np.asarray(h_dev) / h_host - 1.0)
            record(f"knn.2^{log2n}.max_rel_diff", float(rel.max()))


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--log2n", type=int, default=24)
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--only", choices=("additive", "surface", "knn"),
                        default=None)
    args = parser.parse_args()

    import jax
    if jax.default_backend() != "gpu":
        raise SystemExit("engines: no GPU")
    from topsy_tpu.util import enable_persistent_compile_cache
    enable_persistent_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    record("card", smi)
    record("device_kind", jax.devices()[0].device_kind)
    if args.only in (None, "additive"):
        additive(args.log2n, args.reps)
    if args.only in (None, "surface"):
        surface(args.log2n - 2, args.reps)
    if args.only in (None, "knn"):
        knn(args.reps)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "engines.json"), "w") as f:
        json.dump(RESULTS, f, indent=1)


if __name__ == "__main__":
    main()
