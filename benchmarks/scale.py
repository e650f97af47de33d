"""Scale validation of the product paths at large particle counts.

Runs the PRODUCT paths (Visualizer + store + presorted piece loop) at
2^24-2^26 particles on the card and reports phase timings as JSON:
snapshot generation, presort build (native radix), device upload + first
EXPORT (compile included), steady-state EXPORT throughput, and interactive
CHANGE-frame latency at the same scale.

Usage: python benchmarks/scale.py [log2_n] [resolution] [--host-loader]

The snapshot is generated ON DEVICE by default (TestDataDeviceLoader, as
bench.py does): the host GMM sampler costs minutes of single-core time at
2^26, none of which touches the measured phases.  --host-loader restores
the host path (construct_s then includes generation + upload).

Every timed region ends in ``jax.block_until_ready``.
"""

from __future__ import annotations

import json
import sys
import time


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    log2n = int(args[0]) if args else 26
    resolution = int(args[1]) if len(args) > 1 else 1024
    n = 1 << log2n

    import jax
    import numpy as np

    import topsy_tpu
    from topsy_tpu.canvas import OffscreenCanvas
    from topsy_tpu.drawreason import DrawReason
    from topsy_tpu.util import enable_persistent_compile_cache

    enable_persistent_compile_cache()
    out = {"n": n, "resolution": resolution}

    t0 = time.perf_counter()
    if "--host-loader" in sys.argv:
        vis = topsy_tpu.test(n, render_resolution=resolution,
                             canvas_class=OffscreenCanvas)
    else:
        from topsy_tpu.loaders import TestDataDeviceLoader
        from topsy_tpu.visualizer import Visualizer
        vis = Visualizer(data_loader_class=TestDataDeviceLoader,
                         data_loader_args=(n,),
                         data_loader_kwargs={"seed": 1337},
                         render_resolution=resolution,
                         canvas_class=OffscreenCanvas)
    out["construct_s"] = round(time.perf_counter() - t0, 3)

    # presort build (the one-time host cost of the sort-free order)
    t0 = time.perf_counter()
    vis.store.ensure_presorted()
    out["presort_build_s"] = round(time.perf_counter() - t0, 3)
    layout = vis.store.presorted_layout
    out["presort_slots"] = int(layout.n_out)
    out["presort_pad_frac"] = round(layout.n_out / n - 1.0, 4)

    # first EXPORT pays upload + compile
    t0 = time.perf_counter()
    im = vis.get_sph_image()
    out["first_export_s"] = round(time.perf_counter() - t0, 3)
    assert np.isfinite(np.asarray(im)[~np.isnan(np.asarray(im))]).all()

    # steady-state EXPORT (full-coverage render, piece loop included)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        vis._sph.render(DrawReason.EXPORT)
        jax.block_until_ready(vis._sph._image)
        best = min(best, time.perf_counter() - t0)
    out["export_s"] = round(best, 4)
    out["export_msplats_per_s"] = round(n / best / 1e6, 1)

    # interactive CHANGE frames (sort-free column LOD under the frame
    # budget; report the adaptive steady state).  Interactive frames run
    # BARRIER-FREE: render() enqueues the whole-tier launch and the
    # frame's single natural barrier (here block_until_ready; in
    # the product UI the presentation readback) both completes the frame
    # and supplies the LOD scheduler's timing via notify_frame_time — one
    # host round-trip per frame total.
    for i in range(5):
        vis.rotate(0.02, 0.0)
        t0 = time.perf_counter()
        vis._sph.render(DrawReason.CHANGE)
        jax.block_until_ready(vis._sph._image)
        dt = time.perf_counter() - t0
        # first warmup frames pay one-time compiles; don't let those
        # crater the LOD recommendation before the steady-state frames
        vis._sph.notify_frame_time(min(dt, 0.1) if i < 2 else dt)
    times = []
    for _ in range(10):
        vis.rotate(0.02, 0.0)
        t0 = time.perf_counter()
        vis._sph.render(DrawReason.CHANGE)
        jax.block_until_ready(vis._sph._image)
        dt = time.perf_counter() - t0
        times.append(dt)
        # feed the frame's measured time back as the scheduler's deferred
        # feedback.  Median, because any frame that hits an uncached
        # column width pays a one-time compile.
        vis._sph.notify_frame_time(dt)
    out["interactive_ms_median"] = round(1e3 * sorted(times)[len(times) // 2],
                                         2)
    out["interactive_fps_median"] = round(
        1.0 / max(sorted(times)[len(times) // 2], 1e-9), 1)

    # spill / dropped accounting at this scale (the windowed engines report
    # particles whose deposits could not be placed; must be 0 in steady
    # state)
    dropped = getattr(vis._sph, "_dropped_splats", None)
    out["interactive_dropped_splats"] = (int(dropped)
                                         if dropped is not None else 0)

    # REFINE to full coverage: walks the remaining tiers incl. the full
    # main-layout column launch
    refine_frames = 0
    refine_dropped = 0
    t0 = time.perf_counter()
    while vis._sph.needs_refine() and refine_frames < 8:
        vis._sph.render(DrawReason.REFINE)
        jax.block_until_ready(vis._sph._image)
        vis._sph.notify_frame_time(0.01)
        refine_dropped += vis._sph.last_dropped_splats
        refine_frames += 1
    out["refine_frames_to_full"] = refine_frames
    out["refine_total_s"] = round(time.perf_counter() - t0, 3)
    out["refine_dropped_splats"] = refine_dropped
    out["refined_fully"] = not vis._sph.needs_refine()

    vis._sph.render(DrawReason.EXPORT)
    jax.block_until_ready(vis._sph._image)
    dropped = getattr(vis._sph, "_dropped_splats", None)
    out["export_dropped_splats"] = (int(dropped)
                                    if dropped is not None else 0)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
