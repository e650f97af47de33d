"""Smoke test of the render path on one GPU, at full size.

Drives the normal entry points in one process — Visualizer, ParticleStore,
progression, renderers, the splat engines and the CLI — on random seeded
snapshots, and compares each engine's image with the plain reference:

1. device: the card (nvidia-smi name and power limit), JAX and its devices;
2. univariate EXPORT of 2^24 particles at 1024^2, two channels;
3. the same particles through ``ops/splat.splat_scatter``;
4. interactive CHANGE frames along a seeded rotation, then REFINE frames to
   full coverage, compared with the EXPORT image;
5. surface EXPORT of 2^22 particles, and the front-most atlas engine
   against ``ops/zsplat.zsplat_scatter`` at matched levels;
6. the CLI (``topsy_tpu.main``) in-process.

With ``--four-cards`` only the mesh path runs (phase 7): a 2^25 snapshot
over ``make_mesh(4)`` in presorted EXPORT and a column CHANGE frame,
compared with single-card launches over the same presorted layout.

The last line of standard output is one JSON object
``{"ok": true, "device": {"platform", "kind", "count"}}``.  Without a GPU,
on a failed phase or a missed tolerance the script exits non-zero and
prints no such line.

Usage:  python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time


class Checks:
    """Collects every comparison; any miss fails the run at the end."""

    def __init__(self):
        self.failed = []

    def __call__(self, name, value, ok, limit):
        value = value.item() if hasattr(value, "item") else value
        print(f"  {name} = {value!r}  (limit: {limit})  "
              f"{'ok' if ok else 'MISSED'}", flush=True)
        if not ok:
            self.failed.append(name)


def log(msg):
    print(msg, flush=True)


def _sync(x):
    import jax
    return jax.block_until_ready(x)


def _peak_bytes():
    import jax
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def require_platform(platform: str):
    """Exit non-zero unless JAX's default backend is ``platform``."""
    import jax
    backend = jax.default_backend()
    if backend != platform:
        raise SystemExit(f"chip_smoke: JAX found no {platform} "
                         f"(default backend {backend!r})")


def host_packages() -> dict:
    """Whether the optional host packages import (the device phases need
    neither)."""
    import importlib
    found = {}
    for name in ("matplotlib", "cv2"):
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    return found


def phase_device():
    import jax
    import jaxlib
    log("phase 1: device")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        smi = f"unavailable ({e})"
    log("  nvidia-smi --query-gpu=name,power.limit:")
    log(smi)  # verbatim, one line per card
    log(f"  jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    log(f"  devices: {jax.devices()}")
    log(f"  device_kind: {jax.devices()[0].device_kind}")
    pk = host_packages()
    log(f"  host packages: matplotlib={pk['matplotlib']} cv2={pk['cv2']}")


def _overlays_off_without_matplotlib():
    """Text, scalebar and colorbar overlays rasterize with matplotlib."""
    from topsy_tpu.visualizer import Visualizer
    if not host_packages()["matplotlib"]:
        Visualizer.show_status = False
        Visualizer.show_colorbar = False
        Visualizer.show_scalebar = False


def phase_export(n: int, resolution: int, check: Checks):
    """Phase 2: univariate EXPORT through the Visualizer (bench config)."""
    import numpy as np

    from topsy_tpu.canvas import OffscreenCanvas
    from topsy_tpu.drawreason import DrawReason
    from topsy_tpu.loaders import TestDataDeviceLoader
    from topsy_tpu.visualizer import Visualizer

    log(f"phase 2: univariate EXPORT, n={n}, {resolution}^2, C=2")
    t0 = time.perf_counter()
    vis = Visualizer(data_loader_class=TestDataDeviceLoader,
                     data_loader_args=(n,),
                     data_loader_kwargs={"seed": 1337},
                     render_resolution=resolution,
                     canvas_class=OffscreenCanvas)
    vis.quantity_name = "test-quantity"
    vis.scale = 200.0
    vis.store.ensure_presorted()
    t_setup = time.perf_counter() - t0
    sph = vis._sph
    times = []
    for _ in range(2):
        t1 = time.perf_counter()
        sph.render(DrawReason.EXPORT)
        _sync(sph.get_output_image())
        times.append(time.perf_counter() - t1)
    image = np.asarray(sph.get_output_image())
    log(f"  setup (data, first renders, presort) {t_setup:.3f} s")
    log(f"  cold EXPORT (setup + first EXPORT) {t_setup + times[0]:.3f} s; "
        f"first EXPORT {times[0]:.4f} s")
    log(f"  warm EXPORT {times[1]:.4f} s = {n / times[1]:.4g} splats/s")
    check("EXPORT dropped splats", sph.last_dropped_splats,
          sph.last_dropped_splats == 0, "== 0")
    check("EXPORT image finite", bool(np.isfinite(image).all()),
          bool(np.isfinite(image).all()), "all finite")
    vis.get_sph_image()
    frame = vis.get_presentation_image((resolution, resolution))
    log(f"  presentation frame {frame.shape} {frame.dtype}")
    check("presentation frame shape", frame.shape,
          frame.shape == (resolution, resolution, 4),
          f"({resolution}, {resolution}, 4)")
    log(f"  peak_bytes_in_use {_peak_bytes()}")
    return vis, image, times[1]


def compare_with_scatter(vis, image, check: Checks, piece: int):
    """Phase 3: the same particles through splat.splat_scatter, in pieces
    summed, at HIGHEST matmul precision.

    ``piece``: rows per reference launch.  splat_scatter materializes a
    WINDOW^2 = 16^2 window per particle, so a piece holds piece * 256 * C
    update elements: 2^31 at 2^22 rows and C=2, past the 2^31 - 1 elements
    an array may index with int32.  Pieces of 2^21 rows stay at 2^30
    elements (4 GiB of float32 updates, 2 GiB of int32 indices), well
    inside one card."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from topsy_tpu.ops import splat

    store, sph = vis.store, vis._sph
    res = sph.resolution
    matrix = jnp.asarray(sph._matrix(), jnp.float32)
    scale = float(sph.scale)
    ps, vals = store.pos_smooth, store.values_for("mass_and_quantity")
    log(f"phase 3: splat_scatter reference, {ps.shape[0]} rows in pieces "
        f"of {piece}")
    ref_fn = jax.jit(lambda p, v, m: splat.splat_scatter(p, v, m, res, scale))
    t0 = time.perf_counter()
    ref = None
    with jax.default_matmul_precision("highest"):
        for s in range(0, ps.shape[0], piece):
            im = ref_fn(ps[s:s + piece], vals[s:s + piece], matrix)
            ref = im if ref is None else ref + im
        ref = np.asarray(_sync(ref))
    log(f"  reference {time.perf_counter() - t0:.3f} s (incl. compile)")
    return scatter_criteria(image, ref, check, "phase 3"), ref


def scatter_criteria(im_a, im_s, check: Checks, tag: str):
    """The criteria of tests/test_splat_atlas.py::test_atlas_matches_scatter_gmm."""
    import numpy as np
    a0, s0 = im_a[..., 0].astype(np.float64), im_s[..., 0].astype(np.float64)
    mean_rel = abs(a0.mean() / s0.mean() - 1.0)
    std_rel = abs(a0.std() / s0.std() - 1.0)
    corr = float(np.corrcoef(a0.ravel(), s0.ravel())[0, 1])
    check(f"{tag} channel-0 mean rel. diff", mean_rel, mean_rel <= 0.005,
          "<= 0.005")
    check(f"{tag} channel-0 std rel. diff", std_rel, std_rel <= 0.02,
          "<= 0.02")
    check(f"{tag} pixel correlation", corr, corr > 0.999, "> 0.999")
    valid = a0 > a0.max() * 1e-3
    qa = im_a[..., 1][valid] / im_a[..., 0][valid]
    qs = im_s[..., 1][valid] / im_s[..., 0][valid]
    med = float(np.median(np.abs(qa - qs)))
    log(f"  {tag} weighted-quantity median |diff| = {med!r}  (stated; the "
        f"CPU test holds 20000 particles at 128^2 to 2e-7)")
    return dict(mean_rel=mean_rel, std_rel=std_rel, corr=corr,
                quantity_median=med)


def phase_interactive(vis, export_image, check: Checks, n_change: int = 10,
                      max_refine: int = 400):
    """Phase 4: CHANGE frames along a seeded rotation, each presented (the
    presentation readback is the frame's barrier), then REFINE frames to
    full coverage; the refined image must reproduce the EXPORT image."""
    import numpy as np

    from topsy_tpu.camera import x_rotation_matrix, y_rotation_matrix
    from topsy_tpu.drawreason import DrawReason

    log(f"phase 4: interactive, {n_change} CHANGE frames + REFINE")
    sph = vis._sph
    res = sph.resolution
    rot0 = np.asarray(vis.rotation_matrix)
    rng = np.random.RandomState(42)
    frame_times, coverage = [], []
    for k in range(n_change):
        ax, ay = rng.uniform(-0.05, 0.05, 2)
        vis.rotation_matrix = (x_rotation_matrix(ax) @ y_rotation_matrix(ay)
                               @ np.asarray(vis.rotation_matrix))
        t0 = time.perf_counter()
        vis.draw(DrawReason.CHANGE, target=(res, res))
        frame_times.append(time.perf_counter() - t0)
        coverage.append(1.0 / sph.last_render_mass_scale)
    log(f"  CHANGE frame times (s): {[round(t, 5) for t in frame_times]}")
    log(f"  CHANGE median {np.median(frame_times):.5f} s, max "
        f"{max(frame_times):.5f} s (first frames include compiles)")
    if len(frame_times) > 3:
        log(f"  CHANGE median after the first 3: "
            f"{np.median(frame_times[3:]):.5f} s")
    log(f"  CHANGE coverage: {[round(c, 4) for c in coverage]}")
    check("CHANGE dropped splats", sph.last_dropped_splats,
          sph.last_dropped_splats == 0, "== 0")

    # back to the EXPORT view, then refine it to full coverage
    vis.rotation_matrix = rot0
    vis.draw(DrawReason.CHANGE, target=(res, res))
    n_refine = 0
    t0 = time.perf_counter()
    dropped = 0
    while sph.needs_refine() and n_refine < max_refine:
        vis.draw(DrawReason.REFINE, target=(res, res))
        dropped = max(dropped, sph.last_dropped_splats)
        n_refine += 1
    t_refine = time.perf_counter() - t0
    cov = 1.0 / sph.last_render_mass_scale
    log(f"  {n_refine} REFINE frames in {t_refine:.3f} s, coverage {cov:.6f}")
    check("REFINE reached full coverage", not sph.needs_refine(),
          not sph.needs_refine(), f"within {max_refine} frames")
    check("REFINE dropped splats", dropped, dropped == 0, "== 0")
    im_cols = np.asarray(sph.get_output_image())
    s_rel = abs(im_cols[..., 0].sum() / export_image[..., 0].sum() - 1.0)
    corr = float(np.corrcoef(im_cols[..., 0].ravel(),
                             export_image[..., 0].ravel())[0, 1])
    check("REFINE vs EXPORT channel-0 sum rel. diff", s_rel, s_rel <= 1e-4,
          "<= 1e-4")
    check("REFINE vs EXPORT correlation", corr, corr > 0.9999, "> 0.9999")
    return dict(frame_times=frame_times, coverage=coverage,
                n_refine=n_refine)


def phase_surface(n: int, resolution: int, check: Checks):
    """Phase 5: surface EXPORT through the Visualizer, and the front-most
    atlas engine against the scatter-max reference at matched levels."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from topsy_tpu.canvas import OffscreenCanvas
    from topsy_tpu.drawreason import DrawReason
    from topsy_tpu.loaders import TestDataDeviceLoader
    from topsy_tpu.ops import zsplat, zsplat_atlas
    from topsy_tpu.ops.splat import default_pyramid, levels_from_buckets
    from topsy_tpu.visualizer import Visualizer

    log(f"phase 5: surface EXPORT, n={n}, {resolution}^2")
    t0 = time.perf_counter()
    vis = Visualizer(data_loader_class=TestDataDeviceLoader,
                     data_loader_args=(n,),
                     data_loader_kwargs={"seed": 7},
                     render_resolution=resolution,
                     canvas_class=OffscreenCanvas, render_mode="surface")
    vis.quantity_name = "test-quantity"
    sph = vis._sph
    times = []
    for _ in range(2):
        t1 = time.perf_counter()
        sph.render(DrawReason.EXPORT)
        _sync(sph.get_output_image())
        times.append(time.perf_counter() - t1)
    log(f"  setup + first surface EXPORT {time.perf_counter() - t0 - times[1]:.3f} s; "
        f"warm surface EXPORT {times[1]:.4f} s")
    check("surface EXPORT dropped splats", sph.last_dropped_splats,
          sph.last_dropped_splats == 0, "== 0")
    im = np.asarray(sph.get_output_image())
    covered = float((im[..., 1] > 0).mean())
    check("surface EXPORT covered fraction", covered,
          bool(np.isfinite(im).all()) and covered > 0.001,
          "finite, > 0.001")

    store = vis.store
    ps = store.pos_smooth_presorted
    vals = store.presorted_values_for("surface_values")
    buckets = store.presorted_buckets
    cut = jnp.float32(sph._density_cut_value())
    matrix = jnp.asarray(sph._matrix(), jnp.float32)
    scale = float(sph.scale)
    pyr = default_pyramid(resolution)
    lev = levels_from_buckets(buckets, resolution / (2 * scale),
                              pyr.num_levels)
    engine = jax.jit(lambda p, v, b, m, c: zsplat_atlas.zsplat_atlas(
        p, v, m, resolution, scale, b, density_cut=c))
    ref_fn = jax.jit(lambda p, v, m, c, lv: zsplat.zsplat_scatter(
        p, v, m, resolution, scale, density_cut=c, level_override=lv))
    t1 = time.perf_counter()
    im_new, dropped = _sync(engine(ps, vals, buckets, matrix, cut))
    log(f"  zsplat_atlas {time.perf_counter() - t1:.3f} s (incl. compile)")
    t1 = time.perf_counter()
    im_ref = _sync(ref_fn(ps, vals, matrix, cut, lev))
    log(f"  zsplat_scatter {time.perf_counter() - t1:.3f} s (incl. compile)")
    im_new, im_ref = np.asarray(im_new), np.asarray(im_ref)
    check("zsplat_atlas dropped splats", int(dropped), int(dropped) == 0,
          "== 0")
    return surface_criteria(im_new, im_ref, check, "phase 5"), vis


def surface_criteria(im_new, im_ref, check: Checks, tag: str):
    """The criteria of tests/test_zsplat_atlas.py::
    test_matches_scatter_matched_levels."""
    import numpy as np
    d_new, d_ref = im_new[..., 1], im_ref[..., 1]
    cov_diff = int(((d_ref > 0) != (d_new > 0)).sum())
    check(f"{tag} coverage mismatches", cov_diff, cov_diff == 0, "== 0")
    both = (d_ref > 0) & (d_new > 0)
    dd = np.abs(d_new[both] - d_ref[both])
    depth_ok = bool((dd <= 1e-4 + 1e-5 * np.abs(d_ref[both])).all())
    check(f"{tag} max depth |diff|", float(dd.max()) if dd.size else 0.0,
          depth_ok, "<= 1e-4 + 1e-5 |depth|")
    bad_winners = int((~np.isclose(im_new[..., 0][both], im_ref[..., 0][both],
                                   rtol=1e-5, atol=1e-6)).sum())
    check(f"{tag} winner mismatches", bad_winners, bad_winners == 0, "== 0")
    log(f"  {tag} covered pixels {int(both.sum())}")
    return dict(coverage_mismatch=cov_diff, winner_mismatch=bad_winners)


def phase_cli(argv, check: Checks):
    """Phase 6: ``topsy_tpu.main`` in-process, as the command line runs it."""
    import numpy as np

    import topsy_tpu
    from topsy_tpu import canvas

    log(f"phase 6: CLI {' '.join(argv)}")
    captured = []
    run_loop = canvas.run_event_loop

    def capture(visualizers):
        captured.extend(visualizers)
        run_loop(visualizers)

    old_argv = sys.argv
    sys.argv = ["topsy_tpu"] + list(argv)
    canvas.run_event_loop = capture
    t0 = time.perf_counter()
    try:
        topsy_tpu.main()
    finally:
        canvas.run_event_loop = run_loop
        sys.argv = old_argv
    log(f"  CLI run {time.perf_counter() - t0:.3f} s")
    frame = captured[0].last_frame if captured else None
    shape = None if frame is None else frame.shape
    log(f"  canvas {type(captured[0].canvas).__name__ if captured else None}"
        f", frame {shape}")
    ok = (frame is not None and frame.ndim == 3 and frame.shape[-1] == 4
          and np.asarray(frame)[..., :3].any())
    check("CLI frame drawn", shape, bool(ok), "an RGBA frame, not blank")
    return captured


def phase_four_cards(n: int, resolution: int, check: Checks,
                     n_devices: int = 4):
    """Phase 7: the mesh path over ``n_devices`` cards against single-card
    launches over the same global presorted layout."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from topsy_tpu.canvas import OffscreenCanvas
    from topsy_tpu.drawreason import DrawReason
    from topsy_tpu.loaders import TestDataDeviceLoader
    from topsy_tpu.ops import morton
    from topsy_tpu.parallel import make_mesh
    from topsy_tpu.render.sph import (_render_block_columns,
                                      _render_block_presorted)
    from topsy_tpu.render.store import bucket_size
    from topsy_tpu.visualizer import Visualizer

    log(f"phase 7: mesh path, n={n}, {resolution}^2, {n_devices} cards")
    t0 = time.perf_counter()
    vis = Visualizer(data_loader_class=TestDataDeviceLoader,
                     data_loader_args=(n,),
                     data_loader_kwargs={"seed": 1337},
                     render_resolution=resolution,
                     canvas_class=OffscreenCanvas,
                     mesh=make_mesh(n_devices))
    vis.quantity_name = "test-quantity"
    sph = vis._sph
    sph.render(DrawReason.EXPORT)
    _sync(sph.get_output_image())
    log(f"  setup + EXPORTs {time.perf_counter() - t0:.3f} s")
    t1 = time.perf_counter()
    sph.render(DrawReason.EXPORT)
    _sync(sph.get_output_image())
    log(f"  warm mesh EXPORT {time.perf_counter() - t1:.4f} s")
    check("mesh EXPORT dropped splats", sph.last_dropped_splats,
          sph.last_dropped_splats == 0, "== 0")
    t1 = time.perf_counter()
    vis.draw(DrawReason.CHANGE, target=(resolution, resolution))
    log(f"  mesh CHANGE frame {time.perf_counter() - t1:.4f} s (incl. "
        f"compile), coverage {1.0 / sph.last_render_mass_scale:.4f}")

    splatter = sph._get_splatter()
    ps_d = splatter._presorted
    log(f"  pos_smooth sharding: {splatter.pos_smooth.sharding}")
    log(f"  presorted slab sharding: {ps_d['pos'].sharding}")
    log(f"  slab shards: {[(s.device.id, s.data.shape) for s in ps_d['pos'].addressable_shards]}")
    for d in jax.devices()[:n_devices]:
        st = d.memory_stats() or {}
        log(f"  card {d.id}: bytes_in_use {st.get('bytes_in_use')} "
            f"peak_bytes_in_use {st.get('peak_bytes_in_use')}")

    layout = splatter.presorted_layout
    matrix = np.asarray(sph._matrix(), np.float32)
    m = jnp.asarray(matrix)
    scale = float(sph.scale)
    thresh = sph._giant_bucket
    # single-card copies of the same global layout
    loader = vis.data_loader
    dev = loader.device_arrays()
    mass = dev["mass"]
    vals = jnp.stack([mass, mass * dev["quantities"]["test-quantity"]],
                     axis=1)
    ps_p = layout.apply(dev["pos_smooth"], fill=morton.PAD_POS)
    vals_p = layout.apply(vals)
    n_out = ps_p.shape[0]
    cells = jnp.zeros(n_out, jnp.int32)
    table = jnp.ones(1, bool)

    im_mesh, d_mesh = splatter.render_presorted(matrix, scale,
                                                giant_bucket=thresh)
    bucket = bucket_size(n_out, n_out)
    im_one = None
    for s in range(0, n_out, bucket):
        im, _ = _render_block_presorted(
            ps_p, vals_p, layout.buckets, cells, table, m,
            jnp.float32(scale), jnp.int32(s),
            jnp.int32(min(bucket, n_out - s)), jnp.int32(thresh),
            resolution=resolution, bucket=bucket, depth_channel=False)
        im_one = im if im_one is None else im_one + im
    _mesh_criteria(np.asarray(im_mesh), np.asarray(im_one), int(d_mesh),
                   check, "presorted EXPORT")

    w = morton.min_slice_width(layout)
    im_mesh, d_mesh = splatter.render_columns(matrix, scale, 0, w,
                                              giant_bucket=thresh)
    im_one, _ = _render_block_columns(
        ps_p, vals_p, layout.buckets, None, None, m, jnp.float32(scale),
        jnp.int32(0), jnp.int32(thresh), resolution=resolution, width=w,
        depth_channel=False, pad_group=layout.pad_group)
    _mesh_criteria(np.asarray(im_mesh), np.asarray(im_one), int(d_mesh),
                   check, f"column CHANGE slice (width {w})")


def _mesh_criteria(im_mesh, im_one, dropped, check: Checks, tag: str):
    """psum order may differ from the single-card order: rel 1e-5 on the
    image sum, max |diff| <= 1e-5 * max."""
    import numpy as np
    s_rel = abs(float(im_mesh.sum()) / float(im_one.sum()) - 1.0)
    d_max = float(np.abs(im_mesh - im_one).max())
    lim = 1e-5 * float(np.abs(im_one).max())
    check(f"mesh {tag} dropped splats", dropped, dropped == 0, "== 0")
    check(f"mesh {tag} image sum rel. diff", s_rel, s_rel <= 1e-5, "<= 1e-5")
    check(f"mesh {tag} max |diff|", d_max, d_max <= lim, f"<= {lim!r}")


def main(argv=None, platform: str = "gpu") -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the mesh path over four cards")
    args = parser.parse_args(argv)

    import jax
    require_platform(platform)
    from topsy_tpu.util import enable_persistent_compile_cache
    enable_persistent_compile_cache()

    check = Checks()
    t_start = time.perf_counter()
    phase_device()
    _overlays_off_without_matplotlib()
    if args.four_cards:
        if len(jax.devices()) < 4:
            raise SystemExit(f"chip_smoke: --four-cards needs 4 devices, "
                             f"found {len(jax.devices())}")
        phase_four_cards(1 << 25, 1024, check, n_devices=4)
    else:
        vis, image, _ = phase_export(1 << 24, 1024, check)
        compare_with_scatter(vis, image, check, piece=1 << 21)
        phase_interactive(vis, image, check)
        del vis, image
        gc.collect()
        phase_surface(1 << 22, 1024, check)
        gc.collect()
        phase_cli(["test://1000000", "-q", "test-quantity", "--render-mode",
                   "bivariate", "-r", "512"], check)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    if check.failed:
        log(f"FAILED: {check.failed}")
        return 1
    dev = jax.devices()[0]
    print(json.dumps({"ok": True,
                      "device": {"platform": dev.platform,
                                 "kind": dev.device_kind,
                                 "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
