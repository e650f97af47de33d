"""Headline benchmark: the product EXPORT loop on one card.

Drives the full Visualizer (loaders -> ParticleStore -> progression ->
SPHRenderer presorted path -> giant layer) exactly as a movie export does:
repeated ``render(DrawReason.EXPORT)`` frames over the 2^24-particle
synthetic snapshot at 1024x1024 with density + weighted-quantity channels,
and reports steady-state splats/second.

The snapshot is generated on device and adopted by the store without a
host upload (loaders.TestDataDeviceLoader), and the presorted (bucket,
Morton) order is built on device too (ops/morton_device.py).  EXPORT
frames run barrier-free (throughput mode); each timed round ends in
``jax.block_until_ready`` on the last frame.

Prints ONE JSON line: {"metric", "value", "unit", "device"}.
"""

from __future__ import annotations

import json
import time


def main():
    import jax

    from topsy_tpu.canvas import OffscreenCanvas
    from topsy_tpu.drawreason import DrawReason
    from topsy_tpu.loaders import TestDataDeviceLoader
    from topsy_tpu.util import enable_persistent_compile_cache
    from topsy_tpu.visualizer import Visualizer

    enable_persistent_compile_cache()

    n = 1 << 24
    resolution = 1024

    vis = Visualizer(data_loader_class=TestDataDeviceLoader,
                     data_loader_args=(n,),
                     data_loader_kwargs={"seed": 1337},
                     render_resolution=resolution,
                     canvas_class=OffscreenCanvas)
    vis.show_status = False
    vis.quantity_name = "test-quantity"  # density + weighted channels
    vis.scale = 200.0
    vis.store.ensure_presorted()

    # warm up: the first EXPORTs pay compile and program load
    for _ in range(2):
        vis._sph.render(DrawReason.EXPORT)
        jax.block_until_ready(vis._sph.get_output_image())

    reps = 4
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(reps):
            vis._sph.render(DrawReason.EXPORT)
        jax.block_until_ready(vis._sph.get_output_image())
        best = min(best, (time.perf_counter() - t0) / reps)

    dev = jax.devices()[0]
    print(json.dumps({
        "metric": "product-EXPORT splats/sec/card",
        "value": n / best,
        "unit": "splats/s",
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
