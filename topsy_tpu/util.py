"""Timing and miscellaneous utilities.

The reference times GPU work with blocking queue fences (reference:
src/topsy/util.py:76-115); the analogue here is wall-clock timing around
``jax.block_until_ready``, with the same running-mean smoothing feeding the
fps display and the LOD scheduler.
"""

from __future__ import annotations

import time

import numpy as np


class TimeDeviceOperation:
    """Context manager accumulating per-frame device-execution time.

    Enqueue work inside ``with timer:`` blocks (cheap — dispatch is
    asynchronous); barrier on the frame's arrays with ``timer.sync(x)``,
    which charges the time until the device has finished them."""

    def __init__(self, n_frames_smooth: int = 10):
        self.n_frames_smooth = n_frames_smooth
        self._recent: list[float] = []
        self._current_frame_duration = 0.0
        self.last_duration = 0.0

    def __enter__(self):
        self._block_start = time.perf_counter()
        return self

    def __exit__(self, *args):
        self._current_frame_duration += time.perf_counter() - self._block_start

    def sync(self, x) -> None:
        """Wait for the device arrays in pytree ``x`` and charge the wait.
        Call OUTSIDE ``with`` blocks — it times itself."""
        import jax

        t0 = time.perf_counter()
        jax.block_until_ready(x)
        self._current_frame_duration += time.perf_counter() - t0

    def end_frame(self, record: bool = True):
        """Close the frame.  ``record=False`` (barrier-free EXPORT frames,
        whose accumulated figure is enqueue time, not device time) discards
        the measurement instead of polluting the fps running mean."""
        if not record:
            self._current_frame_duration = 0.0
            return
        self.last_duration = self._current_frame_duration
        self._current_frame_duration = 0.0
        self._recent.append(self.last_duration)
        if len(self._recent) > self.n_frames_smooth:
            self._recent.pop(0)

    def record_external(self, duration: float):
        """Record a frame duration measured OUTSIDE this timer — the
        deferred-feedback interactive path: the frame launches barrier-free
        and its device time is recovered from the frame's single natural
        end-of-frame barrier (the presentation readback, or the caller's
        own sync), so interactive frames pay ONE host round-trip instead of
        two.  Feeds the same running mean as in-frame measurements."""
        self.last_duration = max(0.0, duration)
        self._recent.append(self.last_duration)
        if len(self._recent) > self.n_frames_smooth:
            self._recent.pop(0)

    def total_time_in_frame(self) -> float:
        return self._current_frame_duration

    @property
    def running_mean_duration(self) -> float:
        if not self._recent:
            return 0.0
        return float(np.mean(self._recent))


def require(package: str, purpose: str):
    """Import an optional host package (matplotlib, cv2, ...) at first use,
    or raise an ImportError that names it and what needed it."""
    import importlib

    try:
        return importlib.import_module(package)
    except ImportError as e:
        raise ImportError(f"{purpose} needs the {package!r} package, "
                          f"which is not installed") from e


def is_inside_ipython() -> bool:
    try:
        __IPYTHON__  # type: ignore[name-defined]  # noqa: B018
        return True
    except NameError:
        return False


def is_jupyter() -> bool:
    """True when running inside a Jupyter kernel."""
    try:
        from IPython import get_ipython
    except ImportError:
        return False
    ip = get_ipython()
    return ip is not None and ip.has_trait("kernel")


def enable_persistent_compile_cache() -> None:
    """Cache compiled XLA executables on disk across processes.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already keeps its cache
    there and no directory is set here.  Otherwise the cache lives at the
    fixed ``<checkout>/.jax_cache``, so every process run from one checkout
    finds the same entries.  Safe to call more than once."""
    import os

    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update(
            "jax_compilation_cache_dir",
            os.path.join(os.path.dirname(os.path.dirname(__file__)),
                         ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
