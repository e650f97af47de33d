"""Profiling and tracing hooks.

The reference emits macOS os_signpost intervals for Instruments with a no-op
fallback (reference: src/topsy/performance.py:3-21).  The equivalents
here are (a) the same lightweight event API, optionally bridged to
``jax.profiler`` named traces so events appear in TensorBoard/XProf device
profiles, and (b) ``start_trace``/``stop_trace`` wrappers for capturing a
full device trace of a render.
"""

from __future__ import annotations

import contextlib
import logging
import os

logger = logging.getLogger(__name__)

_TRACE_ANNOTATIONS = os.environ.get("TOPSY_TPU_TRACE", "0") not in ("0", "", "false")


class _Signposter:
    """Event/interval emitter; mirrors the reference's signposter surface."""

    def emit_event(self, name: str):
        if _TRACE_ANNOTATIONS:
            logger.debug("event: %s", name)

    @contextlib.contextmanager
    def use_interval(self, name: str):
        if _TRACE_ANNOTATIONS:
            import jax.profiler
            with jax.profiler.TraceAnnotation(name):
                yield
        else:
            yield


signposter = _Signposter()


def start_trace(log_dir: str = "/tmp/topsy_tpu_trace"):
    """Begin capturing a jax/XLA device profile (view with TensorBoard)."""
    import jax.profiler
    jax.profiler.start_trace(log_dir)
    logger.info("Profiling to %s", log_dir)


def stop_trace():
    import jax.profiler
    jax.profiler.stop_trace()


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/topsy_tpu_trace"):
    start_trace(log_dir)
    try:
        yield
    finally:
        stop_trace()
