"""Native (C++/OpenMP) host runtime: exact kNN smoothing and fast cell
binning for the load path.

Compiled lazily with the system compiler into the package directory and
loaded via ctypes; every entry point has a numpy fallback so the framework
works without a toolchain (the device compute path never depends on this
module).
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

logger = logging.getLogger(__name__)

_lock = threading.Lock()
_lib = None
_build_failed = False

_SRC = os.path.join(os.path.dirname(__file__), "_native.cpp")
_SO = os.path.join(os.path.dirname(__file__), "_native.so")


def _load() -> ctypes.CDLL | None:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            return None
        try:
            if (not os.path.exists(_SO)
                    or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
                cmd = ["g++", "-O3", "-fopenmp", "-shared", "-fPIC",
                       "-std=c++17", _SRC, "-o", _SO + ".tmp"]
                subprocess.run(cmd, check=True, capture_output=True)
                os.replace(_SO + ".tmp", _SO)
            lib = ctypes.CDLL(_SO)
            lib.cell_sort.restype = ctypes.c_int
            lib.cell_sort.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
                ctypes.c_double, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p]
            lib.interleave_order.restype = None
            lib.interleave_order.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p]
            lib.knn_smooth.restype = None
            lib.knn_smooth.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_int, ctypes.c_void_p]
            lib.presort_order.restype = None
            lib.presort_order.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
                ctypes.c_void_p, ctypes.c_void_p]
            _lib = lib
            logger.info("Loaded native runtime (%s)", _SO)
        except Exception as e:  # pragma: no cover - toolchain dependent
            logger.warning("Native runtime unavailable (%s); using numpy "
                           "fallbacks", e)
            _build_failed = True
            return None
        return _lib


def available() -> bool:
    return _load() is not None


def cell_sort(positions: np.ndarray, box_min: float, box_max: float,
              nside: int):
    """(ordering, offsets, lengths) for cell-contiguous layout, or None to
    signal the caller to use the numpy path."""
    lib = _load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(positions, dtype=np.float32)
    n = len(pos)
    ordering = np.empty(n, dtype=np.int64)
    ncell = nside ** 3
    offsets = np.empty(ncell, dtype=np.int64)
    lengths = np.empty(ncell, dtype=np.int64)
    rc = lib.cell_sort(pos.ctypes.data, n, float(box_min), float(box_max),
                       int(nside), ordering.ctypes.data, offsets.ctypes.data,
                       lengths.ctypes.data)
    if rc != 0:
        raise ValueError("Particle positions are outside the box")
    return ordering, offsets, lengths


def interleave_order(offsets: np.ndarray, lengths: np.ndarray,
                     phi: np.ndarray):
    lib = _load()
    if lib is None:
        return None
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    phi = np.ascontiguousarray(phi, dtype=np.float64)
    n = int(lengths.sum())
    order = np.empty(n, dtype=np.int64)
    lib.interleave_order(offsets.ctypes.data, lengths.ctypes.data,
                         phi.ctypes.data, len(lengths), n, order.ctypes.data)
    return order


def presort_order(pos_smooth: np.ndarray, delta_octave: float):
    """(buckets, order) for the (smoothing-bucket, Morton) presort
    (ops/morton.py) via a native LSD radix sort — same key, same result
    ordering semantics as the numpy path, ~10x faster on big snapshots.
    None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    ps = np.ascontiguousarray(pos_smooth, dtype=np.float32)
    n = len(ps)
    buckets = np.empty(n, dtype=np.int32)
    order = np.empty(n, dtype=np.int64)
    lib.presort_order(ps.ctypes.data, n, float(delta_octave),
                      buckets.ctypes.data, order.ctypes.data)
    return buckets, order


def knn_smooth(positions: np.ndarray, n_neighbors: int = 64) -> np.ndarray | None:
    """Exact kNN smoothing lengths, h = 0.5 * d_nn (pynbody convention);
    None if the native library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    pos = np.ascontiguousarray(positions, dtype=np.float32)
    h = np.empty(len(pos), dtype=np.float32)
    lib.knn_smooth(pos.ctypes.data, len(pos), int(n_neighbors), h.ctypes.data)
    return h
