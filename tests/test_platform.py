"""Platform plumbing: the compile-cache location, the vendored default
colormap, and the absence of accelerator-specific kernel code."""

import os
import re

import numpy as np
import pytest

import jax

from topsy_tpu import config
from topsy_tpu.util import enable_persistent_compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("env_dir", [None, "elsewhere"])
def test_compile_cache_dir(monkeypatch, restore_cache_dir, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, decides where the cache goes
    (JAX reads it; the code sets no directory); otherwise the cache sits
    at the checkout's fixed .jax_cache."""
    sentinel = "/nonexistent/sentinel-cache"
    jax.config.update("jax_compilation_cache_dir", sentinel)
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        enable_persistent_compile_cache()
        assert jax.config.jax_compilation_cache_dir == \
            os.path.join(ROOT, ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        enable_persistent_compile_cache()
        assert jax.config.jax_compilation_cache_dir == sentinel


def test_vendored_default_lut_matches_matplotlib():
    matplotlib = pytest.importorskip("matplotlib")
    from topsy_tpu.color import default_lut
    from topsy_tpu.color.maps import colormap_rgba
    assert default_lut.NAME == config.DEFAULT_COLORMAP
    x = np.concatenate([np.linspace(0.001, 0.999, config.COLORMAP_NUM_SAMPLES),
                        [0.0, 0.5, 1.0]])
    want = matplotlib.colormaps[config.DEFAULT_COLORMAP](x)
    np.testing.assert_allclose(colormap_rgba(config.DEFAULT_COLORMAP, x),
                               want, rtol=0, atol=1e-6)


def test_no_accelerator_specific_kernel_code():
    """No module imports the Pallas backend of the removed kernels, runs a
    kernel through the Pallas interpreter, or branches on that platform's
    name (the patterns are assembled below)."""
    name = "t" + "pu"  # spelled in pieces so this file does not match
    patterns = [
        re.compile(r"pallas\." + name + r"|pl" + name),
        re.compile(r"\binterpret\s*="),
        re.compile(r"""["']""" + name + r"""["']"""),
    ]
    roots = ["topsy_tpu", "tests", "benchmarks", "examples"]
    files = [os.path.join(ROOT, "bench.py"), os.path.join(ROOT, "chip_smoke.py")]
    for r in roots:
        for dirpath, _, names in os.walk(os.path.join(ROOT, r)):
            files += [os.path.join(dirpath, f) for f in names
                      if f.endswith(".py")]
    offending = []
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if any(p.search(line) for p in patterns):
                    offending.append(f"{os.path.relpath(path, ROOT)}:{i}")
    assert not offending, offending
