"""Test configuration: run on CPU with 8 virtual devices so multi-chip
sharding logic is exercised without accelerator hardware (SURVEY.md §4).

JAX_PLATFORMS is overridden, not defaulted, and the config API is set too,
so an environment that selects an accelerator still runs the suite on CPU.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent compile cache for the suite: cached executables deserialize
# instead of re-invoking the XLA CPU compiler on repeat runs.
from topsy_tpu.util import enable_persistent_compile_cache  # noqa: E402

enable_persistent_compile_cache()

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_accumulated_jit_state():
    """Drop compiled executables after every test module.

    The XLA CPU compiler has segfaulted (upstream) compiling large zsplat
    programs ~2 h into a full-suite session — always a big compile late in
    the run, always passing in isolation, i.e. dependent on the hundreds of
    executables already resident in the process.  Releasing them per module
    bounds that accumulation; with the persistent disk cache above, any
    program a later module needs again reloads in milliseconds instead of
    recompiling.

    If the crash recurs: run the standalone repro
    ``benchmarks/repro_xla_cpu_segfault.py`` (dummy-compile accumulation +
    the suite's biggest zsplat compile) to diagnose in minutes instead of
    re-running a 2-hour suite."""
    yield
    import jax
    jax.clear_caches()
