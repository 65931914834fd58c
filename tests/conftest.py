"""Test harness configuration.

Tests run on the CPU, on a virtual 8-device mesh ("test multi-node without a
cluster" — SURVEY.md §4): XLA's host-count-agnostic SPMD means the sharded
paths compile and execute identically on CPU devices.  The GPU is reached
through ``chip_smoke.py`` and the tests marked ``gpu``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# Deterministic regardless of test selection: several test modules need f64
# oracles; runtime paths pass explicit float32 dtypes and are unaffected.
jax.config.update("jax_enable_x64", True)

# Persistent compile cache: the suite's wall time is dominated by repeated
# XLA compiles of near-identical solve programs; caching them on disk makes
# reruns start warm.  JAX_COMPILATION_CACHE_DIR, when set, wins.
from mahi_mpc.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), ".jax_cache_tests"), min_compile_time_s=0.5)
