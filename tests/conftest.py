"""Test configuration: run everything on a simulated 8-device CPU mesh.

Tests that need a GPU carry the `gpu` marker and skip inside the test
body when no card is present; `python chip_smoke.py` runs them on one.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: the encoder graphs take 30-120 s each to
# compile on CPU; caching them makes suite re-runs minutes faster.
from zzflate_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable(min_compile_secs=1)
