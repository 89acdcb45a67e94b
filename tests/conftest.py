"""Test harness configuration.

All tests run on a simulated 8-device CPU mesh (the standard JAX trick for
testing sharded code without a multi-card machine — SURVEY §4).  The
platform is set through jax.config *before any computation runs*, so the
tests stay on the CPU even where a GPU is present.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent XLA compile cache: test wall time is dominated by CPU jit
# compiles that are identical run to run (same programs, same shapes).
from pir_tpu.utils import runtime  # noqa: E402

runtime.enable_compile_cache(min_compile_secs=0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)
