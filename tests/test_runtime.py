"""Process set-up helpers: the compile-cache placement and the GPU gate."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

from pir_tpu.utils import runtime

REPO = pathlib.Path(__file__).resolve().parents[1]

_PROBE = (
    "import json, jax; from pir_tpu.utils import runtime; "
    "used = runtime.enable_compile_cache(); "
    "print(json.dumps([used, jax.config.jax_compilation_cache_dir]))"
)


def _probe(env_dir):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], env=env, capture_output=True,
        text=True, timeout=300, check=True,
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cache_dir_from_environment_is_left_to_jax(tmp_path):
    used, configured = _probe(tmp_path / "cache")
    assert used == configured == str(tmp_path / "cache")
    assert not (tmp_path / "cache").exists()  # no directory of ours


def test_cache_dir_defaults_to_the_checkout():
    used, configured = _probe(None)
    assert used == configured == str(REPO / "benchmarks" / ".jax_cache")


def test_require_gpu_refuses_cpu_devices():
    with pytest.raises(runtime.NoGpuError, match="cpu"):
        runtime.require_gpu()
