"""Process set-up shared by the entry points (bench, scripts, tests).

* ``enable_compile_cache`` — JAX's persistent compilation cache.  Where
  ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
  helper sets no directory of its own; otherwise the cache lives at the
  fixed in-checkout ``benchmarks/.jax_cache`` (gitignored), so repeated
  runs from one checkout hit it.
* ``require_gpu`` / ``device_summary`` / ``gpu_name_and_power`` — the
  accelerator check every measurement path makes before it reports a
  number: no GPU means a loud failure, never a CPU fallback.
"""

from __future__ import annotations

import os
import pathlib
import subprocess

CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / "benchmarks" / ".jax_cache"


def enable_compile_cache(min_compile_secs: float = 2.0) -> str:
    """Turn on the persistent compile cache; returns the directory in use.

    min_compile_secs keeps executables that compile faster than this out
    of the cache."""
    import jax

    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_secs
    )
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


class NoGpuError(RuntimeError):
    pass


def require_gpu():
    """jax.devices(), after checking that every one is a GPU."""
    import jax

    devices = jax.devices()
    bad = sorted({d.platform for d in devices if d.platform != "gpu"})
    if not devices or bad:
        raise NoGpuError(
            f"no GPU: JAX's default devices are on {bad or 'nothing'}"
        )
    return devices


def device_summary(devices) -> dict:
    """The device fields every result line carries."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def gpu_name_and_power() -> str:
    """`nvidia-smi`'s name and power limit of each card, one per line."""
    try:
        out = subprocess.run(
            [
                "nvidia-smi",
                "--query-gpu=name,power.limit",
                "--format=csv,noheader",
            ],
            capture_output=True,
            text=True,
            timeout=30,
            check=True,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable: {exc}"
    return out.stdout.strip()
