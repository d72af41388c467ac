"""Process set-up shared by the entry points: the compile cache and the
device check.

Used by the CLI, ``bench.py``, ``chip_smoke.py``, ``benchmarks/scaling.py``
and the test configuration, so that every process keeps its compiled
programs in the same place and every measurement names its device.
"""

from __future__ import annotations

import os
import subprocess

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at one fixed directory and
    return it.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed here. Otherwise the cache goes to
    ``<checkout>/.jax_cache``: a fixed path, so that the next process on
    the same checkout finds what this one compiled."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> dict:
    """``{"platform", "kind", "count"}`` of the devices JAX found, or a
    ``RuntimeError`` when the first of them is not a GPU. Measurements and
    the chip check call this first: they never continue on the CPU."""
    devices = jax.devices()
    first = devices[0]
    if first.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX found {len(devices)} {first.platform} device(s) "
            f"({first.device_kind}); this needs an NVIDIA GPU")
    return {"platform": first.platform, "kind": first.device_kind,
            "count": len(devices)}


def gpu_cards() -> list:
    """One ``"name, power.limit"`` string per card, as ``nvidia-smi``
    reports them. A card may be set below its maximum power and then runs
    slower under load, so every number measured on it is kept beside this."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]
