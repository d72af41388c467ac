"""Test configuration.

By default the tests run on the CPU with 8 virtual devices and float64.
The 8-device CPU mesh stands in for several GPUs (SURVEY §4e), so the
sharded-vs-single-device equality tests run without hardware; float64 lets
the operator convergence tests reach their asymptotic order before
roundoff.

Tests marked ``gpu`` need an NVIDIA GPU. The ``gpu_device`` fixture decides
inside each test, so they skip here and run on the card with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu

which leaves JAX on the GPU in float32, with the CPU beside it for the
plain reference.
"""

import os

import jax

_PLATFORMS = set(os.environ.get("JAX_PLATFORMS", "").lower().split(","))
if not _PLATFORMS & {"cuda", "gpu"}:
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from swmhd_tpu.runtime import configure_compile_cache  # noqa: E402

# XLA compiles of the WENO tendency graphs take tens of seconds on a small
# host; keep them across test runs
configure_compile_cache()


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when JAX runs on anything else."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX is on {device.platform}); "
                    f"run with JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu")
    return device


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def convergence_order(ns, errors):
    """Log-log least-squares slope, the fit the reference prints
    (test_jacobian.jl:65-71, test_formulations.jl:205-211)."""
    ns = np.asarray(ns, dtype=float)
    errors = np.asarray(errors, dtype=float)
    slope = np.polyfit(np.log10(ns), np.log10(errors), 1)[0]
    return -slope
