"""Throughput benchmark: grid-points/s of the SWMHD RK3 step on one GPU.

Prints ONE JSON line with the rate, its share of the card's roofline and
the device it ran on:
  {"metric": ..., "value": N, "unit": "points/s", "device": {...}, ...}

It refuses to run without a GPU, and fails for a device kind whose peaks
are not in ``swmhd_tpu.profiling.DEVICE_PEAKS``.

The reference publishes no wall-time numbers (BASELINE.md), so the
baseline is the card's roofline. A fully fused RK3 step needs
``ANALYTIC_FLOPS_PER_POINT`` flop and ``BYTES_PER_POINT`` bytes of HBM
traffic per grid point (derivation in PERF.md), an arithmetic intensity
of ~34 flop/B. The binding roofline is min(f32-limit, HBM-limit) points/s,
and ``fraction_of_roofline`` is the measured rate over it.

Environment:
  SWMHD_BENCH_N      grid size (default 2048)
"""

import json
import os

import jax
import jax.numpy as jnp

# Minimum HBM traffic: 3 substages x (read+write 4 prognostics) x 4 B.
BYTES_PER_POINT = 96.0

# Hand-derived scheme-minimal flop/pt of one RK3 step (f32 WENO-Z
# vector-invariant + jacobian Lorentz; derivation table in PERF.md).
ANALYTIC_FLOPS_PER_POINT = 3274.0

STEPS_PER_CALL = 20
DT = 0.001


def build(N=2048, formulation="vector_invariant",
          topology=("periodic", "periodic"), dtype=jnp.float32):
    """The benchmark grid: an N² box of side 10 with the jacobian driver's
    vortex and a Gaussian-dipole magnetic potential. The vector-invariant
    formulation carries the jacobian Lorentz force, the conservative one
    the divergence Lorentz force."""
    from swmhd_tpu import (
        Grid, ShallowWaterModel, FPlane, VECTOR_INVARIANT,
        jacobian_lorentz_forcing, divergence_lorentz_forcing)

    grid = Grid.regular(N, N, (-5.0, 5.0), (-5.0, 5.0), topology=topology,
                        dtype=dtype)
    forcing = (jacobian_lorentz_forcing() if formulation == VECTOR_INVARIANT
               else divergence_lorentz_forcing())
    model = ShallowWaterModel(
        grid=grid, formulation=formulation,
        gravitational_acceleration=9.81, coriolis=FPlane(1.0),
        forcing=forcing)
    state = model.initial_state(
        u=lambda x, y: 5 * y * jnp.exp(-(x**2 + y**2)),
        v=lambda x, y: -5 * x * jnp.exp(-(x**2 + y**2)),
        h=1.0,
        A=lambda x, y: 0.5 * jnp.exp(-((x - 0.5)**2 + y**2))
        - 0.5 * jnp.exp(-((x + 0.5)**2 + y**2)))
    return model, state


def roofline_points_per_s(kind):
    """``(points/s, binding limit)`` of a fully fused step on ``kind``."""
    from swmhd_tpu.profiling import device_peaks
    peaks = device_peaks(kind)
    hbm = peaks.hbm_bytes_per_s / BYTES_PER_POINT
    f32 = peaks.f32_flops_per_s / ANALYTIC_FLOPS_PER_POINT
    return (f32, "f32 compute") if f32 < hbm else (hbm, "HBM bandwidth")


def main():
    from swmhd_tpu.profiling import benchmark_step
    from swmhd_tpu.runtime import (configure_compile_cache, gpu_cards,
                                   require_gpu)

    device = require_gpu()
    device["cards"] = gpu_cards()
    roofline, binding = roofline_points_per_s(device["kind"])
    configure_compile_cache()

    N = int(os.environ.get("SWMHD_BENCH_N", "2048"))
    model, state = build(N)
    step = jax.jit(model.step_fn(DT, STEPS_PER_CALL))
    b = benchmark_step(step, state, STEPS_PER_CALL)
    print(json.dumps({
        "metric": (f"grid-points/s (SWMHD RK3 step, {N}^2 f32, WENO5-Z "
                   f"vector-invariant + jacobian Lorentz, XLA step; median "
                   f"of {len(b.per_call_s)} calls of {STEPS_PER_CALL} "
                   f"steps)"),
        "value": b.points_per_s,
        "unit": "points/s",
        "device": device,
        "fraction_of_roofline": b.points_per_s / roofline,
        "binding_limit": binding,
        "flops_per_point_analytic": ANALYTIC_FLOPS_PER_POINT,
        "bytes_per_point_min": BYTES_PER_POINT,
        "rel_spread": b.rel_spread,
    }))


if __name__ == "__main__":
    main()
