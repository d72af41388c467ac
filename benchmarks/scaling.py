"""Weak/strong scaling sweep over the device mesh (BASELINE §scaling).

Runs the sharded SWMHD RK3 step over 1..N devices and reports
grid-points/s, parallel efficiency vs 1 device, and the comm/compute
overlap gain. On the GPUs of one host this measures the NVLink halo
exchange; on CPU (JAX_PLATFORMS=cpu
XLA_FLAGS=--xla_force_host_platform_device_count=8) it validates the tooling
end-to-end.

    python benchmarks/scaling.py --mode weak --local 512
    python benchmarks/scaling.py --mode strong --global-size 2048
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp


def build_model(Nx, Ny):
    from swmhd_tpu import (Grid, ShallowWaterModel, FPlane,
                           VECTOR_INVARIANT, jacobian_lorentz_forcing)
    g = Grid.regular(Nx, Ny, (-5.0, 5.0), (-5.0, 5.0), dtype=jnp.float32)
    model = ShallowWaterModel(grid=g, formulation=VECTOR_INVARIANT,
                              coriolis=FPlane(1.0),
                              forcing=jacobian_lorentz_forcing())
    state = model.initial_state(
        u=lambda x, y: y * jnp.exp(-(x**2 + y**2)),
        v=lambda x, y: -x * jnp.exp(-(x**2 + y**2)),
        h=1.0, A=lambda x, y: 0.1 * jnp.exp(-(x**2 + y**2)))
    return model, state


def bench_config(n_dev, Nx, Ny, steps, overlap, dt=1e-3,
                 want_overlap_pct=False):
    from swmhd_tpu.parallel import DomainDecomposition, make_mesh
    from swmhd_tpu.profiling import benchmark_step, measure_overlap
    model, state = build_model(Nx, Ny)
    if n_dev == 1:
        step = jax.jit(model.step_fn(dt, steps))
        st = state
    else:
        mesh = make_mesh(n_devices=n_dev)
        dd = DomainDecomposition(model, mesh,
                                 overlap=overlap)
        st = dd.shard_state(state)
        step = dd.step_fn(dt, steps)
    b = benchmark_step(step, st, steps, n_calls=3)
    ov = None
    if want_overlap_pct and n_dev > 1:
        # the BASELINE "overlap % tracked" metric: fraction of collective
        # (halo-exchange) time covered by concurrent compute in a
        # profiler trace of the sharded step (thread-level on the CPU
        # fake mesh; device-stream-level on GPU traces)
        try:
            ov = measure_overlap(step, st)
        except Exception as e:  # tracing unsupported on some backends
            ov = {"overlap_pct": None, "error": str(e)}
    return b, ov


def main():
    from swmhd_tpu.runtime import configure_compile_cache

    # compiles of the sharded WENO step are expensive — cache them
    configure_compile_cache()
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["weak", "strong"], default="weak")
    ap.add_argument("--local", type=int, default=256,
                    help="per-device tile size for weak scaling")
    ap.add_argument("--global-size", type=int, default=1024,
                    help="global grid for strong scaling")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args()

    devs = len(jax.devices())
    counts = [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= devs]
    results = []
    base = None
    for n in counts:
        if args.mode == "weak":
            import math
            px = int(math.isqrt(n))
            while n % px:
                px -= 1
            Nx, Ny = args.local * px, args.local * (n // px)
        else:
            Nx = Ny = args.global_size
        for overlap in ((False, True) if n > 1 else (False,)):
            b, ov = bench_config(n, Nx, Ny, args.steps, overlap,
                                 want_overlap_pct=True)
            per_dev = b.points_per_s / n
            if base is None:
                base = per_dev
            eff = per_dev / base if args.mode == "weak" else \
                b.points_per_s / (base * n)
            row = {"devices": n, "grid": [Nx, Ny], "overlap": overlap,
                   "points_per_s": round(b.points_per_s, 1),
                   "efficiency": round(eff, 3)}
            if ov is not None:
                row["overlap_pct"] = (None if ov.get("overlap_pct") is None
                                      else round(ov["overlap_pct"], 1))
                row["comm_ms"] = round(ov.get("comm_ms", 0.0), 2) \
                    if "comm_ms" in ov else None
            results.append(row)
            print(json.dumps(row), flush=True)

    print(json.dumps({"mode": args.mode, "device_kind":
                      jax.devices()[0].device_kind, "results": results}))


if __name__ == "__main__":
    main()
