"""f32 scenario validation on the GPU through the production path.

The committed correctness record (VALIDATION.md) comes from the float64
CPU gate, examples/validate_reference.py. Production runs float32 on an
NVIDIA GPU through the XLA step, driven by ``Simulation`` exactly as the
CLI drives it. This driver reruns the recorded scenario x formulation
combos that way and checks the SAME anchors as the f64 CPU gate
(examples/validation_anchors.py):

  - ``scenarios.build`` in float32 with x64 off (the CLI enables x64 only
    for ``--dtype float64``; the f32 clock is drift-free by in-scan
    reconstruction, see models.state.time_dtype);
  - ``Simulation`` with the every-iteration energy series computed
    in-graph (reference functional convention).

f32 tolerance rationale: the anchors compare O(0.01..1)-scale energies
and a deviation envelope gated at 3x the recorded peak. The f32
trajectory differs from f64 at the WENO-weight roundoff level
(tests/test_advection.py::TestF32Weights pins the weights to ~1e-4 of
f64 in the decisive beta regime), which accumulates far below the 30%
end-state / 3x-envelope gates.

Refuses to run without a GPU. Usage:
    python examples/validate_gpu.py [--only SUBSTR] [--outdir DIR]
Writes DIR/series/*.csv and DIR/results.json (default runs/validate_gpu).
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax.numpy as jnp  # noqa: E402

from validation_anchors import REFERENCE, summarize, judge  # noqa: E402

CASES = [(f, f"{N}x{N}_{tag}")
         for N in (64, 128)
         for tag in ("two_Gaussians_low_B", "two_Gaussians_high_B",
                     "low_B_low_U")
         for f in ("vector_invariant", "conservative")]


def run_case(formulation, name, stop_time, outdir):
    """Run one scenario in f32 through ``Simulation`` with the reference
    energy series; returns ``(csv_path, wall_s)``."""
    from swmhd_tpu import scenarios, diagnostics
    from swmhd_tpu.simulation import Simulation, IterationInterval
    from swmhd_tpu.io import ScalarSeriesWriter

    model, state, sc = scenarios.build(name, formulation,
                                       dtype=jnp.float32)
    h0 = state.h
    csv = os.path.join(outdir, "series", f"{formulation}_{name}.csv")
    os.makedirs(os.path.dirname(csv), exist_ok=True)

    sim = Simulation(model, dt=sc.dt, stop_time=stop_time)

    def energies(model_, st):
        return diagnostics.reference_energy_report(model_, st, h0)

    sim.output_writers["energies"] = ScalarSeriesWriter(
        fn=energies, schedule=IterationInterval(1), path=csv)
    sim.run(state)
    return csv, sim.run_wall_time


def main():
    from swmhd_tpu.runtime import configure_compile_cache, require_gpu

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    ap.add_argument("--outdir", default=os.path.join(REPO, "runs",
                                                     "validate_gpu"))
    args = ap.parse_args()

    device = require_gpu()
    configure_compile_cache()
    results = []
    for formulation, name in CASES:
        tag = f"{formulation}_{name}"
        if args.only and args.only not in tag:
            continue
        ref = REFERENCE[(formulation, name)]
        t0 = time.perf_counter()
        csv, wall = run_case(formulation, name, ref["stop"], args.outdir)
        got = summarize(csv)
        checks = judge(ref, got)
        results.append({
            "formulation": formulation, "scenario": name,
            "dtype": "float32", "device": device, "run_wall_s": wall,
            "reference": ref, "ours": got, "checks": checks,
            "pass": all(checks.values())})
        print(f"{tag}: {'PASS' if results[-1]['pass'] else 'FAIL'} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    with open(os.path.join(args.outdir, "results.json"), "w") as f:
        json.dump(results, f, indent=1)
    n_pass = sum(r["pass"] for r in results)
    print(f"{n_pass}/{len(results)} cases pass")
    return 0 if n_pass == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
