"""Validate all 6 recorded scenarios x 2 formulations against the
reference's energy-history baselines.

The reference's correctness record is 12 energy plots
(/root/reference/energy_plots/{jacobian,divergence}_formulation/*.png,
SURVEY §2.1 C9) — pixels, not fields. This driver reruns every scenario to
the reference's recorded stop time, renders the same 4-panel figure
(kinetic / magnetic / potential / total-energy deviation,
SWMHD_example.jl:135-165), and compares the quantitative anchors that are
readable off the reference plots (initial/final KE and ME, the
total-energy-deviation envelope) against values transcribed from those
plots. Output: validation/plots/*.png, validation/summary.json, and
VALIDATION.md at the repo root.

Run on CPU in float64 (the reference ran f64 CPU):
    JAX_PLATFORMS=cpu python examples/validate_reference.py
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# Forced to the CPU on purpose: this is the float64 gate, run the way the
# reference ran (f64 on a CPU). jax.config holds even where JAX_PLATFORMS
# names another backend, as long as no backend is initialised yet. The
# GPU's float32 counterpart is examples/validate_gpu.py.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTDIR = os.path.join(REPO, "validation")

# Anchors + acceptance logic are shared with the GPU f32 validation
# driver (validate_gpu.py) via validation_anchors.py.
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from validation_anchors import REFERENCE, TOL, summarize, judge  # noqa: E402


def run_case(formulation, name, stop_time):
    from swmhd_tpu import scenarios, diagnostics
    from swmhd_tpu.simulation import (Simulation, IterationInterval,
                                      Callback, progress_callback)
    from swmhd_tpu.io import ScalarSeriesWriter

    model, state, sc = scenarios.build(name, formulation, dtype=jnp.float64)
    h0 = state.h
    tag = f"{formulation}/{name}"
    csv = os.path.join(OUTDIR, "series", f"{tag.replace('/', '_')}.csv")
    os.makedirs(os.path.dirname(csv), exist_ok=True)

    sim = Simulation(model, dt=sc.dt, stop_time=stop_time)
    sim.callbacks["progress"] = Callback(progress_callback(),
                                         IterationInterval(1000))

    def energies(model_, st):
        # the reference's OWN functional convention (index-aligned lazy
        # expressions, SWMHD_example.jl:74-77) — the apples-to-apples
        # series for the recorded envelopes; see NOTES below.
        return diagnostics.reference_energy_report(model_, st, h0)

    sim.output_writers["energies"] = ScalarSeriesWriter(
        fn=energies, schedule=IterationInterval(1), path=csv)
    sim.run(state)
    return csv


def main():
    """Run cases and write one result JSON per case under
    validation/results/. Sharding for parallel workers:
    ``--shard k/n`` runs cases with index % n == k. ``--merge`` skips
    running and just assembles summary.json + VALIDATION.md from the
    per-case results (all 12 must exist). Any other argv entries filter
    cases by substring (results still land per-case; the full-sweep
    record is only written by --merge or an unfiltered run)."""
    from swmhd_tpu.viz import render_energy_plot
    os.makedirs(os.path.join(OUTDIR, "plots"), exist_ok=True)
    os.makedirs(os.path.join(OUTDIR, "results"), exist_ok=True)
    args = sys.argv[1:]
    shard = None
    if "--shard" in args:
        i = args.index("--shard")
        k, n = args[i + 1].split("/")
        shard = (int(k), int(n))
        args = args[:i] + args[i + 2:]
    merge_only = "--merge" in args
    only = [a for a in args if a != "--merge"] or None

    if not merge_only:
        for idx, ((formulation, name), ref) in enumerate(REFERENCE.items()):
            tag = f"{formulation}_{name}"
            if shard and idx % shard[1] != shard[0]:
                continue
            if only and not any(o in tag for o in only):
                continue
            print(f"=== {tag} (stop {ref['stop']}) ===", flush=True)
            csv = run_case(formulation, name, ref["stop"])
            png = os.path.join(OUTDIR, "plots", f"{tag}.png")
            render_energy_plot(csv, png, title=tag)
            got = summarize(csv)
            checks = judge(ref, got)
            row = dict(formulation=formulation, scenario=name, ref=ref,
                       got=got, checks=checks, ok=all(checks.values()))
            with open(os.path.join(OUTDIR, "results", f"{tag}.json"),
                      "w") as f:
                json.dump(row, f, indent=1)
            print(f"    {got} -> {'PASS' if row['ok'] else 'FAIL'} "
                  f"{checks}", flush=True)

    rows, missing = [], []
    for (formulation, name), ref in REFERENCE.items():
        p = os.path.join(OUTDIR, "results", f"{formulation}_{name}.json")
        if os.path.exists(p):
            with open(p) as f:
                rows.append(json.load(f))
        else:
            missing.append(f"{formulation}_{name}")
    suffix = "" if not missing else ".partial"
    if missing:
        print(f"missing {len(missing)} cases ({missing}); "
              f"writing .partial record only")
    with open(os.path.join(OUTDIR, f"summary{suffix}.json"), "w") as f:
        json.dump(rows, f, indent=1)
    write_markdown(rows, suffix)


def write_markdown(rows, suffix=""):
    lines = [
        "# VALIDATION — scenario energy histories vs the reference's "
        "recorded baselines",
        "",
        "The reference's correctness record is 12 energy-history plots "
        "(`/root/reference/energy_plots/`, one per scenario x formulation; "
        "SURVEY §2.1 C9). This table compares our reruns (f64, CPU, the "
        "pinned ICs of `swmhd_tpu/scenarios.py`, reference functionals of "
        "`swmhd_tpu/diagnostics.py`) against anchors transcribed from "
        "those plots. Our plots: `validation/plots/`; series: "
        "`validation/series/`; generator: "
        "`examples/validate_reference.py`.",
        "",
        "Anchors: initial magnetic/kinetic energy (pure functions of the "
        "ICs; tolerance 3%), final KE/ME (trajectory-sensitive; 30%), and "
        "the peak total-energy deviation |E-E0|x100 — the reference's own "
        "conservation gate (within 3x the recorded value; RK3+WENO "
        "truncation differs in detail between the two codebases).",
        "",
        "Note: the reference's 64x64 jacobian plots show potential energy "
        "offset by the rest value 490.5 = (g/2)LxLy (an older functional); "
        "PE anchors are compared in deviation form, which is identical "
        "when mass is conserved.",
        "",
        "| formulation | scenario | anchor | reference | ours | ok |",
        "|---|---|---|---|---|---|",
    ]
    for r in rows:
        ref, got, checks = r["ref"], r["got"], r["checks"]
        anchors = [("ME(0)", ref["me0"], got["me0"], checks["me0"]),
                   ("KE(0)", ref.get("ke0", 0.0), got["ke0"], checks["ke0"]),
                   ("KE(end)", ref["ke_end"], got["ke_end"],
                    checks["ke_end"]),
                   ("ME(end)", ref["me_end"], got["me_end"],
                    checks["me_end"]),
                   ("max |E-E0|x100", ref["dev_max"], got["dev_max"],
                    checks["dev_max"])]
        for i, (nm, rv, gv, ok) in enumerate(anchors):
            first = (f"| {r['formulation']} | {r['scenario']} "
                     if i == 0 else "| | ")
            lines.append(f"{first}| {nm} | {rv:.4g} | {gv:.4g} | "
                         f"{'yes' if ok else 'NO'} |")
        lines.append(f"| | | **overall** | | | "
                     f"{'**PASS**' if r['ok'] else '**FAIL**'} |")
    n_ok = sum(r["ok"] for r in rows)
    lines += ["", f"**{n_ok}/{len(rows)} scenarios pass.**", "",
              _movie_parity_section(), NOTES, ""]
    with open(os.path.join(REPO, f"VALIDATION{suffix}.md"), "w") as f:
        f.write("\n".join(lines))
    print(f"wrote VALIDATION{suffix}.md ({n_ok}/{len(rows)} pass)")


def _movie_parity_section():
    """Artifact-parity table for the 12 scenario movies (C9's remaining
    artifact class): our mp4s + first/last-frame side-by-sides vs the
    reference's simulation_runs/*.mp4, from examples/render_movies.py."""
    path = os.path.join(REPO, "validation", "movies", "manifest.json")
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        man = json.load(f)
    lines = [
        "## Movie artifact parity (simulation_runs/*.mp4)",
        "",
        "Our re-renders of the reference's 12 scenario movies "
        "(`validation/movies/*.mp4`; two-panel Magnetic-potential/Speed, "
        "0.1-t frame cadence, per-frame color autoscale — the Makie "
        "record layout of SWMHD_example.jl:103-130) plus side-by-side "
        "first/last-frame comparisons against the reference mp4s "
        "(`validation/movies/compare_*.png`). The displayed magnetic "
        "potential includes the static background ramp, so low_B_low_U "
        "panels compare like-for-like. Generator: "
        "`examples/render_movies.py`.",
        "",
        "| formulation | scenario | frames (ours/ref) | t_end | "
        "comparison |",
        "|---|---|---|---|---|",
    ]
    for m in man:
        lines.append(
            f"| {m['formulation']} | {m['scenario']} | "
            f"{m['our_frames']}/{m['ref_frames']} | {m['t_end']:g} | "
            f"`{os.path.basename(m['compare'])}` |")
    lines.append("")
    return "\n".join(lines)


NOTES = """\
## Root cause of the round-2 64² low_B_low_U envelope miss (fixed)

Round 2 recorded 6.0–6.3 vs the reference's 0.78–1.03 at 64². A
term-by-term discrete energy budget (⟨∂E/∂state, G_term⟩ via jax.grad;
benchmarks/exp/r3_energy_budget.py) attributed ~80% of the loss to the
Lorentz/induction pair — compatible to 1e-5 while fields are smooth
(t<3), leaking only once the wound-up magnetic potential reaches grid
scale, i.e. *upwind dissipation of the A-spiral*. Two compounding causes
were isolated:

1. **Functional convention** (benchmarks/exp/r3_functional_style.py):
   our physically-interpolated energy functionals undercount grid-scale
   magnetic energy relative to the reference's index-aligned lazy
   expressions (`B_x = -∂y(A)/h` squared in place, SWMHD_example.jl:70-75).
   Measuring the SAME trajectory reference-style: 6.05 → 3.52.
   Validation now uses `diagnostics.reference_energy_report`.
2. **WENO weight flavor** (benchmarks/exp/r3_wenoz.py): the Oceananigans
   vintage the reference pins (the one shipping
   `WENO5(vector_invariant = VelocityStencil())`) computes WENO-Z
   nonlinear weights (Borges et al. 2008), not classic Jiang–Shu.
   Z-weights retain the near-grid-scale spiral the recorded run keeps:
   with them the deviation curve reproduces the reference's signature
   non-monotone shape (rise, return through zero, late spike — compare
   energy_plots/*/64x64_low_B_low_U.png), KE_end 0.187 vs recorded 0.18,
   ME_end 0.304 vs 0.313, dev_max 1.87 < 3×0.78. WENO-Z is now the
   default (`SWMHD_WENO_WEIGHTS=js` restores Jiang–Shu).

Previously-published exonerations (walls, Δt) still hold; the round-2
"tracer scheme exonerated" note tested WENO-Z on the tracer only and
measured it with the interpolated functionals, which masked the fix.

## Root cause of the round-3 128² two_Gaussians_low_B misses (fixed)

With Z-weights in place, both 128² two_Gaussians_low_B combos still
failed: total energy GREW ~linearly from t=0 (dev ≈ +0.035 by t=30 vs
the reference's flat-until-t≈28 curve peaking at 0.010), vi missing its
3× dev envelope and cons landing KE_end 0.00576 vs the recorded 0.0035.
The energy budget (benchmarks/exp/r3_budget_any.py) attributed the gain
entirely to the Lorentz-work/induction mismatch netting POSITIVE — the
Lorentz force was doing more work on the flow than the magnetic field
lost. The cause was the smoothness-indicator regularizer: at 128² the
smooth-field betas are O((Δx²A″)²) ≈ 1e-6, equal to the then-default
eps = 1e-6, which linearized the nonlinear weights and removed the
upwind dissipation of A that balances the mismatch (at 64² betas are
~16× larger, masking it). eps = 1e-8 — the Oceananigans-era value —
restores it (benchmarks/exp/r3_eps_sweep.py): vi dev_max 0.0032 (the
reference's own curve peaks at 0.010), cons KE_end 0.00348 vs recorded
0.0035, and the cons run reproduces the reference's late-time
instability onset (dev rising from t≈53, ref t≈50). eps is now 1e-8 in
every dtype (`SWMHD_WENO_EPS` overrides): since r4, non-f64 evaluation
rescales (betas, eps) by the beta sum — exact-arithmetic no-op for the
homogeneous weight formulas — so the divide-free rational weights no
longer underflow at eps⁶ in f32 and the production f32 path keeps
the validated eps=1e-8 semantics (tests/test_advection.py::TestF32Weights).

## Round-5 attribution of the residual 64² low_B_low_U envelope

After the r3 fixes the 64² low_B_low_U deviation envelopes sit at 1.84
(jacobian) / 2.32 (conservative) vs the recorded 0.78 / 1.03 — the
loosest of the 60 anchors. r5 re-tested every remaining discretization
candidate, now measured with the reference-convention functionals
(`diagnostics.reference_energy_report`; the r2-era exonerations used the
old interpolated functionals, which had masked the r3 fix itself).
Variant matrix (`benchmarks/exp/r5_lowBlowU_residual.py`, f64, t=0..15):

| variant | jacobian dev_max | conservative dev_max |
|---|---|---|
| base (shipped) | 1.842 | 2.315 |
| `rampbeta0` control (hand-rolled recon path, no change) | 1.842 | 2.315 |
| `rampbeta`: tracer y-betas on the FULL field −0.05y + A′ (≡ advecting the full field with gradient-BC ghosts, as the reference does) | 1.966 | 2.362 |
| `nodegrade`: near-wall WENO degradation removed (full 5-pt stencils on clamped ghosts) | 1.842 | 2.315 |
| both | 1.966 | 2.362 |

Δt sweep (jacobian, same anchors): dev_max = 1.847 / 1.842 / 1.842 /
1.842 at Δt = 0.02 / 0.01 / 0.005 / 0.0025 — **time discretization
contributes nothing**; the envelope is purely spatial.

Conclusions, quantitatively:

1. **Wall handling is exonerated**: removing the near-wall stencil
   degradation changes the envelope by < 0.001 (the wall-normal
   transport vanishes at the walls, so the degraded stencils barely
   fire). The r4 term-by-term budget agrees: wall-adjacent terms
   (vorticity flux −0.006, gravity/mass −0.0001) are two orders below
   the leak.
2. **The background split is exonerated**: computing the WENO smoothness
   indicators on the full ramp-carrying field — algebraically what the
   reference's gradient-BC ghosts produce — moves the envelope the
   *wrong* way (1.84 → 1.97). Candidate polynomials are affine-exact
   either way.
3. **Δt transcription is exonerated** (table above).
4. What remains is what the r3 budget already identified: the
   Lorentz-work/induction mismatch (−0.188 vs +0.137+0.010 integrals) —
   upwind dissipation of the wound-up A-spiral once it reaches grid
   scale at 64². This term is a direct function of the WENO weight
   details of the unpinnable Oceananigans vintage (r3 showed switching
   Jiang–Shu → WENO-Z alone moved this scenario 6.0 → 1.84 and
   *reproduces the recorded curve's shape*). At 128², where the spiral
   is resolved, our envelopes match the recorded values at ratio
   **1.00×** (jac, 0.532 vs 0.53) and **0.86×** (cons, 0.337 vs 0.39),
   and the 64² end-state energies agree within 3–4%.

The residual 2.3× at 64² is therefore attributed to grid-scale WENO
weight/flavor differences against an unpinnable upstream vintage (plus
reverse-engineered-IC noise), not to any wall, source-term, or time-
stepping defect — with each alternative hypothesis now carrying a
measured exoneration. The 3× acceptance gate stands on that evidence."""


if __name__ == "__main__":
    main()
