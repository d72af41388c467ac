"""Chip check: drive the solver's main path once on an NVIDIA GPU and check
what comes out.

Run from the root of a checkout:

    python chip_smoke.py               # one GPU: phases 1-5
    python chip_smoke.py --four-cards  # four GPUs: the sharded step only

Phases, in order (each failure is reported, and any failure exits 1):

 1. device — the first JAX device must be a GPU; prints its kind, the
    device count, and each card's name and power limit. Without a GPU the
    script stops here: it never continues on the CPU.
 2. reference regression — 1000 f32 RK3 steps of
    64x64_two_Gaussians_high_B in both formulations against the committed
    float64 fixtures (tests/fixtures), each field's drift within the
    calibrated f32 bound (the rule of tests/test_regression.py).
 3. full-size step vs the plain reference — 10 f32 steps of ``bench.build``
    at 2048² in both formulations (vector-invariant + jacobian Lorentz,
    conservative + divergence Lorentz) on the GPU against the same 10
    steps on the host's CPU backend. Also checks that the compiled GPU
    program holds no matrix product, prints its memory analysis, and times
    5 chunks of 20 steps.
 4. the CLI end to end — ``swmhd_tpu.cli.main(["run", ...])`` with field
    snapshots, the energy series and checkpoints, then a resume from the
    checkpoint; checks the files and their row counts.
 5. scenario anchors — two recorded scenarios run whole in f32 through
    ``Simulation``, judged by the float64 CPU gate's anchors
    (examples/validation_anchors.py).

With ``--four-cards`` only the four-card phase runs: the sharded XLA step
(``DomainDecomposition.step_fn``) on a 2x2 mesh over a periodic 4096² grid
and on a 4x1 mesh over a 4096² grid with walls in y, each with and without
the comm/compute overlap split, against the single-card step on device 0.

Every line before the last is tagged with the cards' name and power limit.
The last line of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

import argparse
import json
import os
import re
import statistics
import sys
import tempfile
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "examples"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from swmhd_tpu import scenarios  # noqa: E402
from swmhd_tpu.runtime import (configure_compile_cache, gpu_cards,  # noqa: E402
                               require_gpu)

FIELDS = ("h", "u", "v", "A")

# phase 2: the committed fixtures (tests/test_regression.py's CASES)
FIXTURE_DIR = os.path.join(REPO, "tests", "fixtures")
REGRESSION_CASES = {"jacobian_64": "vector_invariant",
                    "divergence_64": "conservative"}
REGRESSION_SCENARIO = "64x64_two_Gaussians_high_B"
REGRESSION_STEPS, REGRESSION_DT = 1000, 0.01

# phases 3 and four-card: max|got - reference| <= STEP_RTOL * max|reference|
# per field. The step has no matrix product, so the GPU and the CPU differ
# only by summation order and FMA contraction, i.e. by float32 roundoff.
# On the CPU, float32 against float64 over the same 10 steps differs by up
# to 0.8e-6 of a field's scale at 256², 1.3e-6 at 1024², growing with N;
# an H100 against the CPU differed by up to 5.5e-6 at 2048². The bound is
# ~10x that.
STEP_RTOL = 5e-5
_MATMUL = re.compile(r"\b(dot|convolution)\(|cublas", re.IGNORECASE)

# phase 5: (formulation, scenario) pairs, one periodic, one with walls in y
ANCHOR_CASES = (("vector_invariant", "128x128_two_Gaussians_high_B"),
                ("conservative", "128x128_low_B_low_U"))


def step_dt(N):
    """bench.DT, scaled down above 2048² so the CFL number stays put."""
    return bench.DT * min(1.0, 2048 / N)


# -- phase 2 -------------------------------------------------------------------


def regression_drift(key, device):
    """``{field: (drift, bound)}`` of the f32 run of fixture ``key`` on
    ``device`` against the committed float64 fixture."""
    model, state, _ = scenarios.build(REGRESSION_SCENARIO,
                                      REGRESSION_CASES[key],
                                      dtype=jnp.float32)
    out = jax.jit(model.step_fn(REGRESSION_DT, REGRESSION_STEPS))(
        jax.device_put(state, device))
    want = np.load(os.path.join(FIXTURE_DIR, f"{key}.npz"))
    tol = np.load(os.path.join(FIXTURE_DIR, "f32_tolerance.npz"))
    return {name: (float(np.max(np.abs(np.asarray(getattr(out, name))
                                       - want[name]))),
                   float(tol[f"{key}:{name}"]))
            for name in FIELDS}


def phase_regression(log, device):
    bad = []
    for key in REGRESSION_CASES:
        for name, (drift, bound) in regression_drift(key, device).items():
            ok = drift <= bound
            log(f"regression {key}:{name} drift {drift:.3e} bound "
                f"{bound:.3e} {'ok' if ok else 'EXCEEDED'}")
            if not ok:
                bad.append(f"{key}:{name}")
    if bad:
        raise AssertionError(f"f32 drift above the calibrated bound: {bad}")


# -- phase 3 -------------------------------------------------------------------


def field_errors(got, ref):
    """``{field: (max_abs, max_rel)}``, max_rel = max_abs / max|ref|."""
    out = {}
    for name in FIELDS:
        a = np.asarray(getattr(got, name), np.float64)
        b = np.asarray(getattr(ref, name), np.float64)
        if not (np.all(np.isfinite(a)) and np.all(np.isfinite(b))):
            raise AssertionError(f"{name}: non-finite values")
        max_abs = float(np.max(np.abs(a - b)))
        out[name] = (max_abs, max_abs / float(np.max(np.abs(b))))
    return out


def compare_step(formulation, device, cpu, N, n_steps=10, chunks=5):
    """Run ``n_steps`` steps of ``bench.build(N, formulation)`` on
    ``device`` and on ``cpu``; returns the errors, the compiled program's
    facts and the timing of ``chunks`` chunks of ``2 * n_steps`` steps."""
    model, state = bench.build(N, formulation)
    fn = jax.jit(model.step_fn(step_dt(N), n_steps))
    on_dev = jax.device_put(state, device)
    t0 = time.perf_counter()
    compiled = fn.lower(on_dev).compile()
    compile_s = time.perf_counter() - t0
    hlo = compiled.as_text()
    out = jax.block_until_ready(compiled(on_dev))
    ref = fn(jax.device_put(state, cpu))
    errors = field_errors(out, ref)

    times = []
    s = out
    for _ in range(chunks):
        t0 = time.perf_counter()
        s = jax.block_until_ready(compiled(compiled(s)))
        times.append(time.perf_counter() - t0)
    median = statistics.median(times)
    return {"errors": errors, "compile_s": compile_s,
            "matmul_ops": sorted(set(m.group(0).lower()
                                     for m in _MATMUL.finditer(hlo))),
            "memory": memory_bytes(compiled),
            "chunk_s": times, "points_per_s": N * N * 2 * n_steps / median}


def memory_bytes(compiled):
    """The byte counts of ``compiled.memory_analysis()``."""
    stats = compiled.memory_analysis()
    return {k: getattr(stats, k) for k in dir(stats)
            if k.endswith("_in_bytes")}


def phase_full_step(log, device, cpu, N=2048):
    bad = []
    for formulation in ("vector_invariant", "conservative"):
        r = compare_step(formulation, device, cpu, N)
        tag = f"{N}^2 {formulation}"
        log(f"{tag}: compile {r['compile_s']:.2f} s; memory_analysis "
            f"{r['memory']}")
        if r["matmul_ops"]:
            bad.append(f"{tag} matrix product in compiled HLO: "
                       f"{r['matmul_ops']}")
        log(f"{tag}: compiled HLO matrix-product ops: "
            f"{r['matmul_ops'] or 'none'}")
        for name, (max_abs, max_rel) in r["errors"].items():
            ok = max_rel <= STEP_RTOL
            log(f"{tag} {name}: max abs {max_abs:.3e} max rel {max_rel:.3e} "
                f"(tolerance max rel {STEP_RTOL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"{tag} {name}")
        log(f"{tag}: chunks of 20 steps {['%.6f' % t for t in r['chunk_s']]}"
            f" s; median rate {r['points_per_s']:.6e} pts/s")
    if bad:
        raise AssertionError(f"GPU step differs from the CPU step: {bad}")


# -- phase 4 -------------------------------------------------------------------


def cli_roundtrip(log, workdir, scenario="128x128_two_Gaussians_high_B",
                  stop=0.5, resume_stop=0.8, checkpoint_every=20):
    """Run the CLI with snapshots, energies and checkpoints, then resume
    from the checkpoint; checks the outputs. dt is the scenario's."""
    from swmhd_tpu import cli

    dt = scenarios.get(scenario).dt
    first = os.path.join(workdir, "run")
    cli.main(["run", scenario, "--outdir", first, "--stop-time", str(stop),
              "--fields-interval", "0.1", "--energies-every", "1",
              "--checkpoint-every", str(checkpoint_every),
              "--progress-every", "25"])
    steps = round(stop / dt)
    _check_run(log, first, steps + 1, round(stop / 0.1) + 1)
    ckpt = os.path.join(first, "checkpoint.npz")
    if not os.path.isfile(ckpt):
        raise AssertionError(f"no checkpoint at {ckpt}")
    at = (steps // checkpoint_every) * checkpoint_every

    second = os.path.join(workdir, "resumed")
    cli.main(["run", scenario, "--outdir", second, "--stop-time",
              str(resume_stop), "--resume", ckpt, "--fields-interval", "0.1",
              "--progress-every", "25"])
    rows = _check_run(log, second, round(resume_stop / dt) - at + 1,
                      round((resume_stop - at * dt) / 0.1) + 1)
    if int(rows[0]["iteration"]) != at:
        raise AssertionError(f"resumed run starts at iteration "
                             f"{rows[0]['iteration']}, checkpoint at {at}")


def _check_run(log, outdir, n_rows, n_snapshots):
    import csv

    for f in ("final.npz", "energies.csv", os.path.join("fields",
                                                          "meta.json")):
        if not os.path.isfile(os.path.join(outdir, f)):
            raise AssertionError(f"missing {f} in {outdir}")
    with open(os.path.join(outdir, "energies.csv")) as f:
        rows = list(csv.DictReader(f))
    if len(rows) != n_rows:
        raise AssertionError(f"{outdir}: {len(rows)} energy rows, "
                             f"expected {n_rows}")
    if not all(np.isfinite(float(r["total_energy"])) for r in rows):
        raise AssertionError(f"{outdir}: non-finite total energy")
    snaps = sorted(os.listdir(os.path.join(outdir, "fields", "A")))
    if len(snaps) != n_snapshots:
        raise AssertionError(f"{outdir}: {len(snaps)} A snapshots, "
                             f"expected {n_snapshots}")
    log(f"cli {os.path.basename(outdir)}: {len(rows)} energy rows "
        f"(iterations {rows[0]['iteration']}..{rows[-1]['iteration']}), "
        f"{len(snaps)} field snapshots, final.npz present")
    return rows


# -- phase 5 -------------------------------------------------------------------


def anchor_checks(formulation, name, workdir, stop=None):
    """``(summary, checks)`` of one scenario run in f32 through
    ``Simulation`` to ``stop`` (default: the recorded stop time)."""
    from validate_gpu import run_case
    from validation_anchors import REFERENCE, judge, summarize

    ref = REFERENCE[(formulation, name)]
    csv, _ = run_case(formulation, name, stop or ref["stop"], workdir)
    got = summarize(csv)
    return got, judge(ref, got)


def phase_anchors(log, workdir):
    failed = []
    for formulation, name in ANCHOR_CASES:
        t0 = time.perf_counter()
        got, checks = anchor_checks(formulation, name, workdir)
        ok = all(checks.values())
        log(f"anchor {formulation} {name}: {'PASS' if ok else 'FAIL'} "
            f"({time.perf_counter() - t0:.1f} s) "
            + ", ".join(f"{k}={got[k]:.4g}:{'ok' if v else 'NO'}"
                        for k, v in checks.items()))
        if not ok:
            failed.append(f"{formulation} {name}")
    if failed:
        raise AssertionError(f"anchors failed: {failed}")


# -- four cards ------------------------------------------------------------------


FOUR_CARD_CASES = (
    ("2x2 periodic", (2, 2), ("periodic", "periodic"), "vector_invariant"),
    ("4x1 walls in y", (4, 1), ("periodic", "bounded"), "conservative"),
)


def four_card_errors(N=4096, n_steps=10):
    """``{(case, overlap): {field: (max_abs, max_rel)}}`` of the sharded
    step against the single-device step on device 0."""
    from swmhd_tpu.parallel import DomainDecomposition, make_mesh

    out = {}
    for label, shape, topology, formulation in FOUR_CARD_CASES:
        model, state = bench.build(N, formulation, topology)
        dt = step_dt(N)
        ref = jax.jit(model.step_fn(dt, n_steps))(
            jax.device_put(state, jax.devices()[0]))
        for overlap in (False, True):
            dd = DomainDecomposition(model, make_mesh(shape=shape),
                                     overlap=overlap)
            got = dd.step_fn(dt, n_steps)(dd.shard_state(state))
            out[(label, overlap)] = field_errors(got, ref)
    return out


def phase_four_cards(log, N=4096):
    bad = []
    for (label, overlap), errors in four_card_errors(N).items():
        for name, (max_abs, max_rel) in errors.items():
            ok = max_rel <= STEP_RTOL
            log(f"{N}^2 {label} overlap={overlap} {name}: max abs "
                f"{max_abs:.3e} max rel {max_rel:.3e} (tolerance max rel "
                f"{STEP_RTOL:g}) {'ok' if ok else 'FAIL'}")
            if not ok:
                bad.append(f"{label} overlap={overlap} {name}")
    if bad:
        raise AssertionError(f"sharded step differs from one card: {bad}")


# -- driver ----------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded-step phase")
    args = ap.parse_args(argv)

    # phase 3's reference runs on the host's CPU backend, so keep it
    # initialised beside the GPU where JAX_PLATFORMS names only the GPU
    platforms = jax.config.jax_platforms
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", platforms + ",cpu")

    # phase 1: device — no GPU, no run
    device = require_gpu()
    cards = gpu_cards()
    tag = "; ".join(cards)

    def log(msg):
        print(f"[{tag}] {msg}", flush=True)

    log(f"device: platform {device['platform']}, kind {device['kind']}, "
        f"count {device['count']}")
    for card in cards:
        log(f"card (name, power.limit): {card}")
    log(f"compile cache: {configure_compile_cache()}")

    gpu = jax.devices()[0]
    with tempfile.TemporaryDirectory(prefix="swmhd_chip_smoke_") as workdir:
        failed = run_phases(log, args.four_cards, device, gpu, workdir)
    if failed:
        log(f"FAILED phases: {failed}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}))
    return 0


def run_phases(log, four_cards, device, gpu, workdir):
    """Run the phases in order; returns the names of those that failed."""
    if four_cards:
        if device["count"] < 4:
            raise RuntimeError(f"--four-cards needs 4 GPUs, JAX found "
                               f"{device['count']}")
        phases = [("four-card sharded step", lambda: phase_four_cards(log))]
    else:
        cpu = jax.devices("cpu")[0]
        phases = [
            ("2 reference regression", lambda: phase_regression(log, gpu)),
            ("3 full-size step vs CPU",
             lambda: phase_full_step(log, gpu, cpu)),
            ("4 CLI end to end", lambda: cli_roundtrip(log, workdir)),
            ("5 scenario anchors", lambda: phase_anchors(log, workdir)),
        ]
    failed = []
    for name, run in phases:
        log(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            run()
        except Exception:  # reported, counted as a failure, never a pass
            traceback.print_exc()
            failed.append(name)
            log(f"phase {name}: FAIL")
        else:
            log(f"phase {name}: PASS ({time.perf_counter() - t0:.1f} s)")
    return failed


if __name__ == "__main__":
    sys.exit(main())
