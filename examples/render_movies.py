"""Render the 12 scenario movies + first/last-frame parity comparisons.

The reference's remaining C9 artifact class (SURVEY §2.1) is the 12
scenario movies `simulation_runs/{jacobian,divergence}_formulation/*.mp4`
— 800x400 two-panel (Magnetic potential | Speed) animations recorded
every 0.1 time units at 96 fps. This script reruns every scenario x
formulation, writes our equivalents to `validation/movies/*.mp4` (OpenCV
mp4 encoder; ffmpeg is not in the image), and composes side-by-side
first/last-frame comparisons against the reference mp4s
(`validation/movies/compare_*.png`) for the VALIDATION.md parity table.

The displayed magnetic potential includes the static background ramp
(A_total = A + γ·y) so the low_B_low_U panels compare like-for-like with
the reference's full-A movies.

Usage:
    python examples/render_movies.py [--only NAME] [--dtype float32]
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

# a CPU job on purpose: it compares against the reference's CPU runs, and
# jax.config holds even where JAX_PLATFORMS names another backend
jax.config.update("jax_platforms", "cpu")

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference/simulation_runs"
OUT = os.path.join(REPO, "validation", "movies")

FORM_DIR = {"vector_invariant": "jacobian_formulation",
            "conservative": "divergence_formulation"}
SCENARIOS = ["64x64_two_Gaussians_low_B", "64x64_two_Gaussians_high_B",
             "64x64_low_B_low_U", "128x128_two_Gaussians_low_B",
             "128x128_two_Gaussians_high_B", "128x128_low_B_low_U"]

# recorded-run durations that differ from the scenario registry's default
# (reference movie frame count x 0.1 = the stop validate_reference pins)
REF_STOP = {
    ("conservative", "64x64_two_Gaussians_low_B"): 60.0,
    ("conservative", "64x64_two_Gaussians_high_B"): 10.0,
}


def run_and_render(scen_name, formulation, dtype_str, workdir):
    import jax
    import jax.numpy as jnp
    from swmhd_tpu import scenarios, viz
    import swmhd_tpu.operators as op
    from swmhd_tpu.simulation import Simulation, TimeInterval
    from swmhd_tpu.io import FieldWriter

    dtype = jnp.float64 if dtype_str == "float64" else jnp.float32
    model, state, sc = scenarios.build(scen_name, formulation, dtype=dtype)
    # the recorded runs' durations differ per formulation (reference
    # movie frame counts x 0.1; same stop times validate_reference pins —
    # not imported from there because its import flips jax_enable_x64)
    stop = REF_STOP.get((formulation, scen_name), sc.stop_time)
    import dataclasses
    sc = dataclasses.replace(sc, stop_time=stop)
    gamma = getattr(model, "A_background_gradient_y", 0.0)
    g = model.grid
    _, Yc = g.nodes("cc")

    def A_total(s):
        return s.state.A + gamma * Yc

    def speed(s):
        u, v = s.model.velocities(s.state)
        return jnp.sqrt(op.ix_c(u, g) ** 2 + op.iy_c(v, g) ** 2)

    sim = Simulation(model, dt=sc.dt, stop_time=sc.stop_time)
    fields_dir = os.path.join(workdir, "fields")
    sim.output_writers["fields"] = FieldWriter(
        outputs={"A_total": A_total, "s": speed},
        schedule=TimeInterval(0.1), path=fields_dir)
    sim.run(state)

    os.makedirs(OUT, exist_ok=True)
    mp4 = os.path.join(OUT, f"{formulation}_{scen_name}.mp4")
    made = viz.render_movie(
        fields_dir, mp4, names=("A_total", "s"),
        titles=("Magnetic potential", "Speed"), fps=96,
        autoscale=True, figsize=(8, 4))
    with open(os.path.join(fields_dir, "meta.json")) as f:
        times = json.load(f)["times"]
    return made, times


def _ref_frame(cap, idx):
    import cv2
    cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
    ok, img = cap.read()
    while not ok and idx > 0:
        idx -= 1
        cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
        ok, img = cap.read()
    return img


def _our_frame(path, idx):
    import cv2
    cap = cv2.VideoCapture(path)
    img = _ref_frame(cap, idx)
    cap.release()
    return img


def _label(img, text):
    import cv2
    img = img.copy()
    cv2.rectangle(img, (0, 0), (330, 28), (255, 255, 255), -1)
    cv2.putText(img, text, (6, 20), cv2.FONT_HERSHEY_SIMPLEX, 0.6,
                (0, 0, 0), 1, cv2.LINE_AA)
    return img


def compare(scen_name, formulation, our_mp4, our_times):
    """2x2 grid: rows = (t=0.1, t=end), cols = (reference, ours)."""
    import cv2
    ref_mp4 = os.path.join(REF, FORM_DIR[formulation], f"{scen_name}.mp4")
    cap = cv2.VideoCapture(ref_mp4)
    nref = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    # reference frame i is at t = 0.1*(i+1); ours carries real times
    rows = []
    for t_target, ref_idx in ((0.1, 0), (None, nref - 1)):
        if t_target is None:
            our_idx = len(our_times) - 1
            t_target = our_times[-1]
        else:
            our_idx = int(np.argmin([abs(t - t_target) for t in our_times]))
        r = _label(_ref_frame(cap, ref_idx),
                   f"reference  t={0.1 * (ref_idx + 1):.1f}")
        o = _label(_our_frame(our_mp4, our_idx),
                   f"swmhd_tpu  t={our_times[our_idx]:.1f}")
        if r.shape != o.shape:
            o = cv2.resize(o, (r.shape[1], r.shape[0]))
        rows.append(np.hstack([r, o]))
    cap.release()
    grid = np.vstack(rows)
    out = os.path.join(OUT, f"compare_{formulation}_{scen_name}.png")
    cv2.imwrite(out, grid)
    return out, nref


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="substring filter on '<formulation>_<scenario>'")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "float64"])
    args = ap.parse_args()

    manifest = []
    for formulation in ("vector_invariant", "conservative"):
        for scen in SCENARIOS:
            tag = f"{formulation}_{scen}"
            if args.only and args.only not in tag:
                continue
            print(f"== {tag}", flush=True)
            with tempfile.TemporaryDirectory() as wd:
                mp4, times = run_and_render(scen, formulation,
                                            args.dtype, wd)
            cmp_png, nref = compare(scen, formulation, mp4, times)
            manifest.append({
                "formulation": formulation, "scenario": scen,
                "movie": os.path.relpath(mp4, REPO),
                "compare": os.path.relpath(cmp_png, REPO),
                "our_frames": len(times), "ref_frames": nref,
                "t_end": round(times[-1], 3),
            })
            print(f"   {mp4} ({len(times)} frames; ref {nref})", flush=True)
    # merge with any prior manifest so --only reruns update in place
    path = os.path.join(OUT, "manifest.json")
    merged = []
    if os.path.exists(path):
        with open(path) as f:
            merged = json.load(f)
    new_keys = {(m["formulation"], m["scenario"]) for m in manifest}
    merged = [m for m in merged
              if (m["formulation"], m["scenario"]) not in new_keys]
    merged += manifest
    merged.sort(key=lambda m: (m["formulation"], m["scenario"]))
    with open(path, "w") as f:
        json.dump(merged, f, indent=1)
    print(json.dumps(manifest, indent=1))


if __name__ == "__main__":
    main()
