"""Quantitative movie parity: per-frame similarity scores vs the reference.

The 12 `compare_*.png` artifacts alone are eyeball-only.
This script scores every scenario movie numerically against the
reference's recorded mp4s (`/root/reference/simulation_runs/*/*.mp4`,
SURVEY §2.1 C9) and writes the scores into
`validation/movies/manifest.json` for adjudication in VALIDATION.md.

Method (rendering-independent): both movies' panels are DECODED back to
field values and compared at the field level —

  - panel plot areas are detected from color saturation (the figure
    chrome is grayscale; the colormapped interiors are not);
  - the reference's Makie ``colormap=:deep`` (cmocean deep;
    SWMHD_example.jl:121-123) is not installed here, so its RGB→value
    curve is CALIBRATED from the artifact itself: the t=0.1 frame of
    `jacobian_formulation/64x64_low_B_low_U.mp4` shows the unevolved
    linear ramp A = −0.05·y under a global colorrange, i.e. panel row ↔
    value is exactly linear — column-averaged row colors give the
    colormap table (saved to validation/movies/deep_colormap.npz);
  - our movies invert through matplotlib's exact viridis table;
  - both value fields are resampled to a common grid, z-scored, and
    compared with Pearson NCC plus Spearman rank correlation (immune to
    any residual monotone error in the calibrated table), at the t=0.1,
    mid-run, and final frames.

Scores land in manifest.json as
``scores[{A,s}][{t0,mid,end}] = {ncc, spearman}``.
"""
import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/root/reference/simulation_runs"
OUT = os.path.join(REPO, "validation", "movies")

FORM_DIR = {"vector_invariant": "jacobian_formulation",
            "conservative": "divergence_formulation"}

GRID = 128  # common comparison resolution


# -- panel detection -------------------------------------------------------------

def panel_boxes(frame, min_width=60):
    """(col0, col1, row0, row1) of the colormapped plot areas, left to
    right, found as wide column runs of color-saturated pixels."""
    sat = (frame.max(axis=2).astype(int)
           - frame.min(axis=2).astype(int)) > 20
    colact = sat.sum(axis=0)
    H, W = sat.shape
    runs, c = [], 0
    while c < W:
        if colact[c] > H * 0.25:
            s = c
            while c < W and colact[c] > H * 0.25:
                c += 1
            if c - s > min_width:
                runs.append((s, c))
        else:
            c += 1
    boxes = []
    for s, e in runs:
        rowact = sat[:, s:e].sum(axis=1)
        rr = np.where(rowact > (e - s) * 0.6)[0]
        boxes.append((s, e, int(rr.min()), int(rr.max()) + 1))
    if len(boxes) >= 2:
        # panels share the axis row span in both figure layouts; unify
        r0 = min(b[2] for b in boxes)
        r1 = max(b[3] for b in boxes)
        boxes = [(b[0], b[1], r0, r1) for b in boxes]
    return boxes


def read_frame(path, idx):
    import cv2
    cap = cv2.VideoCapture(path)
    cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
    ok, img = cap.read()
    while not ok and idx > 0:
        idx -= 1
        cap.set(cv2.CAP_PROP_POS_FRAMES, idx)
        ok, img = cap.read()
    n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    cap.release()
    return img, n


# -- colormap tables -------------------------------------------------------------

def calibrate_deep(force=False):
    """Calibrate the reference's :deep RGB(BGR)→value table from the
    t=0.1 low_B_low_U ramp frame; cached in validation/movies."""
    cache = os.path.join(OUT, "deep_colormap.npz")
    if os.path.exists(cache) and not force:
        return np.load(cache)["table"]
    frame, _ = read_frame(
        os.path.join(REF, "jacobian_formulation", "64x64_low_B_low_U.mp4"),
        0)
    boxes = panel_boxes(frame)
    c0, c1, r0, r1 = boxes[0]  # the A panel: a pure vertical ramp
    panel = frame[r0:r1, c0:c1].astype(np.float64)
    rows = panel.mean(axis=1)  # (H, 3) column-averaged BGR per row
    # row 0 (top, y=+L/2) is A=-0.05*(+L/2) -> the colorrange MINIMUM, so
    # normalized value runs 0 (top) -> 1 (bottom)
    u = np.linspace(0.0, 1.0, rows.shape[0])
    tbl = np.empty((256, 3))
    for ch in range(3):
        tbl[:, ch] = np.interp(np.linspace(0, 1, 256), u, rows[:, ch])
    os.makedirs(OUT, exist_ok=True)
    np.savez(cache, table=tbl)
    return tbl


def viridis_table():
    import matplotlib
    rgba = matplotlib.colormaps["viridis"](np.linspace(0, 1, 256))
    return (rgba[:, [2, 1, 0]] * 255.0)  # BGR to match cv2 frames


def invert_panel(panel_bgr, table):
    """Nearest-neighbor inversion of a colormapped panel to values in
    [0,1] (vectorized over a 256-entry table)."""
    p = panel_bgr.reshape(-1, 3).astype(np.float64)
    d2 = ((p[:, None, :] - table[None, :, :]) ** 2).sum(-1)
    idx = d2.argmin(axis=1)
    return (idx / 255.0).reshape(panel_bgr.shape[:2])


# -- scoring ---------------------------------------------------------------------

def _zscore(a):
    a = a - a.mean()
    s = a.std()
    return a / s if s > 0 else a


DENOISE_SIGMA = 1.5  # grid cells at GRID resolution (~1.2% of domain):
# removes the reference mp4s' codec macroblock noise, which otherwise
# dominates the z-scored correlation on panels that are mostly flat
# (e.g. the two-Gaussian dipole on a zero background); real structure at
# the recorded 64²/128² resolutions is much coarser than this kernel.


def score_pair(ref_panel, our_panel, ref_table, our_table):
    import cv2
    from scipy import stats
    rv = invert_panel(ref_panel, ref_table)
    ov = invert_panel(our_panel, our_table)
    rv = cv2.resize(rv, (GRID, GRID), interpolation=cv2.INTER_AREA)
    ov = cv2.resize(ov, (GRID, GRID), interpolation=cv2.INTER_AREA)
    raw = float(np.mean(_zscore(rv) * _zscore(ov)))
    rv = cv2.GaussianBlur(rv, (0, 0), DENOISE_SIGMA)
    ov = cv2.GaussianBlur(ov, (0, 0), DENOISE_SIGMA)
    ncc = float(np.mean(_zscore(rv) * _zscore(ov)))
    rho = float(stats.spearmanr(rv.ravel(), ov.ravel()).statistic)
    return {"ncc": round(ncc, 4), "ncc_raw": round(raw, 4),
            "spearman": round(rho, 4)}


def recolor_compare(formulation, scenario, pairs):
    """Side-by-side PNG with BOTH sides in the reference's colormap:
    our decoded panel values are re-rendered through the calibrated
    :deep table, so the eyeball comparison is like-for-like (the r3
    viridis-vs-deep lightness inversion disappears). ``pairs`` =
    [(tag, t, ref_frame_panels, our_value_panels)]."""
    import cv2
    deep = calibrate_deep()
    rows = []
    for tag, t, ref_panels, our_values in pairs:
        cells = []
        for rp, ov in zip(ref_panels, our_values):
            h, w = rp.shape[:2]
            ov_img = deep[np.clip((ov * 255).astype(int), 0, 255)]
            ov_img = cv2.resize(ov_img.astype(np.uint8), (w, h))
            pad = np.full((h, 8, 3), 255, np.uint8)
            cells += [rp, pad, ov_img, pad]
        row = np.hstack(cells[:-1])
        bar = np.full((26, row.shape[1], 3), 255, np.uint8)
        cv2.putText(bar, f"t={t:.1f}   [ref A | ours A | ref s | ours s]"
                    " (both in the reference's :deep colormap)",
                    (6, 18), cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 0, 0), 1,
                    cv2.LINE_AA)
        rows += [bar, row]
    maxw = max(r.shape[1] for r in rows)
    rows = [np.pad(r, ((0, 0), (0, maxw - r.shape[1]), (0, 0)),
                   constant_values=255) for r in rows]
    out = os.path.join(OUT, f"compare_deep_{formulation}_{scenario}.png")
    cv2.imwrite(out, np.vstack(rows))
    return out


def score_movie(formulation, scenario, our_mp4, our_frames,
                our_style="viridis"):
    ref_mp4 = os.path.join(REF, FORM_DIR[formulation], f"{scenario}.mp4")
    _, nref = read_frame(ref_mp4, 0)
    deep = calibrate_deep()
    vir = deep if our_style == "ref" else viridis_table()
    # reference frame i is t=0.1(i+1); our frame k is t=0.1k (we also
    # record t=0) -> our index = ref index + 1
    n = min(nref, our_frames - 1)
    targets = {"t0": 0, "mid": n // 2, "end": n - 1}
    out = {}
    recolor_pairs = []
    for tag, ri in targets.items():
        rframe, _ = read_frame(ref_mp4, ri)
        oframe, _ = read_frame(our_mp4, ri + 1)
        rboxes = panel_boxes(rframe)
        oboxes = panel_boxes(oframe)
        if len(rboxes) < 2 or len(oboxes) < 2:
            out[tag] = {"error": f"panels {len(rboxes)}/{len(oboxes)}"}
            continue
        entry = {"t": round(0.1 * (ri + 1), 2)}
        ref_panels, our_values = [], []
        for name, k in (("A", 0), ("s", 1)):
            rp = rframe[rboxes[k][2]:rboxes[k][3],
                        rboxes[k][0]:rboxes[k][1]]
            op_ = oframe[oboxes[k][2]:oboxes[k][3],
                         oboxes[k][0]:oboxes[k][1]]
            entry[name] = score_pair(rp, op_, deep, vir)
            ref_panels.append(rp)
            our_values.append(invert_panel(op_, vir))
        out[tag] = entry
        recolor_pairs.append((tag, entry["t"], ref_panels, our_values))
    if recolor_pairs:
        recolor_compare(formulation, scenario, recolor_pairs)
    return out


# Adjudication thresholds (VALIDATION.md §movie parity): denoised NCC.
A_THRESHOLD = 0.90
S_THRESHOLD = 0.85
# Rest-start scenarios (u=v=0 ICs): the t=0.1 speed panel holds no
# signal (both movies show ≈0 + codec noise) — excluded from the gate.
REST_START = ("two_Gaussians_low_B", "two_Gaussians_high_B")


def adjudicate(scenario, scores):
    checks = []
    for tag, t in scores.items():
        if "A" not in t:
            return False
        checks.append(t["A"]["ncc"] >= A_THRESHOLD)
        degenerate = (tag == "t0"
                      and any(scenario.endswith(r) for r in REST_START))
        if not degenerate:
            checks.append(t["s"]["ncc"] >= S_THRESHOLD)
    return all(checks)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None)
    args = ap.parse_args()

    path = os.path.join(OUT, "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    for m in manifest:
        tag = f"{m['formulation']}_{m['scenario']}"
        if args.only and args.only not in tag:
            continue
        our_mp4 = os.path.join(REPO, m["movie"])
        m["scores"] = score_movie(m["formulation"], m["scenario"],
                                  our_mp4, m["our_frames"],
                                  our_style=m.get("style", "viridis"))
        m["parity"] = "PASS" if adjudicate(m["scenario"], m["scores"]) \
            else "FAIL"
        print(tag, m["parity"], json.dumps(m["scores"]), flush=True)
    with open(path, "w") as f:
        json.dump(manifest, f, indent=1)


if __name__ == "__main__":
    main()
