"""Shared scenario anchors + acceptance logic for the validation drivers.

Split out of validate_reference.py so the GPU f32 validation
(validate_gpu.py, and phase 5 of chip_smoke.py) can reuse the identical
anchor table and judge without importing validate_reference's
module-level jax CPU config.

Anchors are transcribed from the reference's recorded energy plots
(/root/reference/energy_plots/<formulation>/<scenario>.png, SURVEY §2.1
C9); see validate_reference.py NOTES for provenance and tolerances.
"""

import numpy as np

# "dev_max" is the peak of the reference's "relative energy error (%)"
# panel = |E - E0| * 100 (an absolute deviation, SURVEY §2.3.4). Stop
# times differ per formulation (whatever the recorded runs used). ke0 is
# omitted for rest starts (== 0).
REFERENCE = {
    ("vector_invariant", "64x64_two_Gaussians_low_B"):
        dict(stop=70.0, ke_end=0.0027, me0=0.0217, me_end=0.0187,
             dev_max=0.027),
    ("vector_invariant", "64x64_two_Gaussians_high_B"):
        dict(stop=35.0, ke_end=0.051, me0=0.542, me_end=0.455, dev_max=3.7),
    ("vector_invariant", "64x64_low_B_low_U"):
        dict(stop=15.0, ke0=0.3927, ke_end=0.18, me0=0.125, me_end=0.313,
             dev_max=0.78),
    ("vector_invariant", "128x128_two_Gaussians_low_B"):
        dict(stop=60.0, ke_end=0.0029, me0=0.0218, me_end=0.0187,
             dev_max=0.010),
    ("vector_invariant", "128x128_two_Gaussians_high_B"):
        dict(stop=35.0, ke_end=0.079, me0=0.546, me_end=0.50, dev_max=5.3),
    ("vector_invariant", "128x128_low_B_low_U"):
        dict(stop=15.0, ke0=0.393, ke_end=0.155, me0=0.125, me_end=0.357,
             dev_max=0.53),
    ("conservative", "64x64_two_Gaussians_low_B"):
        dict(stop=60.0, ke_end=0.00315, me0=0.0217, me_end=0.0195,
             dev_max=0.107),
    ("conservative", "64x64_two_Gaussians_high_B"):
        dict(stop=10.0, ke_end=0.076, me0=0.542, me_end=0.470, dev_max=1.2),
    ("conservative", "64x64_low_B_low_U"):
        dict(stop=15.0, ke0=0.392, ke_end=0.18, me0=0.125, me_end=0.313,
             dev_max=1.03),
    ("conservative", "128x128_two_Gaussians_low_B"):
        dict(stop=60.0, ke_end=0.0035, me0=0.0218, me_end=0.0216,
             dev_max=0.35),
    ("conservative", "128x128_two_Gaussians_high_B"):
        dict(stop=35.0, ke_end=0.135, me0=0.545, me_end=0.537, dev_max=22.0),
    ("conservative", "128x128_low_B_low_U"):
        dict(stop=15.0, ke0=0.393, ke_end=0.155, me0=0.125, me_end=0.355,
             dev_max=0.39),
}

# Acceptance: exact anchors (initial energies are pure functions of the
# pinned ICs) tight; end-state anchors loose (different WENO details and
# rounding legitimately shift trajectories); the deviation envelope —
# the reference's own conservation gate — within 3x the recorded peak.
TOL = dict(ic_rel=0.03, end_rel=0.30, dev_factor=3.0)


def summarize(csv):
    from swmhd_tpu.io.readers import ScalarTimeSeries
    ts = ScalarTimeSeries(csv)
    dev = np.abs(ts.total_energy - ts.total_energy[0]) * 100.0
    return dict(ke0=float(ts.kinetic_energy[0]),
                ke_end=float(ts.kinetic_energy[-1]),
                me0=float(ts.magnetic_energy[0]),
                me_end=float(ts.magnetic_energy[-1]),
                pe_dev_end=float(ts.potential_energy[-1]),
                dev_max=float(dev.max()))


def judge(ref, got, tol=None):
    tol = tol or TOL
    checks = {}
    checks["me0"] = abs(got["me0"] - ref["me0"]) <= tol["ic_rel"] * ref["me0"]
    if "ke0" in ref:
        checks["ke0"] = (abs(got["ke0"] - ref["ke0"])
                         <= tol["ic_rel"] * ref["ke0"])
    else:
        checks["ke0"] = got["ke0"] <= tol.get("ke0_abs", 1e-12)
    for k in ("ke_end", "me_end"):
        checks[k] = (abs(got[k] - ref[k]) <= tol["end_rel"] * ref[k])
    checks["dev_max"] = got["dev_max"] <= tol["dev_factor"] * ref["dev_max"]
    return checks
