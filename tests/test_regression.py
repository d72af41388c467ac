"""Trajectory regression fixtures (SURVEY §4f).

Freezes the prognostic fields of a short canonical run; any future change
to operators, advection, forcing, or stepping that alters trajectories
beyond roundoff fails here. Regenerate deliberately with:

    python -m tests.test_regression   # rewrites tests/fixtures/*.npz
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")

# 1000 RK3 steps = the BASELINE.json "fields allclose after 1000 steps"
# gate length (SURVEY §6), on the pinned high_B scenario (rest start +
# strong Gaussian dipole, scenarios.py) — strong Lorentz-driven dynamics
# exercise every term.
CASES = {
    "jacobian_64": dict(name="64x64_two_Gaussians_high_B",
                        formulation="vector_invariant", steps=1000, dt=0.01),
    "divergence_64": dict(name="64x64_two_Gaussians_high_B",
                          formulation="conservative", steps=1000, dt=0.01),
}


def _run(case, dtype=jnp.float64):
    from swmhd_tpu import scenarios
    model, state, _ = scenarios.build(case["name"], case["formulation"],
                                      dtype=dtype)
    out = jax.jit(model.step_fn(case["dt"], case["steps"]))(state)
    return {k: np.asarray(getattr(out, k)) for k in ("h", "u", "v", "A")}


@pytest.mark.parametrize("key", sorted(CASES))
def test_trajectory_regression(key):
    path = os.path.join(FIXTURE_DIR, f"{key}.npz")
    if not os.path.exists(path):
        pytest.skip(f"fixture {path} missing — regenerate via "
                    f"python -m tests.test_regression")
    want = np.load(path)
    got = _run(CASES[key])
    for name in ("h", "u", "v", "A"):
        np.testing.assert_allclose(
            got[name], want[name], rtol=1e-12, atol=1e-13,
            err_msg=f"{key}:{name} trajectory drifted")


# f32-vs-f64 drift over the same 1000 steps, measured on CPU (SURVEY §7.3
# hard-part #6): the calibrated bound below is ~3x the observed max drift,
# so an f32 run on the GPU can be judged against the f64 fixtures. Regenerated
# alongside the fixtures (see regenerate()).
F32_TOL_FILE = os.path.join(FIXTURE_DIR, "f32_tolerance.npz")


@pytest.mark.parametrize("key", sorted(CASES))
def test_f32_tolerance(key):
    path = os.path.join(FIXTURE_DIR, f"{key}.npz")
    if not (os.path.exists(path) and os.path.exists(F32_TOL_FILE)):
        pytest.skip("fixtures missing — regenerate via "
                    "python -m tests.test_regression")
    want = np.load(path)
    tol = np.load(F32_TOL_FILE)
    got = _run(CASES[key], dtype=jnp.float32)
    for name in ("h", "u", "v", "A"):
        drift = np.max(np.abs(got[name] - want[name]))
        bound = float(tol[f"{key}:{name}"])
        assert drift <= bound, (
            f"{key}:{name} f32 drift {drift:.3e} exceeds calibrated "
            f"bound {bound:.3e}")


def regenerate():
    # must match the test environment: CPU backend, float64
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    os.makedirs(FIXTURE_DIR, exist_ok=True)
    tolerances = {}
    for key, case in CASES.items():
        fields = _run(case)
        np.savez_compressed(os.path.join(FIXTURE_DIR, f"{key}.npz"),
                            **fields)
        print("wrote", key, {k: v.shape for k, v in fields.items()})
        f32 = _run(case, dtype=jnp.float32)
        for name in ("h", "u", "v", "A"):
            drift = float(np.max(np.abs(f32[name] - fields[name])))
            tolerances[f"{key}:{name}"] = 3.0 * max(drift, 1e-7)
            print(f"  f32 drift {name}: {drift:.3e} "
                  f"(bound {tolerances[f'{key}:{name}']:.3e})")
    np.savez(F32_TOL_FILE, **tolerances)
    print("wrote f32 tolerance table")


if __name__ == "__main__":
    regenerate()
