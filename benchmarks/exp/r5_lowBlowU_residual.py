"""r5: attribute (or close) the residual 64^2 low_B_low_U envelope gap
ours 1.84 (jac) / 2.32 (cons) vs recorded 0.78/1.03.

r3 took this case from 6.0 to 1.84 (WENO-Z weights + reference-style
functionals, VALIDATION.md "root cause" section) and exonerated walls
and dt — but those exonerations were measured with the OLD interpolated
functionals, which masked the r3 fix itself. This experiment re-tests
the remaining discretization candidates, all measured with the
reference-convention functionals (diagnostics.reference_energy_report):

  base       current production discretization
  rampbeta   tracer y-WENO betas computed on the FULL field A = -0.05y+A'
             (shift offsets + gamma*n*dy) — algebraically identical to
             advecting the full field with gradient-BC ghosts, which is
             what the reference does (SWMHD_example.jl:19,36)
  nodegrade  near-wall WENO degradation removed for the y direction
             (full 5-pt stencils on clamped ghosts instead of the forced
             3rd/1st-order one-sided fallback)
  both       rampbeta + nodegrade

Output: dev_max / KE_end / ME_end per variant per formulation vs the
recorded anchors.
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', '..'))
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np

from swmhd_tpu import scenarios, diagnostics
from swmhd_tpu.models import shallow_water as sw
from swmhd_tpu import advection as adv
from swmhd_tpu import operators as op

RECORDED = {"vector_invariant": dict(dev=0.78, ke=0.18, me=0.313),
            "conservative": dict(dev=1.03, ke=0.18, me=0.313)}


def patch_rampbeta(model, zero_step=False):
    gamma = model.A_background_gradient_y
    if zero_step:          # control: must reproduce 'base' if the
        gamma = 0.0        # hand-rolled reconstruction path is faithful
    orig = sw.ShallowWaterModel._tracer_tendency

    def patched(self, A, h, Uf, Vf, divU):
        ts = self.tracer_advection
        gr = self.grid
        fx = adv.upwind_biased_product(
            Uf, *ts.both_x_f(A, gr))
        shy = lambda a, n: op.shift_y(a, n, gr)
        step = gamma * gr.dy
        if step:
            shy_ramp = lambda a, n: op.shift_y(a, n, gr) + n * step
        else:
            shy_ramp = shy
        bg = self.A_background_gradient_y
        pl = adv.weno_candidates_left(A, shy)
        pr = adv.weno_candidates_right(A, shy)
        bl = adv.weno_betas_left(A, shy_ramp)
        br = adv.weno_betas_right(A, shy_ramp)
        Al = adv._weno_combine(pl, bl)
        Ar = adv._weno_combine(pr, br)
        Al = adv._degrade_weno_y_f(Al, A, gr, left=True)
        Ar = adv._degrade_weno_y_f(Ar, A, gr, left=False)
        fy = adv.upwind_biased_product(Vf, Al, Ar)
        div_flux = op.ddx_c_flux(fx, gr) + op.ddy_c_flux(fy, gr)
        GA = (A * divU - div_flux) / h
        if bg:
            GA = GA - bg * op.iy_c(Vf, gr) / h
        return GA
    sw.ShallowWaterModel._tracer_tendency = patched
    return lambda: setattr(sw.ShallowWaterModel, "_tracer_tendency", orig)


def patch_nodegrade():
    orig = adv._degrade_weno_y_f
    adv._degrade_weno_y_f = lambda r5, c, grid, left: r5
    return lambda: setattr(adv, "_degrade_weno_y_f", orig)


def run(formulation, variant, stop=15.0, N=64):
    model, state, sc = scenarios.build(f"{N}x{N}_low_B_low_U", formulation,
                                       dtype=jnp.float64)
    unpatch = []
    if variant in ("rampbeta", "both"):
        unpatch.append(patch_rampbeta(model))
    if variant == "rampbeta0":
        unpatch.append(patch_rampbeta(model, zero_step=True))
    if variant in ("nodegrade", "both"):
        unpatch.append(patch_nodegrade())
    try:
        h0 = state.h
        dt = sc.dt
        nsteps = int(round(stop / dt))

        def diag(st):
            return diagnostics.reference_energy_report(model, st, h0)

        stepper = jax.jit(model.step_fn(dt, nsteps, diagnostics=diag))
        t0 = time.time()
        _, series = stepper(state)
        te = np.asarray(series["total_energy"])
        rep0 = jax.jit(diag)(state)
        E0 = float(rep0["total_energy"])
        dev = np.abs(te - E0) * 100
        ke_end = float(np.asarray(series["kinetic_energy"])[-1])
        me_end = float(np.asarray(series["magnetic_energy"])[-1])
        rec = RECORDED[formulation]
        print(f"{formulation:17s} {variant:10s} dev_max={dev.max():6.3f} "
              f"(rec {rec['dev']:.2f}, x{dev.max()/rec['dev']:.2f}) "
              f"KE_end={ke_end:.4f} ME_end={me_end:.4f} "
              f"({time.time()-t0:.0f}s)", flush=True)
        return float(dev.max())
    finally:
        for u in unpatch:
            u()


if __name__ == "__main__":
    variants = sys.argv[1:] or ["base", "rampbeta0", "rampbeta",
                                "nodegrade", "both"]
    for f in ("vector_invariant", "conservative"):
        for v in variants:
            run(f, v)
