"""Advection-scheme accuracy and conservation properties.

The reference never unit-tests WENO (it inherits it from Oceananigans);
these tests pin the schemes the framework re-implements: reconstruction
convergence order on smooth fields, non-oscillatory behavior on
discontinuities, and the discrete conservation the flux forms guarantee.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from swmhd_tpu import Grid, ShallowWaterModel, FPlane, VECTOR_INVARIANT
from swmhd_tpu.advection import (
    weno5_left_x_f, weno5_right_x_f, left3_x_f, Centered2, WENO5)
from conftest import convergence_order


class TestReconstructionOrder:
    @staticmethod
    def _cell_averages(g):
        """Exact cell averages of sin(2πx): the reconstructions are
        finite-volume formulas (cell average → interface value); feeding
        point values instead floors the error at O(h²)."""
        k = 2 * jnp.pi
        xl = g.xf()
        xr = xl + g.dx
        avg = (jnp.cos(k * xl) - jnp.cos(k * xr)) / (k * g.dx)
        return avg[:, None] * jnp.ones((1, 4))

    def test_weno5_smooth_order5(self):
        """On a smooth field the WENO5 weights approach the optimal linear
        ones and the reconstruction converges at 5th order."""
        errs, ns = [], [32, 64, 128, 256]
        for N in ns:
            g = Grid.regular(N, 4, (0.0, 1.0), (0.0, 1.0),
                             dtype=jnp.float64)
            c = self._cell_averages(g)
            want = jnp.sin(2 * jnp.pi * g.xf())[:, None]
            got = weno5_left_x_f(c, g)
            errs.append(float(jnp.max(jnp.abs(got - want))))
        order = convergence_order(ns, errs)
        assert order > 4.5, (order, errs)

    def test_upwind3_smooth_order3(self):
        errs, ns = [], [32, 64, 128, 256]
        for N in ns:
            g = Grid.regular(N, 4, (0.0, 1.0), (0.0, 1.0),
                             dtype=jnp.float64)
            c = self._cell_averages(g)
            want = jnp.sin(2 * jnp.pi * g.xf())[:, None]
            errs.append(float(jnp.max(jnp.abs(left3_x_f(c, g) - want))))
        order = convergence_order(ns, errs)
        assert order > 2.7, (order, errs)

    def test_weno5_step_no_overshoot(self):
        """Essentially-non-oscillatory: reconstructing a step must not
        overshoot the data range by more than a tiny margin."""
        N = 64
        g = Grid.regular(N, 4, (0.0, 1.0), (0.0, 1.0), dtype=jnp.float64)
        c = jnp.where(jnp.arange(N) < N // 2, 1.0, 0.0)[:, None] \
            * jnp.ones((1, 4))
        for recon in (weno5_left_x_f, weno5_right_x_f):
            r = recon(c, g)
            assert float(jnp.max(r)) < 1.0 + 1e-6
            assert float(jnp.min(r)) > -1e-6


class TestWenoZLiterature:
    """Anchor-independent pins of the WENO-Z flavor:
    the r3 eps/Z calibration was validated against plot-transcribed
    anchors only; these assert the *published* WENO-Z behaviors (Borges,
    Carmona, Costa & Don 2008, JCP 227:3191; Henrick, Aslam & Powers
    2005, JCP 207:542) directly, de-risking residual overfitting."""

    @staticmethod
    def _critical_point_errors(use_z):
        """Reconstruction error at x=0 for c(x)=sin(2πx)³ — a second-
        order critical point (c'=c''=0, c'''≠0), the classic case where
        WENO-JS degrades to ~3rd order while WENO-Z retains ~5th."""
        import swmhd_tpu.advection as adv
        from swmhd_tpu.advection import weno5_left_x_f
        old = adv._WENO_Z
        adv._WENO_Z = use_z
        try:
            errs, ns = [], [64, 128, 256, 512]
            for N in ns:
                g = Grid.regular(N, 4, (0.0, 1.0), (0.0, 1.0),
                                 dtype=jnp.float64)
                k = 2 * jnp.pi
                xl = g.xf()
                xr = xl + g.dx
                F = lambda x: (jnp.cos(k * x) ** 3 / 3
                               - jnp.cos(k * x)) / k  # primitive of sin³
                c = ((F(xr) - F(xl)) / g.dx)[:, None] * jnp.ones((1, 4))
                got = weno5_left_x_f(c, g)
                want = (jnp.sin(k * g.xf()) ** 3)[:, None]
                errs.append(float(jnp.abs(got[0, 0] - want[0, 0])))
            return ns, errs
        finally:
            adv._WENO_Z = old

    def test_z_retains_order5_at_critical_point_js_degrades(self):
        ns, errs_z = self._critical_point_errors(True)
        _, errs_js = self._critical_point_errors(False)
        order_z = convergence_order(ns, errs_z)
        order_js = convergence_order(ns, errs_js)
        # published behavior: Z ~5th order at critical points, JS ~3rd
        assert order_z > 4.5, (order_z, errs_z)
        assert order_js < 4.2, (order_js, errs_js)
        # and at the finest grid Z is decisively more accurate
        assert errs_z[-1] * 10 < errs_js[-1], (errs_z[-1], errs_js[-1])

    def test_eps_1em8_keeps_weights_nonlinear_at_128sq_betas(self):
        """Unit-level pin of the r3 root cause: at the 128² smooth-field
        beta scale (~1e-6), eps=1e-6 linearizes the nonlinear weights
        (pulling them to the optimal gammas) while the production
        eps=1e-8 preserves the near-eps-free weights."""
        import swmhd_tpu.advection as adv
        betas = (2e-6, 5e-7, 1e-6)
        ps = (1.0, 0.0, 0.0)  # recovered value == weight w0

        def w0(eps):
            old = adv._WENO_EPS
            adv._WENO_EPS = eps
            try:
                b = tuple(jnp.asarray(x, jnp.float64) for x in betas)
                p = tuple(jnp.asarray(x, jnp.float64) for x in ps)
                return float(adv._weno_combine(p, b))
            finally:
                adv._WENO_EPS = old

        exact = w0(1e-14)          # effectively eps-free weights
        good = w0(1e-8)            # production
        bad = w0(1e-6)             # the r3-regression value
        gamma0 = 0.1               # linearized limit
        assert abs(good - exact) < 0.05 * abs(exact), (good, exact)
        assert abs(bad - exact) > 0.25 * abs(exact), (bad, exact)
        assert abs(bad - gamma0) < abs(good - gamma0)


class TestF32Weights:
    """f32 production must keep the eps=1e-8 WENO-Z
    weight semantics that r3 root-caused as decisive at >=128^2, where
    smooth-field betas are O(1e-6) and an eps floor of 1e-6 linearizes
    the nonlinear weights. The non-f64 path rescales (betas, eps) by the
    beta sum — an exact-arithmetic no-op for the degree-0-homogeneous
    weight formulas — so every intermediate stays in the f32 normal
    range at eps=1e-8."""

    @staticmethod
    def _combine(betas, dtype):
        from swmhd_tpu.advection import _weno_combine
        ps = tuple(jnp.asarray(p, dtype) for p in (1.0, 2.0, 3.0))
        b = tuple(jnp.asarray(x, dtype) for x in betas)
        return float(_weno_combine(ps, b))

    def test_f32_matches_f64_in_128sq_beta_regime(self):
        """Betas at the 128² smooth-field scale (~(dx² f″)² ~ 1e-6) —
        exactly where the old 1e-6 eps floor made f32 weights disagree
        with the validated f64 weights at O(10%)."""
        for betas in [(2e-6, 5e-7, 1e-6), (1e-6, 1e-8, 3e-7),
                      (0.0, 4e-6, 2e-6), (1e-7, 1e-7, 5e-8)]:
            ref = self._combine(betas, jnp.float64)
            got = self._combine(betas, jnp.float32)
            assert abs(got - ref) / abs(ref) < 1e-4, (betas, got, ref)

    def test_f32_constant_field_no_nan(self):
        """All-zero betas (constant field): the normalized rational form
        must produce the optimal linear weights, not 0/0 = NaN."""
        got = self._combine((0.0, 0.0, 0.0), jnp.float32)
        assert got == pytest.approx(0.1 * 1.0 + 0.6 * 2.0 + 0.3 * 3.0,
                                    rel=1e-6)

    def test_f32_tiny_mixed_betas_finite(self):
        for betas in [(0.0, 1e-10, 1e-9), (1e-12, 0.0, 0.0),
                      (1e-30, 1e-30, 1e-30)]:
            got = self._combine(betas, jnp.float32)
            assert np.isfinite(got), (betas, got)

    def test_f32_reconstruction_tracks_f64(self):
        """Whole-array check at N=128: the f32 WENO5 reconstruction of a
        smooth field stays within f32-roundoff-amplified distance of the
        f64 one (the old floor produced O(1e-3) absolute deviations from
        the different weight regime)."""
        N = 128
        errs = {}
        for dtype in (jnp.float64, jnp.float32):
            g = Grid.regular(N, 4, (0.0, 1.0), (0.0, 1.0), dtype=dtype)
            c = jnp.asarray(
                TestReconstructionOrder._cell_averages(g), dtype)
            errs[dtype] = np.asarray(weno5_left_x_f(c, g), np.float64)
        diff = np.max(np.abs(errs[jnp.float32] - errs[jnp.float64]))
        assert diff < 2e-5, diff


class TestConservation:
    """The flux-form tendencies conserve mass and tracer content to
    roundoff — a property the reference relies on but never asserts."""

    @pytest.mark.parametrize("scheme", [Centered2, WENO5])
    def test_mass_and_tracer_content_conserved(self, scheme):
        N = 64
        g = Grid.regular(N, N, (-5, 5), (-5, 5), dtype=jnp.float64)
        model = ShallowWaterModel(
            grid=g, formulation=VECTOR_INVARIANT, coriolis=FPlane(1.0),
            momentum_advection=scheme, mass_advection=scheme,
            tracer_advection=scheme)
        state = model.initial_state(
            u=lambda x, y: jnp.sin(2 * jnp.pi * x / 10) * 0.3,
            v=lambda x, y: jnp.cos(2 * jnp.pi * y / 10) * 0.3,
            h=lambda x, y: 1.0 + 0.1 * jnp.cos(2 * jnp.pi * x / 10),
            A=lambda x, y: jnp.exp(-(x**2 + y**2)))
        mass0 = float(jnp.sum(state.h))
        content0 = float(jnp.sum(state.h * state.A))
        out = jax.jit(model.step_fn(1e-3, 50))(state)
        mass1 = float(jnp.sum(out.h))
        content1 = float(jnp.sum(out.h * out.A))
        # mass flux form is exactly conservative
        assert abs(mass1 - mass0) / abs(mass0) < 1e-12
        # hA is conserved semi-discretely; RK3 staging reintroduces an
        # O(dt^2)/step cross term — assert it stays at that scale
        assert abs(content1 - content0) / abs(content0) < 1e-6
