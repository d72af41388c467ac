"""VelocityStencil fidelity pin (SURVEY §7.3 hard-part #1).

The vector-invariant WENO vorticity flux is the scheme Oceananigans names
``WENO5(vector_invariant = VelocityStencil())`` (reference:
jacobian_formulation/SWMHD_example.jl:24), i.e. the upwinded
vector-invariant WENO of Silvestri & Wagner: biased WENO-Z reconstruction
of the vorticity transverse to each momentum component, upwind branch
selected by the sign of the 4-pt-interpolated transverse velocity, and
nonlinear weights computed from the smoothness of the VELOCITY components
interpolated to the vorticity staggering, averaged:
β_k = (β_k(ū) + β_k(v̄))/2.

Two pins:

1. an INDEPENDENT per-point (i,j)-loop implementation of the scheme,
   written directly from the stencil tables (Julia-style per-point
   composition, numpy loops) — any one-cell staggering slip or candidate/
   beta misalignment in the whole-array code fails the comparison;
2. a weight-behavior discriminator: a vorticity step under a smooth
   velocity field must reconstruct with (near-)optimal linear weights
   under VelocityStencil (the scheme's whole point: don't let the noisy
   ζ drive the weights) while VorticityStencil collapses to the smooth
   substencil — the two must differ decisively.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from swmhd_tpu.grid import Grid
from swmhd_tpu.models.shallow_water import (
    ShallowWaterModel, VECTOR_INVARIANT, VELOCITY_STENCIL,
    VORTICITY_STENCIL)
from swmhd_tpu import advection as adv

EPS = 1e-8  # the Oceananigans-era regularizer (swmhd_tpu.advection._WENO_EPS)
G = (0.1, 0.6, 0.3)


# -- independent per-point reference implementation -------------------------

def betas_left(s):
    """Jiang-Shu smoothness of the left-biased substencils; s[0..4] are the
    five values centered so the reconstruction face sits between s[2], s[3]
    (i.e. s = c[i-3..i+1] for face i)."""
    cm3, cm2, cm1, c0, cp1 = s
    b0 = 13/12*(cm3 - 2*cm2 + cm1)**2 + 0.25*(cm3 - 4*cm2 + 3*cm1)**2
    b1 = 13/12*(cm2 - 2*cm1 + c0)**2 + 0.25*(cm2 - c0)**2
    b2 = 13/12*(cm1 - 2*c0 + cp1)**2 + 0.25*(3*cm1 - 4*c0 + cp1)**2
    return np.array([b0, b1, b2])


def betas_right(s):
    """s = c[i-2..i+2] for face i."""
    cm2, cm1, c0, cp1, cp2 = s
    b0 = 13/12*(cp2 - 2*cp1 + c0)**2 + 0.25*(cp2 - 4*cp1 + 3*c0)**2
    b1 = 13/12*(cp1 - 2*c0 + cm1)**2 + 0.25*(cp1 - cm1)**2
    b2 = 13/12*(c0 - 2*cm1 + cm2)**2 + 0.25*(3*c0 - 4*cm1 + cm2)**2
    return np.array([b0, b1, b2])


def cands_left(s):
    cm3, cm2, cm1, c0, cp1 = s
    return np.array([(2*cm3 - 7*cm2 + 11*cm1)/6,
                     (-cm2 + 5*cm1 + 2*c0)/6,
                     (2*cm1 + 5*c0 - cp1)/6])


def cands_right(s):
    cm2, cm1, c0, cp1, cp2 = s
    return np.array([(2*cp2 - 7*cp1 + 11*c0)/6,
                     (-cp1 + 5*c0 + 2*cm1)/6,
                     (2*c0 + 5*cm1 - cm2)/6])


def zcombine(p, b):
    tau = abs(b[0] - b[2])
    a = np.array(G) * (1.0 + (tau / (b + EPS))**2)
    return float(np.dot(a, p) / a.sum())


def naive_vort_u(u, v, zeta, N, stencil):
    """vort_u[i,j] = v̂ᶠᶜ · ζ̃ per point; periodic wrap; 0-based indexing
    with face i = left edge of cell i (operators.py convention)."""
    out = np.zeros((N, N))
    w = lambda k: k % N
    for i in range(N):
        for j in range(N):
            v_hat = 0.25 * (v[i, j] + v[w(i-1), j]
                            + v[i, w(j+1)] + v[w(i-1), w(j+1)])
            # center-form y-reconstruction at j == face-form at j+1:
            # left stencil reads ζ[i, j-2..j+2], right ζ[i, j-1..j+3]
            zl_s = np.array([zeta[i, w(j+1+k)] for k in range(-3, 2)])
            zr_s = np.array([zeta[i, w(j+1+k)] for k in range(-2, 3)])
            if stencil == "velocity":
                us = lambda k: 0.5*(u[i, w(j+1+k)] + u[i, w(j+k)])
                vs = lambda k: 0.5*(v[i, w(j+1+k)] + v[w(i-1), w(j+1+k)])
                ul_s = np.array([us(k) for k in range(-3, 2)])
                ur_s = np.array([us(k) for k in range(-2, 3)])
                vl_s = np.array([vs(k) for k in range(-3, 2)])
                vr_s = np.array([vs(k) for k in range(-2, 3)])
                bl = 0.5 * (betas_left(ul_s) + betas_left(vl_s))
                br = 0.5 * (betas_right(ur_s) + betas_right(vr_s))
            else:
                bl = betas_left(zl_s)
                br = betas_right(zr_s)
            zl = zcombine(cands_left(zl_s), bl)
            zr = zcombine(cands_right(zr_s), br)
            out[i, j] = 0.5 * ((v_hat + abs(v_hat)) * zl
                               + (v_hat - abs(v_hat)) * zr)
    return out


def _fields(N=16, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(N, N))
    v = rng.normal(size=(N, N))
    zeta = rng.normal(size=(N, N))
    return u, v, zeta


@pytest.mark.parametrize("stencil", [VELOCITY_STENCIL, VORTICITY_STENCIL])
def test_vorticity_flux_matches_per_point_spec(stencil):
    N = 16
    u, v, zeta = _fields(N)
    g = Grid.regular(N, N, (0, 1), (0, 1), dtype=jnp.float64)
    model = ShallowWaterModel(grid=g, formulation=VECTOR_INVARIANT,
                              vector_invariant_stencil=stencil)
    got_u, got_v = model._weno_vorticity_flux(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(zeta), g)
    want_u = naive_vort_u(u, v, zeta, N,
                          "velocity" if stencil == VELOCITY_STENCIL
                          else "vorticity")
    np.testing.assert_allclose(np.asarray(got_u), want_u,
                               rtol=1e-12, atol=1e-13)
    # the v-equation flux is the same scheme with x<->y and u<->v swapped
    # and an overall minus sign: under transposition of all fields,
    # vort_v(u, v, ζ) = -[vort_u(v.T, u.T, ζ.T)].T (betas are symmetric
    # in (u, v); staggering ops transpose x<->y cleanly).
    got_u2, _ = model._weno_vorticity_flux(
        jnp.asarray(v.T.copy()), jnp.asarray(u.T.copy()),
        jnp.asarray(zeta.T.copy()), g)
    want_v = -np.asarray(got_u2).T
    np.testing.assert_allclose(np.asarray(got_v), want_v,
                               rtol=1e-12, atol=1e-13)


def test_velocity_stencil_ignores_vorticity_roughness():
    """A ζ step under smooth velocities: VelocityStencil must stay at the
    optimal linear weights (reconstruction == linear 5th-order value);
    VorticityStencil must deviate decisively (one-sided collapse)."""
    N = 32
    g = Grid.regular(N, N, (0, 1), (0, 1), dtype=jnp.float64)
    j = np.arange(N)
    zeta = np.where((j[None, :] >= N // 2), 1.0, 0.0) * np.ones((N, N))
    u = np.ones((N, N)) * 0.3          # smooth -> equal betas
    v = np.ones((N, N)) * 0.7          # positive -> left/upwind branch
    model_v = ShallowWaterModel(grid=g, formulation=VECTOR_INVARIANT,
                                vector_invariant_stencil=VELOCITY_STENCIL)
    model_z = ShallowWaterModel(grid=g, formulation=VECTOR_INVARIANT,
                                vector_invariant_stencil=VORTICITY_STENCIL)
    fu_v, _ = model_v._weno_vorticity_flux(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(zeta), g)
    fu_z, _ = model_z._weno_vorticity_flux(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(zeta), g)
    # linear 5th-order left value at the face just below the step
    # (center-form at j = N//2 - 1 reads faces N//2-3..N//2+1 =
    # [0,0,0,1,1] -> p = [(2*0-7*0+11*0)/6, (0+0+2*1)/6, (0+5*1-1)/6]
    # hmm: stencil s = zeta[j-2..j+2] = [0,0,0,1,1]? With face k = cell
    # k's lower edge and the step at j=N//2: evaluate where the linear
    # combination is computable: d = 0.1*p0+0.6*p1+0.3*p2.
    s = np.array([0.0, 0.0, 0.0, 1.0, 1.0])
    linear5 = float(np.dot(G, cands_left(s)))
    jj = N // 2 - 1
    got = float(np.asarray(fu_v)[0, jj]) / 0.7
    assert abs(got - linear5) < 1e-9, (got, linear5)
    got_z = float(np.asarray(fu_z)[0, jj]) / 0.7
    assert abs(got_z - linear5) > 50 * abs(got - linear5) + 1e-3
