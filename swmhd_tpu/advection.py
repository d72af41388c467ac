"""Advection schemes: centered, 3rd-order upwind-biased, and WENO5.

Array-form re-design of the advection subset the reference uses:

  - ``WENO5()`` for momentum/mass/tracer advection
    (reference: jacobian_formulation/SWMHD_example.jl:24-26,
    divergence_formulation/divergence_sw_mhd.jl:22-24)
  - ``WENO5(vector_invariant = VelocityStencil())``
    (reference: jacobian_formulation/SWMHD_example.jl:24) — handled in
    models/shallow_water.py via the biased reconstructions here
  - the hand-rolled blended 1st/3rd-order upwind scheme of the
    divergence-form Lorentz flux (reference:
    divergence_formulation/sw_mhd_divergence_functions.jl:3-35)

Every reconstruction is a whole-array function. A reconstruction "at faces"
produces, at index i, the interface value at x-face i (left edge of cell i)
from center values; a reconstruction "at centers" produces the value at
center i from face values (which is the same stencil shifted by one, exactly
as the reference defines ``*_interpolate_xᶜᵃᵃ(i,...) = *_interpolate_xᶠᵃᵃ
(i+1,...)``, sw_mhd_divergence_functions.jl:27-35).

Bounded topology: within two cells of a Bounded wall the 3rd-order and WENO
reconstructions degrade exactly as the reference's explicit branches do
(sw_mhd_divergence_functions.jl:42-57,66-81,90-105,114-129): one-sided
first-order at the outermost point, opposite-side bias dropped one cell in.
This is applied as a mask over the whole array — no data-dependent control
flow, XLA-friendly.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from .grid import Grid, BOUNDED
from . import operators as op


# -- the upwind selector -------------------------------------------------------

def upwind_biased_product(u_t, pl_, pr):
    """((ũ+|ũ|)ψᴸ + (ũ−|ũ|)ψᴿ)/2 — pick the upwind reconstruction.

    Reference: sw_mhd_divergence_functions.jl:3."""
    return 0.5 * ((u_t + abs(u_t)) * pl_ + (u_t - abs(u_t)) * pr)


# -- index masks for bounded-wall degradation -----------------------------------
#
# Global-index aware (operators.IndexContext) so the same masks are exact
# inside a shard_map-ped padded tile: comparisons run against the global
# domain size and each row's global index, not the local tile's.

def _index_x(a):
    return op.global_index_x(a)


def _index_y(a):
    return op.global_index_y(a)


# =================================================================================
# First-order (donor-cell) reconstructions
# =================================================================================

def left1_x_f(c, grid):   # value at face i, left-biased 1st order = c[i-1]
    return op.shift_x(c, -1, grid)


def right1_x_f(c, grid):  # = c[i]
    return c


def left1_y_f(c, grid):
    return op.shift_y(c, -1, grid)


def right1_y_f(c, grid):
    return c


def left1_x_c(u, grid):   # at center i from faces = u[i] (face i is left edge)
    return u


def right1_x_c(u, grid):  # = u[i+1]
    return op.shift_x(u, 1, grid)


def left1_y_c(v, grid):
    return v


def right1_y_c(v, grid):
    return op.shift_y(v, 1, grid)


# =================================================================================
# Third-order biased reconstructions
# (reference: sw_mhd_divergence_functions.jl:24-35)
# =================================================================================

def _left3(c, sh):
    # (2 c[i] + 5 c[i-1] - c[i-2]) / 6 at face i  (sh(n) = shift by n)
    return (2.0 * c + 5.0 * sh(c, -1) - sh(c, -2)) / 6.0


def _right3(c, sh):
    # (-c[i+1] + 5 c[i] + 2 c[i-1]) / 6 at face i
    return (-sh(c, 1) + 5.0 * c + 2.0 * sh(c, -1)) / 6.0


def left3_x_f(c, grid):
    sh = lambda a, n: op.shift_x(a, n, grid)
    r = _left3(c, sh)
    return _degrade_x_f(r, c, grid, left=True)


def right3_x_f(c, grid):
    sh = lambda a, n: op.shift_x(a, n, grid)
    r = _right3(c, sh)
    return _degrade_x_f(r, c, grid, left=False)


def left3_y_f(c, grid):
    sh = lambda a, n: op.shift_y(a, n, grid)
    r = _left3(c, sh)
    return _degrade_y_f(r, c, grid, left=True)


def right3_y_f(c, grid):
    sh = lambda a, n: op.shift_y(a, n, grid)
    r = _right3(c, sh)
    return _degrade_y_f(r, c, grid, left=False)


def left3_x_c(u, grid):
    # left-biased at center i = face-form at i+1: (2u[i+1] + 5u[i] - u[i-1])/6
    return op.shift_x(left3_x_f(u, grid), 1, grid)


def right3_x_c(u, grid):
    return op.shift_x(right3_x_f(u, grid), 1, grid)


def left3_y_c(v, grid):
    return op.shift_y(left3_y_f(v, grid), 1, grid)


def right3_y_c(v, grid):
    return op.shift_y(right3_y_f(v, grid), 1, grid)


def _degrade_x_f(r3, c, grid, left):
    """Near-wall degradation for Bounded x, mirroring the reference branches
    (sw_mhd_divergence_functions.jl:42-57): faces 0..1 and Nx-1.. use
    one-sided / first-order values."""
    if grid.topology_x != BOUNDED:
        return r3
    i = _index_x(c)
    N = op.global_nx(grid)
    first = jnp.where(left, op.shift_x(c, -1, grid), c)  # 1st-order fallback
    # Outermost two faces on each side degrade.
    if left:
        r = jnp.where(i < 2, first, r3)
        r = jnp.where(i > N - 1, first, r)  # (wrap guard; face N-1 keeps 3rd)
    else:
        r = jnp.where(i < 1, first, r3)
        r = jnp.where(i > N - 2, first, r)
    return r


def _degrade_y_f(r3, c, grid, left):
    if grid.topology_y != BOUNDED:
        return r3
    j = _index_y(c)
    N = op.global_ny(grid)
    first = jnp.where(left, op.shift_y(c, -1, grid), c)
    if left:
        r = jnp.where(j < 2, first, r3)
        r = jnp.where(j > N - 1, first, r)
    else:
        r = jnp.where(j < 1, first, r3)
        r = jnp.where(j > N - 2, first, r)
    return r


# =================================================================================
# WENO5 biased reconstructions (Jiang & Shu 1996 weights, as in the
# Oceananigans WENO5 the reference selects at SWMHD_example.jl:24-26)
# =================================================================================

# Smoothness-indicator regularizer. The reference's Oceananigans WENO
# vintage uses eps = 1e-8; the value is DECISIVE at 128^2, where smooth-
# field betas are O((dx^2 f'')^2) ~ 1e-6: with eps = 1e-6 the nonlinear
# weights linearize, the scheme loses the upwind dissipation that balances
# the discrete Lorentz-work/induction mismatch, and total energy GAINS
# ~0.035 (dev x100 units) by t=30 vs the reference's recorded ~0.01 at
# t=60 (r3 root cause; benchmarks/exp/r3_eps_sweep.py — eps 1e-8 lands
# every 128^2 anchor: cons KE_end 0.00348 vs recorded 0.0035).
_WENO_EPS = float(os.environ.get("SWMHD_WENO_EPS", "1e-8"))
_GAMMA = (0.1, 0.6, 0.3)

# f32 handling: the divide-free rational weights
# multiply three (beta+eps)^2 factors, so their smallest term is O(eps^6)
# = 1e-48 at eps=1e-8 — below the f32 subnormal range (0/0 = NaN on
# constant fields). Instead of flooring eps at 1e-6 (which r3 root-caused
# as linearizing the nonlinear weights at >=128^2 and producing
# unphysical energy growth — benchmarks/exp/r3_eps_sweep.py), non-f64
# evaluation first rescales (betas, eps) by the power of two nearest
# 1/(b0+b1+b2+eps) (read off the sum's exponent bits — no divide, and
# the scaling is exact in floating point). The weights are a degree-0
# homogeneous rational function of (beta_k+eps), so the rescaling changes
# nothing in exact arithmetic, while every intermediate lands in
# [~(eps')^2, O(1)] — safely inside the f32 normal range. f32 therefore
# keeps the production eps=1e-8 semantics of the validated f64 path
# (tests/test_advection.py::TestF32Weights pins f32==f64 weights in the
# 128^2 beta regime where the old floor diverged).


def _eps_for(b):
    del b
    return _WENO_EPS


def _is_f64(b):
    return b.dtype == jnp.float64


def _normalize_betas(b, eps):
    """Rescale (b0,b1,b2,eps) by ~1/(b0+b1+b2+eps) — an exact-arithmetic
    no-op for the weight formulas (all degree-0 homogeneous in beta+eps)
    that keeps every f32 intermediate inside the normal range at eps=1e-8.

    The scale only needs to be NEAR 1/sum, so f32 uses the exact
    power of two 2^-e (sum = m·2^e, m∈[1,2)) read straight off the
    exponent bits: no divide, and scaling by
    a power of two is EXACT in floating point, so the f32 weights sit at
    pure-roundoff distance from the f64 path's
    (tests/test_advection.py::TestF32Weights)."""
    s = b[0] + b[1] + b[2] + eps
    if s.dtype == jnp.float32:
        bits = jax.lax.bitcast_convert_type(s, jnp.int32)
        # Clamp the subtracted exponent field at 1 (2^-126): for beta sums
        # >= 2^127 (fields ~1e19, already blown up) the difference would
        # underflow to +0.0, zeroing betas AND eps and turning the weight
        # combine into 0/0 = NaN where the old 1/s gave a subnormal scale
        # With the clamp the scale is merely too small and
        # the weights degrade gracefully toward the linear ones.
        inv = jax.lax.bitcast_convert_type(
            jnp.maximum(
                jnp.int32(0x7F000000) - (bits & jnp.int32(0x7F800000)),
                jnp.int32(0x00800000)),
            jnp.float32)
    else:
        inv = 1.0 / s
    return (b[0] * inv, b[1] * inv, b[2] * inv), eps * inv


def _weno5_left(c, sh):
    """Left-biased WENO5 value at face i from centers {i-3..i+1}."""
    cm3, cm2, cm1 = sh(c, -3), sh(c, -2), sh(c, -1)
    c0, cp1 = c, sh(c, 1)
    p0 = (2.0 * cm3 - 7.0 * cm2 + 11.0 * cm1) / 6.0
    p1 = (-cm2 + 5.0 * cm1 + 2.0 * c0) / 6.0
    p2 = (2.0 * cm1 + 5.0 * c0 - cp1) / 6.0
    b0 = (13.0 / 12.0) * (cm3 - 2 * cm2 + cm1) ** 2 + 0.25 * (cm3 - 4 * cm2 + 3 * cm1) ** 2
    b1 = (13.0 / 12.0) * (cm2 - 2 * cm1 + c0) ** 2 + 0.25 * (cm2 - c0) ** 2
    b2 = (13.0 / 12.0) * (cm1 - 2 * c0 + cp1) ** 2 + 0.25 * (3 * cm1 - 4 * c0 + cp1) ** 2
    return _weno_combine((p0, p1, p2), (b0, b1, b2))


def _weno5_right(c, sh):
    """Right-biased WENO5 value at face i from centers {i-2..i+2}."""
    cm2, cm1 = sh(c, -2), sh(c, -1)
    c0, cp1, cp2 = c, sh(c, 1), sh(c, 2)
    p0 = (2.0 * cp2 - 7.0 * cp1 + 11.0 * c0) / 6.0
    p1 = (-cp1 + 5.0 * c0 + 2.0 * cm1) / 6.0
    p2 = (2.0 * c0 + 5.0 * cm1 - cm2) / 6.0
    b0 = (13.0 / 12.0) * (cp2 - 2 * cp1 + c0) ** 2 + 0.25 * (cp2 - 4 * cp1 + 3 * c0) ** 2
    b1 = (13.0 / 12.0) * (cp1 - 2 * c0 + cm1) ** 2 + 0.25 * (cp1 - cm1) ** 2
    b2 = (13.0 / 12.0) * (c0 - 2 * cm1 + cm2) ** 2 + 0.25 * (3 * c0 - 4 * cm1 + cm2) ** 2
    return _weno_combine((p0, p1, p2), (b0, b1, b2))


def _weno5_pair(c, sh):
    """(left, right) WENO5 values at face i, sharing smoothness indicators.

    The right-biased substencils at face i are the left-biased ones at
    face i+1 in reverse: β_r,k(i) = β_l,2-k(i+1) exactly (the 13/12 term
    is symmetric and the 1/4 term's sign flips under mirroring before
    squaring). So the right betas are three shifts of the left betas —
    deduplicated to zero cost by the roll memo hooks — instead of three
    recomputations: ~15% of the whole step's flops on the upwind pairs.
    The composed stencil radius is unchanged (sh(β_l, 1) reaches sh(c, 2)).
    Near BOUNDED walls the shifted betas are exact precisely where the
    WENO value survives `_degrade_weno_*` (β_l(i+1) needs 3 <= i+1 <=
    N-1... <= the degradation bands), so wall behavior is identical."""
    cm3, cm2, cm1 = sh(c, -3), sh(c, -2), sh(c, -1)
    c0, cp1, cp2 = c, sh(c, 1), sh(c, 2)
    p0 = (2.0 * cm3 - 7.0 * cm2 + 11.0 * cm1) / 6.0
    p1 = (-cm2 + 5.0 * cm1 + 2.0 * c0) / 6.0
    p2 = (2.0 * cm1 + 5.0 * c0 - cp1) / 6.0
    b0 = (13.0 / 12.0) * (cm3 - 2 * cm2 + cm1) ** 2 + 0.25 * (cm3 - 4 * cm2 + 3 * cm1) ** 2
    b1 = (13.0 / 12.0) * (cm2 - 2 * cm1 + c0) ** 2 + 0.25 * (cm2 - c0) ** 2
    b2 = (13.0 / 12.0) * (cm1 - 2 * c0 + cp1) ** 2 + 0.25 * (3 * cm1 - 4 * c0 + cp1) ** 2
    left = _weno_combine((p0, p1, p2), (b0, b1, b2))
    q0 = (2.0 * cp2 - 7.0 * cp1 + 11.0 * c0) / 6.0
    q1 = (-cp1 + 5.0 * c0 + 2.0 * cm1) / 6.0
    q2 = (2.0 * c0 + 5.0 * cm1 - cm2) / 6.0
    right = _weno_combine((q0, q1, q2), (sh(b2, 1), sh(b1, 1), sh(b0, 1)))
    return left, right


# Nonlinear weight flavor. The reference's Oceananigans vintage (the one
# providing ``WENO5(vector_invariant = VelocityStencil())``,
# SWMHD_example.jl:24) computes its nonlinear weights in WENO-Z form
# (Borges et al. 2008): a_k = gamma_k * (1 + (tau5/(beta_k+eps))^2) with
# tau5 = |beta0 - beta2|. This is empirically decisive for matching the
# reference's recorded conservation envelopes: on the 64^2 low_B_low_U
# scenario classic Jiang-Shu weights over-dissipate the wound-up magnetic
# potential (total-energy deviation 3.5 vs the recorded 0.78, reference-
# style functionals) while Z-weights reproduce the reference's signature
# non-monotone deviation curve and final KE/ME (1.9; ME_end 0.304 vs
# recorded 0.313) — see benchmarks/exp/r3_wenoz.py and VALIDATION.md.
# SWMHD_WENO_WEIGHTS=js restores classic Jiang & Shu.
_WENO_Z = os.environ.get("SWMHD_WENO_WEIGHTS", "z") == "z"

# Divide-free weight evaluation: multiply the nonlinear-weight numerators
# and the normalisation by (b0+eps)^2 (b1+eps)^2 (b2+eps)^2, turning the
# 3 divides + normalisation divide into 1 divide + a handful of
# multiplies. Algebraically the same rational function; floating-point
# results differ at roundoff only. Whether the saved divides pay on the
# GPU is not measured yet. SWMHD_WENO_RATIONAL=0 restores the textbook
# evaluation.
_WENO_RATIONAL = os.environ.get("SWMHD_WENO_RATIONAL", "1") == "1"


def _weno_combine(ps, betas, betas_external=None):
    b = betas_external if betas_external is not None else betas
    eps = _eps_for(b[0])
    if not _is_f64(b[0]):
        b, eps = _normalize_betas(b, eps)
    if _WENO_Z:
        tau2 = (b[0] - b[2]) ** 2         # tau5^2; |.|^2 needs no abs
        if _WENO_RATIONAL:
            q0 = (b[0] + eps) ** 2
            q1 = (b[1] + eps) ** 2
            q2 = (b[2] + eps) ** 2
            a0 = _GAMMA[0] * (q0 + tau2) * (q1 * q2)
            a1 = _GAMMA[1] * (q1 + tau2) * (q0 * q2)
            a2 = _GAMMA[2] * (q2 + tau2) * (q0 * q1)
            return (a0 * ps[0] + a1 * ps[1] + a2 * ps[2]) / (a0 + a1 + a2)
        a0 = _GAMMA[0] * (1.0 + tau2 / (b[0] + eps) ** 2)
        a1 = _GAMMA[1] * (1.0 + tau2 / (b[1] + eps) ** 2)
        a2 = _GAMMA[2] * (1.0 + tau2 / (b[2] + eps) ** 2)
        return (a0 * ps[0] + a1 * ps[1] + a2 * ps[2]) / (a0 + a1 + a2)
    if _WENO_RATIONAL:
        q0 = (b[0] + eps) ** 2
        q1 = (b[1] + eps) ** 2
        q2 = (b[2] + eps) ** 2
        a0 = _GAMMA[0] * (q1 * q2)
        a1 = _GAMMA[1] * (q0 * q2)
        a2 = _GAMMA[2] * (q0 * q1)
        return (a0 * ps[0] + a1 * ps[1] + a2 * ps[2]) / (a0 + a1 + a2)
    a0 = _GAMMA[0] / (b[0] + eps) ** 2
    a1 = _GAMMA[1] / (b[1] + eps) ** 2
    a2 = _GAMMA[2] / (b[2] + eps) ** 2
    s = a0 + a1 + a2
    return (a0 * ps[0] + a1 * ps[1] + a2 * ps[2]) / s


def weno_betas_left(c, sh):
    """Smoothness indicators of the left stencil — exposed for the
    vector-invariant VelocityStencil variant (weights from the velocity
    field, candidates from vorticity)."""
    cm3, cm2, cm1 = sh(c, -3), sh(c, -2), sh(c, -1)
    c0, cp1 = c, sh(c, 1)
    b0 = (13.0 / 12.0) * (cm3 - 2 * cm2 + cm1) ** 2 + 0.25 * (cm3 - 4 * cm2 + 3 * cm1) ** 2
    b1 = (13.0 / 12.0) * (cm2 - 2 * cm1 + c0) ** 2 + 0.25 * (cm2 - c0) ** 2
    b2 = (13.0 / 12.0) * (cm1 - 2 * c0 + cp1) ** 2 + 0.25 * (3 * cm1 - 4 * c0 + cp1) ** 2
    return (b0, b1, b2)


def weno_betas_right(c, sh):
    cm2, cm1 = sh(c, -2), sh(c, -1)
    c0, cp1, cp2 = c, sh(c, 1), sh(c, 2)
    b0 = (13.0 / 12.0) * (cp2 - 2 * cp1 + c0) ** 2 + 0.25 * (cp2 - 4 * cp1 + 3 * c0) ** 2
    b1 = (13.0 / 12.0) * (cp1 - 2 * c0 + cm1) ** 2 + 0.25 * (cp1 - cm1) ** 2
    b2 = (13.0 / 12.0) * (c0 - 2 * cm1 + cm2) ** 2 + 0.25 * (3 * c0 - 4 * cm1 + cm2) ** 2
    return (b0, b1, b2)


def shift_betas_left_to_right(bl, sh):
    """Right-biased betas from the left-biased ones: β_r,k(i) = β_l,2-k(i+1)
    exactly (same substencils, mirror signs vanish under the squares) —
    three shifts instead of a recomputation (see _weno5_pair)."""
    return (sh(bl[2], 1), sh(bl[1], 1), sh(bl[0], 1))


def weno_candidates_left(c, sh):
    cm3, cm2, cm1 = sh(c, -3), sh(c, -2), sh(c, -1)
    c0, cp1 = c, sh(c, 1)
    p0 = (2.0 * cm3 - 7.0 * cm2 + 11.0 * cm1) / 6.0
    p1 = (-cm2 + 5.0 * cm1 + 2.0 * c0) / 6.0
    p2 = (2.0 * cm1 + 5.0 * c0 - cp1) / 6.0
    return (p0, p1, p2)


def weno_candidates_right(c, sh):
    cm2, cm1 = sh(c, -2), sh(c, -1)
    c0, cp1, cp2 = c, sh(c, 1), sh(c, 2)
    p0 = (2.0 * cp2 - 7.0 * cp1 + 11.0 * c0) / 6.0
    p1 = (-cp1 + 5.0 * c0 + 2.0 * cm1) / 6.0
    p2 = (2.0 * c0 + 5.0 * cm1 - cm2) / 6.0
    return (p0, p1, p2)


def _sh_x(grid):
    return lambda a, n: op.shift_x(a, n, grid)


def _sh_y(grid):
    return lambda a, n: op.shift_y(a, n, grid)


def weno5_left_x_f(c, grid):
    r = _weno5_left(c, _sh_x(grid))
    return _degrade_weno_x_f(r, c, grid, left=True)


def weno5_right_x_f(c, grid):
    r = _weno5_right(c, _sh_x(grid))
    return _degrade_weno_x_f(r, c, grid, left=False)


def weno5_left_y_f(c, grid):
    r = _weno5_left(c, _sh_y(grid))
    return _degrade_weno_y_f(r, c, grid, left=True)


def weno5_right_y_f(c, grid):
    r = _weno5_right(c, _sh_y(grid))
    return _degrade_weno_y_f(r, c, grid, left=False)


def weno5_pair_x_f(c, grid):
    l, r = _weno5_pair(c, _sh_x(grid))
    return (_degrade_weno_x_f(l, c, grid, left=True),
            _degrade_weno_x_f(r, c, grid, left=False))


def weno5_pair_y_f(c, grid):
    l, r = _weno5_pair(c, _sh_y(grid))
    return (_degrade_weno_y_f(l, c, grid, left=True),
            _degrade_weno_y_f(r, c, grid, left=False))


def weno5_pair_x_c(u, grid):
    l, r = weno5_pair_x_f(u, grid)
    return op.shift_x(l, 1, grid), op.shift_x(r, 1, grid)


def weno5_pair_y_c(v, grid):
    l, r = weno5_pair_y_f(v, grid)
    return op.shift_y(l, 1, grid), op.shift_y(r, 1, grid)


def weno5_left_x_c(u, grid):
    return op.shift_x(weno5_left_x_f(u, grid), 1, grid)


def weno5_right_x_c(u, grid):
    return op.shift_x(weno5_right_x_f(u, grid), 1, grid)


def weno5_left_y_c(v, grid):
    return op.shift_y(weno5_left_y_f(v, grid), 1, grid)


def weno5_right_y_c(v, grid):
    return op.shift_y(weno5_right_y_f(v, grid), 1, grid)


def _degrade_weno_x_f(r5, c, grid, left):
    """WENO needs 3 cells of support on the biased side; within 3 cells of a
    Bounded x-wall fall back to the (already wall-degraded) 3rd-order biased
    value, then to 1st order at the outermost faces."""
    if grid.topology_x != BOUNDED:
        return r5
    i = _index_x(c)
    N = op.global_nx(grid)
    r3 = left3_x_f(c, grid) if left else right3_x_f(c, grid)
    if left:
        return jnp.where((i < 3) | (i > N - 2), r3, r5)
    return jnp.where((i < 2) | (i > N - 3), r3, r5)


def _degrade_weno_y_f(r5, c, grid, left):
    if grid.topology_y != BOUNDED:
        return r5
    j = _index_y(c)
    N = op.global_ny(grid)
    r3 = left3_y_f(c, grid) if left else right3_y_f(c, grid)
    if left:
        return jnp.where((j < 3) | (j > N - 2), r3, r5)
    return jnp.where((j < 2) | (j > N - 3), r3, r5)


# =================================================================================
# Scheme objects
# =================================================================================


@dataclasses.dataclass(frozen=True)
class AdvectionScheme:
    """Bundle of biased/symmetric reconstruction functions.

    ``halo`` is the stencil half-width the distributed path must exchange
    (WENO5 -> 3, matching the reference's Oceananigans halo requirement)."""
    name: str
    halo: int
    left_x_f: Callable
    right_x_f: Callable
    left_y_f: Callable
    right_y_f: Callable
    left_x_c: Callable
    right_x_c: Callable
    left_y_c: Callable
    right_y_c: Callable
    # optional fused (left, right) reconstructions — WENO5 shares the
    # smoothness indicators between the two sides (see _weno5_pair)
    pair_x_f: Optional[Callable] = None
    pair_y_f: Optional[Callable] = None
    pair_x_c: Optional[Callable] = None
    pair_y_c: Optional[Callable] = None

    def both_x_f(self, c, grid):
        if self.pair_x_f is not None:
            return self.pair_x_f(c, grid)
        return self.left_x_f(c, grid), self.right_x_f(c, grid)

    def both_y_f(self, c, grid):
        if self.pair_y_f is not None:
            return self.pair_y_f(c, grid)
        return self.left_y_f(c, grid), self.right_y_f(c, grid)

    def both_x_c(self, u, grid):
        if self.pair_x_c is not None:
            return self.pair_x_c(u, grid)
        return self.left_x_c(u, grid), self.right_x_c(u, grid)

    def both_y_c(self, v, grid):
        if self.pair_y_c is not None:
            return self.pair_y_c(v, grid)
        return self.left_y_c(v, grid), self.right_y_c(v, grid)

    def flux_x_f(self, transport_f, c, grid):
        """Upwind flux of center-field ``c`` through x-faces, given the
        transport velocity already at x-faces."""
        return upwind_biased_product(transport_f, *self.both_x_f(c, grid))

    def flux_y_f(self, transport_f, c, grid):
        return upwind_biased_product(transport_f, *self.both_y_f(c, grid))

    def flux_x_c(self, transport_c, u, grid):
        """Upwind flux of face-field ``u`` at centers."""
        return upwind_biased_product(transport_c, *self.both_x_c(u, grid))

    def flux_y_c(self, transport_c, v, grid):
        return upwind_biased_product(transport_c, *self.both_y_c(v, grid))


def _centered_pair(interp):
    def left(a, grid):
        return interp(a, grid)
    return left, left


Centered2 = AdvectionScheme(
    name="centered2", halo=1,
    left_x_f=op.ix_f, right_x_f=op.ix_f,
    left_y_f=op.iy_f, right_y_f=op.iy_f,
    left_x_c=op.ix_c, right_x_c=op.ix_c,
    left_y_c=op.iy_c, right_y_c=op.iy_c,
)

UpwindBiased3 = AdvectionScheme(
    name="upwind3", halo=2,
    left_x_f=left3_x_f, right_x_f=right3_x_f,
    left_y_f=left3_y_f, right_y_f=right3_y_f,
    left_x_c=left3_x_c, right_x_c=right3_x_c,
    left_y_c=left3_y_c, right_y_c=right3_y_c,
)

WENO5 = AdvectionScheme(
    name="weno5", halo=3,
    left_x_f=weno5_left_x_f, right_x_f=weno5_right_x_f,
    left_y_f=weno5_left_y_f, right_y_f=weno5_right_y_f,
    left_x_c=weno5_left_x_c, right_x_c=weno5_right_x_c,
    left_y_c=weno5_left_y_c, right_y_c=weno5_right_y_c,
    pair_x_f=weno5_pair_x_f, pair_y_f=weno5_pair_y_f,
    pair_x_c=weno5_pair_x_c, pair_y_c=weno5_pair_y_c,
)

SCHEMES = {s.name: s for s in (Centered2, UpwindBiased3, WENO5)}


def get_scheme(name_or_scheme):
    if isinstance(name_or_scheme, AdvectionScheme):
        return name_or_scheme
    return SCHEMES[str(name_or_scheme).lower()]
