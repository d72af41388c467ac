"""Shallow-water (MHD-capable) model: both reference formulations.

Re-designs the used subset of Oceananigans' ``ShallowWaterModel``
(reference call sites: jacobian_formulation/SWMHD_example.jl:21-33,
divergence_formulation/divergence_sw_mhd.jl:19-31) as two pure tendency
functions over a :class:`~swmhd_tpu.models.state.State` pytree plus a
low-storage RK3 stepper. Everything is trace-once/`jit`-compiled; the forcing
hook is preserved in array form (a callable ``(grid, clock, fields) ->
array`` per prognostic, the analog of ``Forcing(f, discrete_form=true)``,
SWMHD_example.jl:30-31).

Equations (flat bottom, g = gravitational_acceleration, f-plane):

vector-invariant (prognostics u, v, h; SWMHD_example.jl:32):
    ∂t u = +⟨ζ v⟩ᵘᵖ + f v̄ − ∂x(K + g h) + ν∇²u + F_u
    ∂t v = −⟨ζ u⟩ᵘᵖ − f ū − ∂y(K + g h) + ν∇²v + F_v
    ∂t h = −∇·(u h̃)                 (h̃ upwind-reconstructed: mass_advection)

conservative (prognostics uh, vh, h; divergence_sw_mhd.jl:30):
    ∂t uh = −∇·(uh ⊗ ũ) + f v̄h − g h̄ ∂x h + ν∇²uh + F_uh
    ∂t vh = −∇·(vh ⊗ ṽ) − f ūh − g h̄ ∂y h + ν∇²vh + F_vh
    ∂t h  = −∇·(uh, vh)

tracer (both): material conservation of A, discretised in hA-flux form so
∑ h A is conserved to round-off:
    ∂t A = ( A ∇·U − ∇·(U Ã) ) / h,   U = mass transport
(the continuous content matches the reference's A-as-tracer advection,
SWMHD_example.jl:26,29; see SURVEY §2.3.6 for the diagnostic-level delta.)

The WENO vector-invariant vorticity flux follows the upwinded
vector-invariant scheme Oceananigans names ``WENO5(vector_invariant =
VelocityStencil())`` (SWMHD_example.jl:24): the vorticity ζ is reconstructed
with biased WENO stencils in the direction transverse to each momentum
component and selected by the sign of the advecting transverse velocity;
``VelocityStencil`` computes the nonlinear weights from the smoothness of the
transverse velocity instead of ζ itself.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Mapping, Optional

import jax
import jax.numpy as jnp

from ..grid import Grid
from .. import operators as op
from ..advection import (
    AdvectionScheme, get_scheme, upwind_biased_product,
    weno_candidates_left, weno_candidates_right,
    weno_betas_left, weno_betas_right, shift_betas_left_to_right,
    _weno_combine,
)
from ..physics.coriolis import FPlane
from .state import State, Clock

VECTOR_INVARIANT = "vector_invariant"
CONSERVATIVE = "conservative"

# Oceananigans' :RungeKutta3 — the Le & Moin (1991) low-storage three-stage
# scheme selected by the reference (SWMHD_example.jl:23,
# divergence_sw_mhd.jl:20).
RK3_GAMMA = (8.0 / 15.0, 5.0 / 12.0, 3.0 / 4.0)
RK3_ZETA = (0.0, -17.0 / 60.0, -5.0 / 12.0)

# Vorticity-stencil flavors for the vector-invariant WENO vorticity flux.
VELOCITY_STENCIL = "velocity"
VORTICITY_STENCIL = "vorticity"
DEFAULT_STENCIL = VELOCITY_STENCIL


def _fields_namespace(model, state):
    """Named field access for forcing functions — the array analog of the
    reference's ``fields`` argument (sw_mhd_jacobian_functions.jl:20-26)."""
    f = {"h": state.h, "A": state.A}
    if model.formulation == VECTOR_INVARIANT:
        f["u"], f["v"] = state.u, state.v
    else:
        f["uh"], f["vh"] = state.u, state.v
    return f


@partial(jax.tree_util.register_dataclass,
         data_fields=[],
         meta_fields=["grid", "formulation", "gravitational_acceleration",
                      "coriolis", "momentum_advection", "mass_advection",
                      "tracer_advection", "vector_invariant_stencil",
                      "closure", "forcing", "A_background_gradient_y"])
@dataclasses.dataclass(frozen=True)
class ShallowWaterModel:
    grid: Grid
    formulation: str = VECTOR_INVARIANT
    gravitational_acceleration: float = 9.81
    coriolis: FPlane = FPlane(0.0)
    momentum_advection: AdvectionScheme = None
    mass_advection: AdvectionScheme = None
    tracer_advection: AdvectionScheme = None
    vector_invariant_stencil: str = DEFAULT_STENCIL
    closure: object = None            # LaplacianDiffusion / BiharmonicDiffusion
    forcing: tuple = ()               # ((name, fn), ...) name in u,v,uh,vh,h,A
    # Static linear background γ·y carried by the tracer A: the prognostic
    # state.A is the PERTURBATION, B gets the γ contribution analytically
    # (exact at Bounded walls, where the reference imposes the gradient as
    # a BC — SWMHD_example.jl:19), and the tracer tendency gains the exact
    # discrete source −γ·ℑyᶜ(Vf)/h from advecting the background.
    A_background_gradient_y: float = 0.0

    def __post_init__(self):
        from ..advection import WENO5
        if self.momentum_advection is None:
            object.__setattr__(self, "momentum_advection", WENO5)
        if self.mass_advection is None:
            object.__setattr__(self, "mass_advection", WENO5)
        if self.tracer_advection is None:
            object.__setattr__(self, "tracer_advection", WENO5)
        object.__setattr__(self, "momentum_advection",
                           get_scheme(self.momentum_advection))
        object.__setattr__(self, "mass_advection",
                           get_scheme(self.mass_advection))
        object.__setattr__(self, "tracer_advection",
                           get_scheme(self.tracer_advection))
        if isinstance(self.forcing, Mapping):
            object.__setattr__(self, "forcing", tuple(self.forcing.items()))
        if self.formulation not in (VECTOR_INVARIANT, CONSERVATIVE):
            raise ValueError(f"unknown formulation {self.formulation!r}")

    # -- required halo width (drives the distributed exchange) ---------------

    @property
    def halo(self) -> int:
        """Widest single-operator stencil half-width (WENO5 → 3)."""
        h = max(self.momentum_advection.halo, self.mass_advection.halo,
                self.tracer_advection.halo, 2)  # 2: jacobian Lorentz chain
        if self.closure is not None:
            h = max(h, 2 * getattr(self.closure, "halo", 1))
        return h

    @property
    def exchange_halo(self) -> int:
        """Composed stencil radius of ONE tendency evaluation — the halo a
        distributed tile must exchange per RK substage. Wider than `halo`:
        a reconstruction (radius `halo`) feeds a flux divergence (+1) whose
        transport velocity is itself reconstructed (+1 shift of another
        radius-`halo` reconstruction); the Lorentz chains compose to ≤ 4.
        Validated empirically by the sharded==single-device equality tests
        at this width (tests/test_parallel.py)."""
        return self.halo + 3

    # -- construction ---------------------------------------------------------

    def initial_state(self, u=None, v=None, h=None, A=None,
                      uh=None, vh=None) -> State:
        """The analog of `set!(model, u=…, v=…, h=…, A=…)`
        (SWMHD_example.jl:36-41): each entry is a callable ``fn(x, y)``
        evaluated on its staggered mesh, an array, or a scalar."""
        g = self.grid

        def ev(val, loc, default=0.0):
            if val is None:
                return jnp.full(g.shape, default, g.dtype)
            if callable(val):
                return g.evaluate(val, loc)
            arr = jnp.asarray(val, g.dtype)
            if arr.ndim == 0:
                return jnp.full(g.shape, arr, g.dtype)
            return arr

        if self.formulation == CONSERVATIVE:
            U = uh if uh is not None else u
            V = vh if vh is not None else v
        else:
            U, V = u, v

        def build() -> State:
            u_arr, v_arr = self._mask_walls(ev(U, "fc"), ev(V, "cf"))
            return State(h=ev(h, "cc", 1.0), u=u_arr, v=v_arr,
                         A=ev(A, "cc"), clock=Clock.zero())

        # One jitted evaluation instead of O(40) eager dispatches.
        # Callables that resist tracing (e.g. numpy-only) fall back.
        try:
            return jax.jit(build)()
        except Exception:
            return build()

    # -- diagnostics -----------------------------------------------------------

    def velocities(self, state: State):
        """(u, v) physical velocities regardless of formulation
        (`u = uh/h`, divergence_sw_mhd.jl:64-65)."""
        if self.formulation == VECTOR_INVARIANT:
            return state.u, state.v
        g = self.grid
        return state.u / op.ix_f(state.h, g), state.v / op.iy_f(state.h, g)

    def transports(self, state: State):
        """(uh, vh) mass transports at faces regardless of formulation."""
        if self.formulation == CONSERVATIVE:
            return state.u, state.v
        g = self.grid
        return state.u * op.ix_f(state.h, g), state.v * op.iy_f(state.h, g)

    # -- tendencies -------------------------------------------------------------

    def tendencies(self, state: State) -> State:
        """G = ∂t(state) as a State-shaped pytree (clock untouched).

        Traced under a pad-memo roll scope (operators.pad_roll_scope): every
        shifted array is wrap-padded once and sliced, which XLA fuses,
        instead of materialising one copy per roll — bitwise-identical
        values to ``jnp.roll``."""
        with op.pad_roll_scope():
            if self.formulation == VECTOR_INVARIANT:
                Gu, Gv, Gh, GA = self._tendencies_vector_invariant(state)
            else:
                Gu, Gv, Gh, GA = self._tendencies_conservative(state)
            Gu, Gv, Gh, GA = self._apply_forcing(state, Gu, Gv, Gh, GA)
            Gu, Gv = self._mask_walls(Gu, Gv)
        return State(h=Gh, u=Gu, v=Gv, A=GA, clock=state.clock)

    def _mask_walls(self, u_like, v_like):
        """No-penetration at BOUNDED walls: the wall-normal velocity (or
        transport, or its tendency) is pinned to zero on the wall face —
        face 0 of the bounded axis. The opposite wall face is not stored
        (face-count = center-count arrays); its zero flux is enforced by
        the wall-aware flux divergences (operators.d*_c_flux).

        Global-index aware (operators.IndexContext) so a shard_map-ped
        padded tile zeroes the true domain wall face, on edge shards only."""
        g = self.grid
        from ..grid import BOUNDED
        # where-form (not scatter) so the identical code runs on a whole
        # array and on a shard_map-ped padded tile
        if g.topology_x == BOUNDED:
            u_like = jnp.where(op.global_index_x(u_like) == 0,
                               0.0, u_like)
        if g.topology_y == BOUNDED:
            v_like = jnp.where(op.global_index_y(v_like) == 0,
                               0.0, v_like)
        return u_like, v_like

    def _apply_forcing(self, state, Gu, Gv, Gh, GA):
        if not self.forcing:
            return Gu, Gv, Gh, GA
        fields = _fields_namespace(self, state)
        umom = "u" if self.formulation == VECTOR_INVARIANT else "uh"
        vmom = "v" if self.formulation == VECTOR_INVARIANT else "vh"
        for name, fn in self.forcing:
            # A tuple key means one callable returns contributions for
            # several prognostics at once — lets e.g. the Lorentz force
            # share its B-field subgraph between the u and v components.
            names = name if isinstance(name, tuple) else (name,)
            contribs = fn(self.grid, state.clock, fields)
            if len(names) == 1:
                contribs = (contribs,)
            # Pin contributions to the grid dtype: since the clock rides
            # f64 under x64 (state.time_dtype), a forcing that uses
            # clock.time arithmetically would otherwise promote its
            # output — and through the Gu/Gv sums the whole scan carry —
            # to f64 (a trace-time carry-mismatch error). No-op for
            # already-correct dtypes.
            contribs = tuple(jnp.asarray(c, self.grid.dtype)
                             for c in contribs)
            for nm, contrib in zip(names, contribs):
                if nm == umom:
                    Gu = Gu + contrib
                elif nm == vmom:
                    Gv = Gv + contrib
                elif nm == "h":
                    Gh = Gh + contrib
                elif nm == "A":
                    GA = GA + contrib
                else:
                    raise ValueError(
                        f"forcing on unknown prognostic {nm!r}")
        return Gu, Gv, Gh, GA

    # .. vector-invariant .........................................................

    def _tendencies_vector_invariant(self, state):
        g = self.grid
        u, v, h, A = state.u, state.v, state.h, state.A
        gacc = self.gravitational_acceleration

        # mass flux with upwind-reconstructed h (mass_advection=WENO5(),
        # SWMHD_example.jl:25)
        ms = self.mass_advection
        Uf = upwind_biased_product(u, *ms.both_x_f(h, g))
        Vf = upwind_biased_product(v, *ms.both_y_f(h, g))
        divU = op.ddx_c_flux(Uf, g) + op.ddy_c_flux(Vf, g)
        Gh = -divU

        # vorticity flux (the WENO vector-invariant scheme) + KE gradient
        zeta = op.vorticity_ff(u, v, g)
        vort_u, vort_v = self._vorticity_flux(u, v, zeta, g)
        K = op.kinetic_energy_cc(u, v, g)
        Gu = vort_u - op.ddx_f(K + gacc * h, g)
        Gv = vort_v - op.ddy_f(K + gacc * h, g)

        # Coriolis (FPlane(f=1), SWMHD_example.jl:28)
        Gu = Gu + self.coriolis.tendency_u(v, g)
        Gv = Gv + self.coriolis.tendency_v(u, g)

        GA = self._tracer_tendency(A, h, Uf, Vf, divU)

        if self.closure is not None:
            Gu = Gu + self.closure.tendency_u(u, g)
            Gv = Gv + self.closure.tendency_v(v, g)
            GA = GA + self.closure.tendency_c(A, g)
        return Gu, Gv, Gh, GA

    def _vorticity_flux(self, u, v, zeta, g):
        """⟨ζ v⟩ᵘᵖ at (f,c) and −⟨ζ u⟩ᵘᵖ at (c,f)."""
        scheme = self.momentum_advection
        if scheme.name == "centered2":
            # enstrophy-flavored centered form: ℑy[ζ · ℑx(v)], −ℑx[ζ · ℑy(u)]
            vort_u = op.iy_c(zeta * op.ix_f(v, g), g)
            vort_v = -op.ix_c(zeta * op.iy_f(u, g), g)
            return vort_u, vort_v
        if scheme.name == "weno5":
            return self._weno_vorticity_flux(u, v, zeta, g)
        # generic biased scheme: reconstruct ζ transverse, upwind on the
        # interpolated transverse velocity
        v_hat = op.ixy_fc(v, g)
        zl = scheme.left_y_c(zeta, g)
        zr = scheme.right_y_c(zeta, g)
        vort_u = upwind_biased_product(v_hat, zl, zr)
        u_hat = op.ixy_cf(u, g)
        zl = scheme.left_x_c(zeta, g)
        zr = scheme.right_x_c(zeta, g)
        vort_v = -upwind_biased_product(u_hat, zl, zr)
        return vort_u, vort_v

    def _weno_vorticity_flux(self, u, v, zeta, g):
        """WENO5 upwinded vorticity flux with VelocityStencil/VorticityStencil
        weight selection (SWMHD_example.jl:24, SURVEY §7.3 hard-part #1).

        The scheme is the upwinded vector-invariant WENO of Silvestri &
        Wagner ("A new WENO-based momentum advection scheme...", the
        scheme Oceananigans ships as ``WENO5(vector_invariant =
        VelocityStencil())``): ζ (at (f,f)) is reconstructed with biased
        WENO candidate stencils onto the flux point, the branch is
        selected by the sign of the 4-pt-interpolated transverse
        velocity, and — the VelocityStencil part — the nonlinear weights
        come not from ζ's own smoothness but from the smoothness of the
        velocity components interpolated to ζ's staggering, averaged:
        β_k = (β_k(ū) + β_k(v̄))/2 with ū = ℑyᶠ(u), v̄ = ℑxᶠ(v) at (f,f).
        Provenance: derived from the published scheme description (the
        Oceananigans source itself is not retrievable in this
        environment); pinned by tests/test_velocity_stencil.py and by the
        recorded-scenario envelopes (VALIDATION.md)."""
        use_velocity = self.vector_invariant_stencil == VELOCITY_STENCIL
        shx = lambda a, n: op.shift_x(a, n, g)
        shy = lambda a, n: op.shift_y(a, n, g)
        if use_velocity:
            u_ff = op.iy_f(u, g)   # u interpolated to (f,f)
            v_ff = op.ix_f(v, g)   # v interpolated to (f,f)

        def avg_betas(beta_fn, a, b, sh):
            ba = beta_fn(a, sh)
            bb = beta_fn(b, sh)
            return tuple(0.5 * (x + y) for x, y in zip(ba, bb))

        # u-equation: reconstruct ζ (at (f,f)) along y onto (f,c).
        # center-from-faces recon at j == face-form recon at j+1.
        zeta_y = shy(zeta, 1)
        pl_ = weno_candidates_left(zeta_y, shy)
        pr = weno_candidates_right(zeta_y, shy)
        if use_velocity:
            u_y, v_y = shy(u_ff, 1), shy(v_ff, 1)
            bl = avg_betas(weno_betas_left, u_y, v_y, shy)
            br = shift_betas_left_to_right(bl, shy)
        else:
            bl = weno_betas_left(zeta_y, shy)
            br = shift_betas_left_to_right(bl, shy)
        zl = _weno_combine(pl_, bl)
        zr = _weno_combine(pr, br)
        v_hat = op.ixy_fc(v, g)
        vort_u = upwind_biased_product(v_hat, zl, zr)

        # v-equation: reconstruct ζ along x onto (c,f).
        zeta_x = shx(zeta, 1)
        pl_ = weno_candidates_left(zeta_x, shx)
        pr = weno_candidates_right(zeta_x, shx)
        if use_velocity:
            u_x, v_x = shx(u_ff, 1), shx(v_ff, 1)
            bl = avg_betas(weno_betas_left, u_x, v_x, shx)
            br = shift_betas_left_to_right(bl, shx)
        else:
            bl = weno_betas_left(zeta_x, shx)
            br = shift_betas_left_to_right(bl, shx)
        zl = _weno_combine(pl_, bl)
        zr = _weno_combine(pr, br)
        u_hat = op.ixy_cf(u, g)
        vort_v = -upwind_biased_product(u_hat, zl, zr)
        return vort_u, vort_v

    # .. conservative ..............................................................

    def _tendencies_conservative(self, state):
        g = self.grid
        uh, vh, h, A = state.u, state.v, state.h, state.A
        gacc = self.gravitational_acceleration
        scheme = self.momentum_advection

        h_fx = op.ix_f(h, g)   # h̄ at (f,c)
        h_fy = op.iy_f(h, g)   # h̄ at (c,f)
        u = uh / h_fx
        v = vh / h_fy

        # momentum flux divergence ∇·(U ⊗ ũ), transport symmetric, advected
        # velocity upwind-reconstructed (the WENO5() momentum advection of
        # divergence_sw_mhd.jl:22)
        tx_cc = op.ix_c(uh, g)                       # transport at (c,c)
        flux_xx = upwind_biased_product(tx_cc, *scheme.both_x_c(u, g))
        ty_ff = op.ix_f(vh, g)                       # transport at (f,f)
        flux_yx = upwind_biased_product(ty_ff, *scheme.both_y_f(u, g))
        Gu = -(op.ddx_f(flux_xx, g) + op.ddy_c_flux(flux_yx, g))

        tx_ff = op.iy_f(uh, g)
        flux_xy = upwind_biased_product(tx_ff, *scheme.both_x_f(v, g))
        ty_cc = op.iy_c(vh, g)
        flux_yy = upwind_biased_product(ty_cc, *scheme.both_y_c(v, g))
        Gv = -(op.ddx_c_flux(flux_xy, g) + op.ddy_f(flux_yy, g))

        # gravity: −g h̄ ∂(h)
        Gu = Gu - gacc * h_fx * op.ddx_f(h, g)
        Gv = Gv - gacc * h_fy * op.ddy_f(h, g)

        # Coriolis on transports (FPlane(f=1), divergence_sw_mhd.jl:26)
        Gu = Gu + self.coriolis.tendency_u(vh, g)
        Gv = Gv + self.coriolis.tendency_v(uh, g)

        # mass: ∂t h = −∇·(uh, vh) — transports are prognostic, no recon
        divU = op.ddx_c_flux(uh, g) + op.ddy_c_flux(vh, g)
        Gh = -divU

        GA = self._tracer_tendency(A, h, uh, vh, divU)

        if self.closure is not None:
            Gu = Gu + self.closure.tendency_u(uh, g)
            Gv = Gv + self.closure.tendency_v(vh, g)
            GA = GA + self.closure.tendency_c(A, g)
        return Gu, Gv, Gh, GA

    # .. tracer ......................................................................

    def _tracer_tendency(self, A, h, Uf, Vf, divU):
        """∂t A = (A ∇·U − ∇·(U Ã))/h with Ã upwind-reconstructed — the
        hA-conservative discretisation of the induction equation
        ∂t A + u·∇A = 0 (tracer A, SWMHD_example.jl:26,29).

        With a linear background γ·y (A_background_gradient_y), advecting
        the background adds −γ·ℑyᶜ(Vf)/h: the exact discrete residue of
        (γy·∇·U − ∇·(U·γỹ))/h when the background's face values are taken
        analytically (continuum limit −γ·v, i.e. −u·∇(γy))."""
        g = self.grid
        ts = self.tracer_advection
        fx = upwind_biased_product(Uf, *ts.both_x_f(A, g))
        fy = upwind_biased_product(Vf, *ts.both_y_f(A, g))
        div_flux = op.ddx_c_flux(fx, g) + op.ddy_c_flux(fy, g)
        GA = (A * divU - div_flux) / h
        gamma = self.A_background_gradient_y
        if gamma:
            GA = GA - gamma * op.iy_c(Vf, g) / h
        return GA

    # -- time stepping ---------------------------------------------------------------

    def step(self, state: State, dt) -> State:
        """One RK3 step (3 tendency evaluations), Le–Moin low-storage
        coefficients — Oceananigans' :RungeKutta3 (SWMHD_example.jl:23)."""
        G_prev = None
        s = state
        for gamma, zeta_c in zip(RK3_GAMMA, RK3_ZETA):
            G = self.tendencies(s)
            if G_prev is None:
                incr = jax.tree.map(lambda gn: dt * gamma * gn,
                                    (G.h, G.u, G.v, G.A))
            else:
                incr = jax.tree.map(
                    lambda gn, gp: dt * (gamma * gn + zeta_c * gp),
                    (G.h, G.u, G.v, G.A),
                    (G_prev.h, G_prev.u, G_prev.v, G_prev.A))
            s = s.replace(h=s.h + incr[0], u=s.u + incr[1],
                          v=s.v + incr[2], A=s.A + incr[3])
            G_prev = G
        return s.replace(clock=state.clock.tick(dt))

    def step_fn(self, dt, n_steps: int = 1,
                diagnostics: Optional[Callable] = None):
        """A jittable function advancing ``n_steps`` RK3 steps via
        `lax.scan` (chunked hot loop, SURVEY §3.3).

        Without ``diagnostics``: ``state -> state``. With ``diagnostics``
        (a ``state -> {name: scalar}`` callable): ``state -> (state,
        {name: (n_steps,) array})`` — per-step scalar series computed
        in-graph, so a chunk costs ONE host round trip regardless of the
        diagnostic cadence (the reference recomputes its energies eagerly
        every iteration, SWMHD_example.jl:87-92).

        Clock discipline: in-scan time is
        RECONSTRUCTED as ``t0 + (k+1)*dt`` from the scan index instead of
        accumulated ``+= dt``, so an f32 clock (x64-off production)
        carries a single rounding — no O(n·ulp) drift — and an f64 clock
        is exact to ~1 ulp over any chunk length."""
        def fn(s):
            t0 = s.clock.time

            def one(carry, k):
                s2 = self.step(carry, dt)
                s2 = s2.replace(clock=Clock(
                    time=t0 + (k + 1).astype(t0.dtype) * dt,
                    iteration=s2.clock.iteration))
                ys = diagnostics(s2) if diagnostics is not None else None
                return s2, ys

            ks = jnp.arange(n_steps, dtype=jnp.int32)
            out, series = jax.lax.scan(one, s, ks)
            return (out, series) if diagnostics is not None else out
        return fn
