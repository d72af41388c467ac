"""Diffusion-closure tests.

The reference runs inviscid, so these closures have no reference
counterpart to match — they are verified against analysis instead:
order-2 convergence of the staggered Laplacians, exact discrete-eigenvalue
decay of a Fourier mode under the full RK3 step, sign/dissipativity, and
the halo bookkeeping the distributed path relies on.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from swmhd_tpu.grid import Grid
from swmhd_tpu.models.shallow_water import ShallowWaterModel
from swmhd_tpu.physics.diffusion import (
    LaplacianDiffusion, BiharmonicDiffusion,
    laplacian_u, laplacian_v, laplacian_c)
from swmhd_tpu.physics.coriolis import FPlane


def _grid(N, dtype=jnp.float64):
    return Grid.regular(N, N, (0.0, 2 * math.pi), (0.0, 2 * math.pi),
                        dtype=dtype)


def _order(errs, Ns):
    e, n = np.log(np.asarray(errs)), np.log(np.asarray(Ns, float))
    return -np.polyfit(n, e, 1)[0]


@pytest.mark.parametrize("lap,loc", [(laplacian_u, "fc"),
                                     (laplacian_v, "cf"),
                                     (laplacian_c, "cc")])
def test_laplacian_convergence_order2(lap, loc):
    errs, Ns = [], (32, 64, 128)
    for N in Ns:
        g = _grid(N)
        X, Y = g.nodes(loc)
        f = jnp.sin(X) * jnp.cos(2 * Y)
        exact = -5.0 * f                     # ∇²(sin x cos 2y) = -(1+4) f
        errs.append(float(jnp.max(jnp.abs(lap(f, g) - exact))))
    assert _order(errs, Ns) > 1.9, (errs, _order(errs, Ns))


def _mode_decay_model(closure, N=64):
    g = _grid(N)
    model = ShallowWaterModel(grid=g, coriolis=FPlane(0.0),
                              gravitational_acceleration=0.0,
                              closure=closure)
    return model


@pytest.mark.parametrize("kind", ["laplacian", "biharmonic"])
def test_fourier_mode_decay_rate(kind):
    """A tiny u = ε sin(mx) mode must decay at the closure's *discrete*
    eigenvalue rate through the full RK3 step (advection is O(ε²)):
    λ = -ν k̃²  (Laplacian)  or  -ν k̃⁴ (biharmonic), with
    k̃² = (2 sin(k dx / 2) / dx)² the staggered-Laplacian eigenvalue.
    A sign error or a staggering slip in the closure fails this hard."""
    nu = 5e-3
    closure = (LaplacianDiffusion(nu=nu) if kind == "laplacian"
               else BiharmonicDiffusion(nu=nu))
    model = _mode_decay_model(closure)
    g = model.grid
    m = 3
    k2 = (2.0 * math.sin(m * g.dx / 2.0) / g.dx) ** 2
    lam = -nu * k2 if kind == "laplacian" else -nu * k2 ** 2

    eps = 1e-6
    u0 = lambda x, y: eps * jnp.sin(m * x)
    state = model.initial_state(u=u0, h=1.0)
    dt, n = 1e-3, 200
    out = jax.jit(model.step_fn(dt, n))(state)

    amp0 = float(jnp.max(jnp.abs(state.u)))
    amp1 = float(jnp.max(jnp.abs(out.u)))
    expected = amp0 * math.exp(lam * dt * n)
    assert amp1 == pytest.approx(expected, rel=1e-4), (
        f"{kind}: decay {amp1/amp0:.6f} vs exp(lam t) "
        f"{expected/amp0:.6f}")


def test_biharmonic_is_dissipative_for_sharp_features():
    """-ν∇⁴ must damp, never amplify, a noisy field (sign check)."""
    g = _grid(64)
    model = _mode_decay_model(BiharmonicDiffusion(nu=1e-4, kappa=1e-4))
    key = jax.random.PRNGKey(0)
    noise = 1e-3 * jax.random.normal(key, (64, 64), dtype=g.dtype)
    state = model.initial_state(h=1.0)
    state = state.replace(u=noise, A=noise)
    out = jax.jit(model.step_fn(1e-3, 50))(state)
    assert float(jnp.sum(out.u ** 2)) < float(jnp.sum(state.u ** 2))
    assert float(jnp.sum(out.A ** 2)) < float(jnp.sum(state.A ** 2))
    assert bool(jnp.all(jnp.isfinite(out.u)))


def test_closure_grows_model_halo():
    g = _grid(32)
    base = ShallowWaterModel(grid=g).halo
    lap = ShallowWaterModel(grid=g, closure=LaplacianDiffusion(nu=1.0)).halo
    bih = ShallowWaterModel(grid=g, closure=BiharmonicDiffusion(nu=1.0)).halo
    assert lap >= base and bih >= base
    assert bih >= 4  # two nested Laplacians per tendency


def test_tracer_kappa_independent_of_nu():
    """κ acts on A only; ν on momentum only."""
    model = _mode_decay_model(LaplacianDiffusion(nu=0.0, kappa=1e-2))
    g = model.grid
    A0 = lambda x, y: 1e-6 * jnp.sin(2 * x)
    state = model.initial_state(h=1.0, A=A0)
    out = jax.jit(model.step_fn(1e-3, 100))(state)
    k2 = (2.0 * math.sin(2 * g.dx / 2.0) / g.dx) ** 2
    expected = math.exp(-1e-2 * k2 * 0.1)
    got = float(jnp.max(jnp.abs(out.A))) / float(jnp.max(jnp.abs(state.A)))
    assert got == pytest.approx(expected, rel=1e-3)
    # momentum untouched by kappa (u stays zero)
    assert float(jnp.max(jnp.abs(out.u))) < 1e-14
