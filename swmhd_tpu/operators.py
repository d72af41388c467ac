"""C-grid operator algebra, array form.

Array-form re-design of the Oceananigans.Operators subset the reference
composes its physics from (imports at reference: test_example.jl:4; usage:
divergence_formulation/sw_mhd_divergence_functions.jl:3-170,
jacobian_formulation/sw_mhd_jacobian_functions.jl:1-26).

The reference evaluates operators *per point* through nested closures
(`ℑxᶜᵃᵃ(i,j,k,grid,∂xᶠᶜᶜ,A)`); here every operator is a pure whole-array
function, composition happens at trace time, and XLA does the fusion and
scheduling. Periodic topology is a
`jnp.roll`; bounded topology clamps the shift at the walls (halo-free
edge replication), with the one-sided near-wall stencil degradation of the
reference handled explicitly in `swmhd_tpu.advection`.

Index convention (0-based, arrays shaped (Nx, Ny), axis 0 = x):

    face i   = left edge of cell i      (Julia face i+1)
    center i = midpoint of cell i       (Julia center i+1)

Operator dictionary vs Oceananigans (uniform grid):

    ∂xᶠᶜᶜ(c)[i] = (c[i] - c[i-1])/dx      -> ddx_f(c, grid)
    ∂xᶜᵃᵃ(f)[i] = (f[i+1] - f[i])/dx      -> ddx_c(f, grid)
    ℑxᶜᵃᵃ(f)[i] = (f[i+1] + f[i])/2       -> ix_c(f, grid)
    ℑxᶠᵃᵃ(c)[i] = (c[i] + c[i-1])/2       -> ix_f(c, grid)
    δxᶠᵃᵃ(c)[i] = c[i] - c[i-1]           -> dx_f(c, grid)
    δxᶜᵃᵃ(f)[i] = f[i+1] - f[i]           -> dx_c(f, grid)
    ℑxyᶠᶜᵃ = ix_f∘iy_c, ℑxyᶜᶠᵃ = ix_c∘iy_f (4-point corner means)

(and the same with x<->y, axis 1.)
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
from jax import lax

from .grid import Grid, PERIODIC, BOUNDED

__all__ = [
    "shift_x", "shift_y",
    "dx_f", "dx_c", "dy_f", "dy_c",
    "dx_c_flux", "dy_c_flux", "ddx_c_flux", "ddy_c_flux",
    "ix_f", "ix_c", "iy_f", "iy_c",
    "ixy_ff", "ixy_cc", "ixy_fc", "ixy_cf",
    "ddx_f", "ddx_c", "ddy_f", "ddy_c",
    "laplacian_cc", "vorticity_ff", "divergence_cc",
    "kinetic_energy_cc",
    "IndexContext", "set_index_ctx", "get_index_ctx",
    "global_index_x", "global_index_y", "global_nx", "global_ny",
]


# -- global-index context (sharded BOUNDED topology) ----------------------------
#
# All wall machinery — clamped shifts, wall-flux zeroing, near-wall stencil
# degradation (advection), no-penetration masks (model) — is keyed on the
# *global* index of each row/column. On a single unsharded array the global
# index is just the local one; inside a shard_map-ped tile (padded with an
# exchanged halo) it is offset by the shard's (traced) origin. Installing an
# IndexContext during the local-tendency trace makes the identical tendency
# code wall-exact on every shard (see parallel/decomposition.py; the
# reference behavior preserved is the Bounded-wall stencil branching of
# sw_mhd_divergence_functions.jl:42-57).

@dataclasses.dataclass
class IndexContext:
    """Maps local array indices to global domain indices.

    ``ox``/``oy``: global index of local row/column 0 (may be a traced
    scalar inside shard_map). ``gNx``/``gNy``: global domain sizes (the
    sizes the wall masks compare against, instead of the local
    ``grid.Nx/Ny``)."""
    ox: object
    oy: object
    gNx: int
    gNy: int


_INDEX_CTX = [None]


def set_index_ctx(ctx):
    """Install an IndexContext (None to clear); returns the previous one."""
    old = _INDEX_CTX[0]
    _INDEX_CTX[0] = ctx
    return old


def get_index_ctx():
    return _INDEX_CTX[0]


def global_index_x(a) -> jnp.ndarray:
    """Global x-index of every element of ``a`` (a full-shape 2-D iota,
    which XLA fuses into its consumers at no cost)."""
    idx = lax.broadcasted_iota(jnp.int32, a.shape, 0)
    ctx = _INDEX_CTX[0]
    return idx if ctx is None else idx + ctx.ox


def global_index_y(a) -> jnp.ndarray:
    idx = lax.broadcasted_iota(jnp.int32, a.shape, 1)
    ctx = _INDEX_CTX[0]
    return idx if ctx is None else idx + ctx.oy


def global_nx(grid: Grid) -> int:
    ctx = _INDEX_CTX[0]
    return grid.Nx if ctx is None else ctx.gNx


def global_ny(grid: Grid) -> int:
    ctx = _INDEX_CTX[0]
    return grid.Ny if ctx is None else ctx.gNy


# -- shifts -------------------------------------------------------------------

# Pluggable periodic-roll implementation: jnp.roll by default, swapped for
# the pad-memo roll while a tendency is traced (pad_roll_scope).
_ROLL = [jnp.roll]


def set_roll_impl(fn):
    """Install a roll(a, shift, axis) implementation; returns the old one."""
    old = _ROLL[0]
    _ROLL[0] = fn
    return old


def make_pad_roll(radius: int = 4):
    """Pad-once-per-(array, axis) roll: each distinct array that gets
    shifted is wrap-padded once (one concatenate); every shift of it is
    then a ``lax.slice`` of the pad. Slices of a fusion parameter are
    indexed reads in XLA, whereas each materialised ``jnp.roll`` can be a
    copy. Values are bitwise identical to jnp.roll.

    The memo pins each base array so recycled ``id()``s cannot alias; use
    one hook per trace (see :func:`pad_roll_scope`) so pinned tracers are
    released when the trace ends."""
    memo = {}

    def roll(a, r, axis):
        n = a.shape[axis]
        rr = ((r + n // 2) % n) - n // 2
        if abs(rr) > radius or n < radius:
            return jnp.roll(a, r, axis)
        key = (id(a), axis)
        ent = memo.get(key)
        if ent is None or ent[0] is not a:
            lo = lax.slice_in_dim(a, n - radius, n, axis=axis)
            hi = lax.slice_in_dim(a, 0, radius, axis=axis)
            ent = (a, lax.concatenate([lo, a, hi], dimension=axis))
            memo[key] = ent
        start = radius - rr       # out[i] = a[i - rr] = pad[i - rr + radius]
        return lax.slice_in_dim(ent[1], start, start + n, axis=axis)

    return roll


class pad_roll_scope:
    """Context manager installing a fresh pad-memo roll for one tendency
    trace. A no-op when another roll hook is already installed (a nested
    scope keeps its parent's memo)."""

    def __init__(self, radius: int = 4):
        self.radius = radius
        self._prev = None
        self._installed = False

    def __enter__(self):
        if _ROLL[0] is jnp.roll:
            self._prev = set_roll_impl(make_pad_roll(self.radius))
            self._installed = True
        return self

    def __exit__(self, *exc):
        if self._installed:
            set_roll_impl(self._prev)
        return False


def shift_x(a: jnp.ndarray, n: int, grid: Grid) -> jnp.ndarray:
    """out[i, j] = a[i+n, j], periodic wrap or bounded edge-clamp."""
    if n == 0:
        return a
    if grid.topology_x == PERIODIC:
        return _ROLL[0](a, -n, 0)
    return _clamped_shift(a, n, axis=0)


def shift_y(a: jnp.ndarray, n: int, grid: Grid) -> jnp.ndarray:
    """out[i, j] = a[i, j+n]."""
    if n == 0:
        return a
    if grid.topology_y == PERIODIC:
        return _ROLL[0](a, -n, 1)
    return _clamped_shift(a, n, axis=1)


def _clamped_shift(a: jnp.ndarray, n: int, axis: int) -> jnp.ndarray:
    # Replicate edge values instead of wrapping: out[i] = a[clip(i+n)],
    # with i and the clip range in GLOBAL indices (IndexContext-aware so a
    # shard_map-ped padded tile clamps at the true domain walls, not at its
    # own edges; interior shards never trigger the clamp).
    #
    # Pure roll + where + slice form (no scatter) so the SAME code runs on
    # a whole array and under shard_map. The roll goes through the
    # pluggable _ROLL hook so the pad-memo roll dedup applies to bounded
    # shifts too.
    ctx = _INDEX_CTX[0]
    rolled = _ROLL[0](a, -n, axis)
    gi = global_index_x(a) if axis == 0 else global_index_y(a)
    if ctx is None:
        gN = a.shape[axis]
        if n > 0:
            cond = gi + n > gN - 1
            wall = lax.slice_in_dim(a, gN - 1, gN, axis=axis)
        else:
            cond = gi + n < 0
            wall = lax.slice_in_dim(a, 0, 1, axis=axis)
        return jnp.where(cond, wall, rolled)
    gN = ctx.gNx if axis == 0 else ctx.gNy
    origin = ctx.ox if axis == 0 else ctx.oy
    if n > 0:
        cond = gi + n > gN - 1
        wall_local = gN - 1 - origin   # local index of the global last row
    else:
        cond = gi + n < 0
        wall_local = -origin           # local index of global row 0
    # dynamic_slice clamps the (traced) start, so shards that don't own the
    # wall row read harmless in-range data — their cond is all-False anyway.
    wall = lax.dynamic_slice_in_dim(a, wall_local, 1, axis)
    return jnp.where(cond, wall, rolled)


# -- differences (δ) ----------------------------------------------------------

def dx_f(a, grid):  # δxᶠᵃᵃ: center field -> face: a[i] - a[i-1]
    return a - shift_x(a, -1, grid)


def dx_c(a, grid):  # δxᶜᵃᵃ: face field -> center: a[i+1] - a[i]
    return shift_x(a, 1, grid) - a


def dy_f(a, grid):  # δyᵃᶠᵃ
    return a - shift_y(a, -1, grid)


def dy_c(a, grid):  # δyᵃᶜᵃ
    return shift_y(a, 1, grid) - a


# -- flux differences (wall-aware) ---------------------------------------------
#
# For BOUNDED axes the face beyond the last interior face is the domain wall
# and carries zero normal flux; the plain clamped shift would instead
# replicate the interior value (zero difference) and silently leak. Apply
# these to face-located *fluxes*; pair with wall-masked normal velocities
# (ShallowWaterModel._mask_walls) so the first face is zero too, making
# column sums telescope to zero — exact conservation in a closed basin.

def dx_c_flux(f, grid):
    up = shift_x(f, 1, grid)
    if grid.topology_x == BOUNDED:
        # zero the flux through the GLOBAL wall face (where-form: the same
        # code on a whole array and under shard_map)
        up = jnp.where(global_index_x(up) == global_nx(grid) - 1,
                       0.0, up)
    return up - f


def dy_c_flux(f, grid):
    up = shift_y(f, 1, grid)
    if grid.topology_y == BOUNDED:
        up = jnp.where(global_index_y(up) == global_ny(grid) - 1,
                       0.0, up)
    return up - f


def ddx_c_flux(f, grid):
    return dx_c_flux(f, grid) / grid.dx


def ddy_c_flux(f, grid):
    return dy_c_flux(f, grid) / grid.dy


# -- derivatives (∂ = δ/Δ) -----------------------------------------------------

def ddx_f(a, grid):  # ∂xᶠᶜᶜ of a center field
    return dx_f(a, grid) / grid.dx


def ddx_c(a, grid):  # ∂xᶜᵃᵃ of a face field
    return dx_c(a, grid) / grid.dx


def ddy_f(a, grid):  # ∂yᶜᶠᶜ of a center field
    return dy_f(a, grid) / grid.dy


def ddy_c(a, grid):  # ∂yᵃᶜᵃ of a face field
    return dy_c(a, grid) / grid.dy


# -- interpolations (ℑ, 2-point means) ----------------------------------------

def ix_f(a, grid):  # ℑxᶠᵃᵃ: center -> face
    return 0.5 * (a + shift_x(a, -1, grid))


def ix_c(a, grid):  # ℑxᶜᵃᵃ: face -> center
    return 0.5 * (shift_x(a, 1, grid) + a)


def iy_f(a, grid):  # ℑyᵃᶠᵃ
    return 0.5 * (a + shift_y(a, -1, grid))


def iy_c(a, grid):  # ℑyᵃᶜᵃ
    return 0.5 * (shift_y(a, 1, grid) + a)


# -- 4-point corner means (ℑxy..) ----------------------------------------------

def ixy_fc(a, grid):
    """ℑxyᶠᶜᵃ: (c,f)-located field -> (f,c). 4-pt mean of a cfc field."""
    return ix_f(iy_c(a, grid), grid)


def ixy_cf(a, grid):
    """ℑxyᶜᶠᵃ: (f,c)-located field -> (c,f)."""
    return ix_c(iy_f(a, grid), grid)


def ixy_ff(a, grid):
    """ccc -> ffc 4-pt mean."""
    return ix_f(iy_f(a, grid), grid)


def ixy_cc(a, grid):
    """ffc -> ccc 4-pt mean."""
    return ix_c(iy_c(a, grid), grid)


# -- composite diagnostics ------------------------------------------------------

def vorticity_ff(u, v, grid):
    """ζ = ∂x v − ∂y u at corners (f,f,c).

    Reference diagnostic `ω = ∂x(v) - ∂y(u)` (test_example.jl:123)."""
    return ddx_f(v, grid) - ddy_f(u, grid)


def divergence_cc(u, v, grid):
    """∇·(u,v) at centers from face-located u (f,c) and v (c,f)."""
    return ddx_c(u, grid) + ddy_c(v, grid)


def laplacian_cc(a, grid):
    """5-point Laplacian of a center field (used by Laplacian diffusion)."""
    return ddx_c(ddx_f(a, grid), grid) + ddy_c(ddy_f(a, grid), grid)


def kinetic_energy_cc(u, v, grid):
    """K = (ℑxᶜ(u²) + ℑyᶜ(v²))/2 at centers — the C-grid kinetic energy used
    by the vector-invariant gradient term."""
    return 0.5 * (ix_c(u * u, grid) + iy_c(v * v, grid))
