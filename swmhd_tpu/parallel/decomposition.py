"""2-D domain decomposition over a device mesh with halo exchange.

This is the subsystem the reference entirely lacks (SURVEY §2.2 O14, §5):
every reference script is single-process/single-device. The scaling axis
is grid size, decomposed over a ``jax.sharding.Mesh``:

 - each device owns an (Nx/px, Ny/py) tile of every field;
 - a step is a ``shard_map``-ped function: per RK3 substage, each tile is
   padded with an H-cell halo ring fetched from its 4 mesh neighbors via
   ``lax.ppermute`` (which XLA lowers to a collective-permute, carried by
   NCCL over NVLink between the GPUs of one host), the *same* tendency
   code as the single-device path runs on the padded tile, and the result
   is cropped;
 - H is the total composed stencil radius of one tendency evaluation
   (WENO5 reconstruction + flux divergence + Lorentz chain ⇒ 6 covers every
   scheme combination shipped here), so one exchange per substage suffices.

Because the padded tile reuses the identical roll-based operator algebra,
sharded and single-device runs execute the same arithmetic per interior
point — the sharded==unsharded equality test (tests/test_parallel.py) is the
race-detector analog for this framework (SURVEY §5).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..grid import PERIODIC
from ..models.state import State, Clock
from ..models.shallow_water import ShallowWaterModel, RK3_GAMMA, RK3_ZETA

AXIS_X, AXIS_Y = "x", "y"


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Tuple[int, int]] = None,
              devices=None) -> Mesh:
    """A 2-D ('x','y') mesh over the available devices. With no arguments,
    uses all devices in the squarest factorisation.

    Devices are laid out in ``jax.devices()`` order, row-major over
    ('x','y'). The GPUs of one host are joined all to all by NVLink, so
    every pair of mesh neighbours exchanges halos at the same rate and no
    ordering is better than another."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"make_mesh: asked for {n_devices} devices, "
                             f"have {len(devices)}")
        devices = devices[:n_devices]
    if shape is not None:
        need = shape[0] * shape[1]
        if need > len(devices):
            raise ValueError(f"mesh shape {shape} needs {need} devices, "
                             f"have {len(devices)}")
        devices = devices[:need]
    n = len(devices)
    if shape is None:
        px = int(math.sqrt(n))
        while n % px:
            px -= 1
        shape = (px, n // px)
    return Mesh(np.asarray(devices).reshape(shape), (AXIS_X, AXIS_Y))


def _halo_pad_axis(a, H: int, axis_name: str, array_axis: int, n_shards: int,
                   periodic: bool):
    """Pad local tile with H cells from ring neighbors along one mesh axis.

    Inside shard_map. out[0:H] = left neighbor's last H rows, etc. For a
    single-shard axis with periodic topology this degenerates to a local
    wrap (roll semantics preserved)."""
    if H == 0:
        return a
    take_lo = jax.lax.slice_in_dim(a, 0, H, axis=array_axis)
    take_hi = jax.lax.slice_in_dim(a, a.shape[array_axis] - H,
                                   a.shape[array_axis], axis=array_axis)
    if n_shards == 1:
        lo_halo, hi_halo = take_hi, take_lo  # pure wrap
    else:
        fwd = [(i, (i + 1) % n_shards) for i in range(n_shards)]
        bwd = [(i, (i - 1) % n_shards) for i in range(n_shards)]
        # halo on my low side comes from my lower neighbor's high slice
        lo_halo = jax.lax.ppermute(take_hi, axis_name, fwd)
        hi_halo = jax.lax.ppermute(take_lo, axis_name, bwd)
    if not periodic:
        # Bounded: edge shards replicate their own edge cells instead of
        # wrapping (operator-level clamp; biased schemes degrade near walls)
        idx = jax.lax.axis_index(axis_name)
        edge_lo = jnp.repeat(jax.lax.slice_in_dim(a, 0, 1, axis=array_axis),
                             H, axis=array_axis)
        edge_hi = jnp.repeat(
            jax.lax.slice_in_dim(a, a.shape[array_axis] - 1,
                                 a.shape[array_axis], axis=array_axis),
            H, axis=array_axis)
        lo_halo = jnp.where(idx == 0, edge_lo, lo_halo)
        hi_halo = jnp.where(idx == n_shards - 1, edge_hi, hi_halo)
    return jnp.concatenate([lo_halo, a, hi_halo], axis=array_axis)


@dataclasses.dataclass
class DomainDecomposition:
    """Shards a ShallowWaterModel's step over a 2-D device mesh.

    With ``overlap=True`` the tendency is split so the halo exchange runs
    concurrently with interior compute (SURVEY §5): the interior of
    each tile (every point ≥ halo from the edge) is computed from the
    *unpadded* tile — it depends on no exchanged data, so XLA's async
    collective scheduler can run the ``ppermute``s underneath it — and only
    four thin edge bands are recomputed from the padded tile afterwards.
    Both paths execute identical arithmetic per interior point, so
    sharded == unsharded remains exact (tests/test_parallel.py)."""

    model: ShallowWaterModel
    mesh: Mesh
    halo: Optional[int] = None
    overlap: bool = False

    def __post_init__(self):
        g = self.model.grid
        if self.halo is None:
            self.halo = self.model.exchange_halo
        self.px = self.mesh.shape[AXIS_X]
        self.py = self.mesh.shape[AXIS_Y]
        if g.Nx % self.px or g.Ny % self.py:
            raise ValueError(
                f"grid {g.Nx}x{g.Ny} not divisible by mesh "
                f"{self.px}x{self.py}")
        self.nx = g.Nx // self.px
        self.ny = g.Ny // self.py
        if self.halo > min(self.nx, self.ny):
            raise ValueError("halo wider than local tile")
        # local padded grid: same spacings, roll-based ops stay valid for
        # every interior point within `halo` of the pad edge. The GLOBAL
        # topology is preserved: bounded-wall machinery (clamped shifts,
        # wall-flux zeroing, near-wall stencil degradation, no-penetration
        # masks) stays active on the tile and is made wall-exact by the
        # operators.IndexContext installed around each tendency trace,
        # which maps local tile indices to global domain indices.
        self.local_grid = dataclasses.replace(
            g, Nx=self.nx + 2 * self.halo, Ny=self.ny + 2 * self.halo,
            Lx=g.dx * (self.nx + 2 * self.halo),
            Ly=g.dy * (self.ny + 2 * self.halo))
        self.local_model = dataclasses.replace(
            self.model, grid=self.local_grid)
        self.field_spec = P(AXIS_X, AXIS_Y)
        self.state_spec = State(h=self.field_spec, u=self.field_spec,
                                v=self.field_spec, A=self.field_spec,
                                clock=Clock(time=P(), iteration=P()))

    # -- sharding helpers ------------------------------------------------------

    def shard_state(self, state: State) -> State:
        shardings = jax.tree.map(
            lambda spec: NamedSharding(self.mesh, spec), self.state_spec,
            is_leaf=lambda x: isinstance(x, P))
        return jax.device_put(state, shardings)

    # -- halo machinery (run inside shard_map) -----------------------------------

    def _pad(self, a):
        g = self.model.grid
        a = _halo_pad_axis(a, self.halo, AXIS_X, 0, self.px,
                           g.topology_x == PERIODIC)
        a = _halo_pad_axis(a, self.halo, AXIS_Y, 1, self.py,
                           g.topology_y == PERIODIC)
        return a

    def _crop(self, a):
        H = self.halo
        return a[H:H + self.nx, H:H + self.ny]

    def _tile_origin(self):
        """Global index of local row/col 0 of the *unpadded* tile (traced)."""
        ox = jax.lax.axis_index(AXIS_X) * self.nx
        oy = jax.lax.axis_index(AXIS_Y) * self.ny
        return ox, oy

    def _ctx_tendencies(self, st, ox, oy):
        """Run the single-device tendency code with a global IndexContext so
        all wall machinery (clamped shifts, flux zeroing, stencil
        degradation, no-penetration masks) acts at the true domain walls."""
        from .. import operators as op
        g = self.model.grid
        prev = op.set_index_ctx(op.IndexContext(ox=ox, oy=oy,
                                                gNx=g.Nx, gNy=g.Ny))
        try:
            return self.local_model.tendencies(st)
        finally:
            op.set_index_ctx(prev)

    def _local_tendencies(self, h, u, v, A, clock):
        """Pad all prognostics, evaluate the full tendency on the padded
        tile with the single-device code path, crop."""
        if self.overlap and 3 * self.halo <= min(self.nx, self.ny):
            return self._local_tendencies_overlap(h, u, v, A, clock)
        st = State(h=self._pad(h), u=self._pad(u), v=self._pad(v),
                   A=self._pad(A), clock=clock)
        ox, oy = self._tile_origin()
        G = self._ctx_tendencies(st, ox - self.halo, oy - self.halo)
        return (self._crop(G.h), self._crop(G.u),
                self._crop(G.v), self._crop(G.A))

    def _local_tendencies_overlap(self, h, u, v, A, clock):
        """Interior tendency from the unpadded tile (no halo dependence,
        overlaps the ppermutes), then recompute the four edge bands of
        width ``halo`` from the exchanged pad."""
        H = self.halo
        nx, ny = self.nx, self.ny

        ox, oy = self._tile_origin()

        # 1. halo exchange — independent of the interior compute below.
        padded = [self._pad(f) for f in (h, u, v, A)]

        # 2. interior from local rolls on the unpadded tile: valid at
        #    distance >= H from the tile edge (the wrap ring is overwritten
        #    in step 3; near-wall rows of edge shards live inside that ring).
        G_int = self._ctx_tendencies(
            State(h=h, u=u, v=v, A=A, clock=clock), ox, oy)
        G = [G_int.h, G_int.u, G_int.v, G_int.A]

        # 3. edge bands from the padded tile. A band of 3H input rows
        #    yields H valid output rows (radius H stencils).
        def band_x(lo_row):  # input rows lo_row .. lo_row+3H of padded
            fs = [p[lo_row:lo_row + 3 * H, :] for p in padded]
            Gb = self._ctx_tendencies(
                State(h=fs[0], u=fs[1], v=fs[2], A=fs[3], clock=clock),
                ox - H + lo_row, oy - H)
            # valid output = band rows H..2H-1, crop y-halo
            return [b[H:2 * H, H:H + ny]
                    for b in (Gb.h, Gb.u, Gb.v, Gb.A)]

        def band_y(lo_col):
            fs = [p[:, lo_col:lo_col + 3 * H] for p in padded]
            Gb = self._ctx_tendencies(
                State(h=fs[0], u=fs[1], v=fs[2], A=fs[3], clock=clock),
                ox - H, oy - H + lo_col)
            return [b[H:H + nx, H:2 * H]
                    for b in (Gb.h, Gb.u, Gb.v, Gb.A)]

        bottom = band_x(0)                 # output rows 0..H-1
        top = band_x(nx - H)               # output rows nx-H..nx-1
        left = band_y(0)                   # output cols 0..H-1
        right = band_y(ny - H)             # output cols ny-H..ny-1

        for k in range(4):
            G[k] = jax.lax.dynamic_update_slice(G[k], bottom[k], (0, 0))
            G[k] = jax.lax.dynamic_update_slice(G[k], top[k], (nx - H, 0))
            G[k] = jax.lax.dynamic_update_slice(G[k], left[k], (0, 0))
            G[k] = jax.lax.dynamic_update_slice(G[k], right[k], (0, ny - H))
        return tuple(G)

    def _local_step(self, h, u, v, A, t, it, dt):
        clock = Clock(time=t, iteration=it)
        fields = (h, u, v, A)
        G_prev = None
        for gamma, zeta in zip(RK3_GAMMA, RK3_ZETA):
            G = self._local_tendencies(*fields, clock)
            if G_prev is None:
                fields = tuple(f + dt * gamma * g_
                               for f, g_ in zip(fields, G))
            else:
                fields = tuple(f + dt * (gamma * g_ + zeta * gp)
                               for f, g_, gp in zip(fields, G, G_prev))
            G_prev = G
        return (*fields, t + dt, it + 1)

    # -- public step -----------------------------------------------------------------

    def step_fn(self, dt, n_steps: int = 1, diagnostics=None):
        """Jitted sharded stepper advancing n_steps RK3 steps.

        Without ``diagnostics``: ``state -> state``, with the whole scan
        inside one shard_map (single collective program). With
        ``diagnostics`` (``state -> {name: scalar}``): ``state -> (state,
        series)`` — each scan iteration runs one shard_map-ped step, then
        evaluates the diagnostics on the *sharded global* state, where XLA
        inserts the reduction collectives; results are exact global values
        per step (same contract as the single-device path,
        ShallowWaterModel.step_fn)."""
        need = self.model.exchange_halo
        if self.halo < need:
            raise ValueError(
                f"halo {self.halo} < composed tendency radius {need} "
                f"(model.exchange_halo); the exchanged ring would be too "
                f"thin and tiles would silently diverge")
        fspec = self.field_spec

        @partial(shard_map, mesh=self.mesh,
                 in_specs=(fspec, fspec, fspec, fspec, P(), P()),
                 out_specs=(fspec, fspec, fspec, fspec, P(), P()),
                 check_vma=False)
        def sharded_steps(h, u, v, A, t, it):
            # time reconstructed from the step index — no f32 += dt
            # drift (see ShallowWaterModel.step_fn's clock note)
            t0 = t

            def body(carry, k):
                h, u, v, A, t, it = self._local_step(*carry, dt)
                t = t0 + (k + 1).astype(t0.dtype) * dt
                return (h, u, v, A, t, it), None
            out, _ = jax.lax.scan(body, (h, u, v, A, t, it),
                                  jnp.arange(n_steps, dtype=jnp.int32))
            return out

        @partial(shard_map, mesh=self.mesh,
                 in_specs=(fspec, fspec, fspec, fspec, P(), P()),
                 out_specs=(fspec, fspec, fspec, fspec, P(), P()),
                 check_vma=False)
        def sharded_one(h, u, v, A, t, it):
            return self._local_step(h, u, v, A, t, it, dt)

        def pack(parts):
            h, u, v, A, t, it = parts
            return State(h=h, u=u, v=v, A=A,
                         clock=Clock(time=t, iteration=it))

        if diagnostics is None:
            def fn(state: State) -> State:
                return pack(sharded_steps(
                    state.h, state.u, state.v, state.A,
                    state.clock.time, state.clock.iteration))
            return jax.jit(fn)

        def fn(state: State):
            t0 = state.clock.time

            def body(s, k):
                s2 = pack(sharded_one(s.h, s.u, s.v, s.A,
                                      s.clock.time, s.clock.iteration))
                s2 = s2.replace(clock=Clock(
                    time=t0 + (k + 1).astype(t0.dtype) * dt,
                    iteration=s2.clock.iteration))
                return s2, diagnostics(s2)
            out, series = jax.lax.scan(body, state,
                                       jnp.arange(n_steps,
                                                  dtype=jnp.int32))
            return out, series
        return jax.jit(fn)
