"""Staggered Arakawa C-grid for the shallow-water MHD framework.

Re-designs the grid object the reference builds via Oceananigans'
``RectilinearGrid(size=(Nx,Ny), x=(-Lx/2,Lx/2), y=(-Ly/2,Ly/2),
topology=(Periodic,Periodic,Flat))`` (reference:
jacobian_formulation/SWMHD_example.jl:14-16,
divergence_formulation/divergence_sw_mhd.jl:12-14) as a JAX pytree.

Unlike Oceananigans there are no halo cells in the stored arrays: the
single-device reference implementation applies periodic topology with
`jnp.roll`, and the distributed path (swmhd_tpu.parallel) materialises halos
only inside the sharded step where they are exchanged between devices
with `lax.ppermute`.

Staggering convention (matches Oceananigans' 1-based faces, 0-based here):

    x-face  i is the *left* edge of cell i:  xf[i] = x0 + i*dx
    x-center i is the cell midpoint:         xc[i] = x0 + (i+1/2)*dx

Field locations are named by the reference's (x, y) staggering:
  - ``ccc``: cell centers (h, A, and divergence-form Bx/By numerators)
  - ``fcc``: x-face, y-center (u, uh, jacobian-form Lorentz x-force)
  - ``cfc``: x-center, y-face (v, vh, jacobian-form Lorentz y-force)
  - ``ffc``: corners (vorticity)
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

PERIODIC = "periodic"
BOUNDED = "bounded"

_VALID_TOPOLOGIES = (PERIODIC, BOUNDED)


@partial(jax.tree_util.register_dataclass,
         data_fields=[],
         meta_fields=["Nx", "Ny", "Lx", "Ly", "x0", "y0",
                      "topology_x", "topology_y", "dtype_name"])
@dataclasses.dataclass(frozen=True)
class Grid:
    """Uniform rectilinear staggered grid (2-D, z Flat).

    All metadata is static (hashable) so a ``Grid`` can be closed over by or
    passed through ``jax.jit`` without retrigging compilation unless the grid
    actually changes.
    """

    Nx: int
    Ny: int
    Lx: float
    Ly: float
    x0: float  # coordinate of x-face 0 (left domain edge)
    y0: float  # coordinate of y-face 0 (bottom domain edge)
    topology_x: str = PERIODIC
    topology_y: str = PERIODIC
    dtype_name: str = "float32"

    # -- construction -------------------------------------------------------

    @staticmethod
    def regular(Nx: int, Ny: int,
                extent_x: Tuple[float, float],
                extent_y: Tuple[float, float],
                topology: Tuple[str, str] = (PERIODIC, PERIODIC),
                dtype=jnp.float32) -> "Grid":
        tx, ty = (t.lower() for t in topology)
        if tx not in _VALID_TOPOLOGIES or ty not in _VALID_TOPOLOGIES:
            raise ValueError(f"topology must be in {_VALID_TOPOLOGIES}")
        return Grid(Nx=int(Nx), Ny=int(Ny),
                    Lx=float(extent_x[1] - extent_x[0]),
                    Ly=float(extent_y[1] - extent_y[0]),
                    x0=float(extent_x[0]), y0=float(extent_y[0]),
                    topology_x=tx, topology_y=ty,
                    dtype_name=jnp.dtype(dtype).name)

    # -- derived metadata ----------------------------------------------------

    @property
    def dtype(self):
        return jnp.dtype(self.dtype_name)

    @property
    def dx(self) -> float:
        return self.Lx / self.Nx

    @property
    def dy(self) -> float:
        return self.Ly / self.Ny

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.Nx, self.Ny)

    # Cell/face areas for a uniform grid with Flat z (dz = 1), mirroring the
    # Oceananigans area factors Ax*/Ay*/Az* used by the divergence-form
    # Lorentz flux (reference: divergence_formulation/
    # sw_mhd_divergence_functions.jl:59,83,107,131,163-169). On a uniform
    # rectilinear grid these are location-independent constants.
    @property
    def Ax(self) -> float:  # area of an x-normal cell face = dy*dz
        return self.dy

    @property
    def Ay(self) -> float:  # area of a y-normal cell face = dx*dz
        return self.dx

    @property
    def Az(self) -> float:  # horizontal cell area = dx*dy
        return self.dx * self.dy

    # -- staggered coordinates ----------------------------------------------

    def xf(self) -> jnp.ndarray:
        """x-face coordinates, shape (Nx,). xf[i] = left edge of cell i."""
        return self.x0 + self.dx * jnp.arange(self.Nx, dtype=self.dtype)

    def xc(self) -> jnp.ndarray:
        """x-center coordinates, shape (Nx,)."""
        return self.x0 + self.dx * (jnp.arange(self.Nx, dtype=self.dtype) + 0.5)

    def yf(self) -> jnp.ndarray:
        return self.y0 + self.dy * jnp.arange(self.Ny, dtype=self.dtype)

    def yc(self) -> jnp.ndarray:
        return self.y0 + self.dy * (jnp.arange(self.Ny, dtype=self.dtype) + 0.5)

    def nodes(self, loc: str = "cc"):
        """2-D coordinate meshes (X, Y) for a staggering `loc` in
        {"cc","fc","cf","ff"} — the analog of Oceananigans' `nodes(...)`
        (reference: jacobian_formulation/SWMHD_example.jl:105)."""
        lx, ly = loc[0], loc[1]
        x = self.xc() if lx == "c" else self.xf()
        y = self.yc() if ly == "c" else self.yf()
        return jnp.meshgrid(x, y, indexing="ij")

    # -- IC evaluation (the `set!` analog) -----------------------------------

    def evaluate(self, fn, loc: str = "cc") -> jnp.ndarray:
        """Evaluate ``fn(x, y)`` on the staggered mesh of ``loc``.

        The array-form analog of Oceananigans ``set!(model, u=fn, ...)``
        (reference: jacobian_formulation/SWMHD_example.jl:36-41).
        """
        X, Y = self.nodes(loc)
        return jnp.asarray(fn(X, Y), dtype=self.dtype)

    # -- misc -----------------------------------------------------------------

    def with_dtype(self, dtype) -> "Grid":
        return dataclasses.replace(self, dtype_name=jnp.dtype(dtype).name)

    def __repr__(self) -> str:  # keep it short in logs
        return (f"Grid({self.Nx}x{self.Ny}, Lx={self.Lx}, Ly={self.Ly}, "
                f"topo=({self.topology_x},{self.topology_y}), "
                f"{self.dtype_name})")
