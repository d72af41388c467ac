"""State pytree for the shallow-water MHD model.

The analog of Oceananigans' `model.solution` + `model.tracers` + `model.clock`
(reference: jacobian_formulation/SWMHD_example.jl:50-57,67-69), designed as a
flat pytree of `jnp` arrays so it jits, shards, vmaps, and checkpoints
directly.

Field meaning depends on the model formulation:
  vector-invariant: ``u``/``v`` are velocities (reference prognostics u, v, h;
      SWMHD_example.jl:32,67)
  conservative:     ``u``/``v`` hold the transports uh, vh (reference
      prognostics uh, vh, h; divergence_sw_mhd.jl:30,63)
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp


def time_dtype():
    """The in-graph clock dtype: float64 whenever x64 is available, f32
    otherwise (graceful degradation — x64-off environments canonicalize
    f64 away anyway).

    Decoupled from the grid dtype: at f32 the
    accumulated ``t += dt`` drift reaches O(1e-2) absolute by t≈70, and
    the forcing-hook contract hands ``clock.time`` to user forcings (the
    array analog of the reference's ``clock`` argument,
    sw_mhd_jacobian_functions.jl:20-26). Under x64 (``--dtype float64``
    runs, the CPU validation gate) the clock rides f64. x64-off f32
    production keeps an f32 clock but WITHOUT drift: every stepper
    reconstructs in-scan time as ``t0 + k*dt`` (single rounding) and the
    simulation driver re-syncs the clock from its exact host-side time
    between chunks, so the in-graph time stays within ~1 ulp of true —
    the best an f32 scalar can represent."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


@partial(jax.tree_util.register_dataclass,
         data_fields=["time", "iteration"], meta_fields=[])
@dataclasses.dataclass(frozen=True)
class Clock:
    time: jnp.ndarray
    iteration: jnp.ndarray

    @staticmethod
    def zero(dtype=None) -> "Clock":
        """``dtype`` overrides the default :func:`time_dtype` (tests)."""
        return Clock(time=jnp.zeros((), dtype=dtype or time_dtype()),
                     iteration=jnp.zeros((), dtype=jnp.int32))

    def tick(self, dt) -> "Clock":
        return Clock(time=self.time + dt, iteration=self.iteration + 1)


@partial(jax.tree_util.register_dataclass,
         data_fields=["h", "u", "v", "A", "clock"], meta_fields=[])
@dataclasses.dataclass(frozen=True)
class State:
    h: jnp.ndarray   # layer thickness at (c,c)
    u: jnp.ndarray   # u or uh at (f,c)
    v: jnp.ndarray   # v or vh at (c,f)
    A: jnp.ndarray   # magnetic potential tracer at (c,c)
    clock: Clock

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)

    @property
    def shape(self):
        return self.h.shape
