"""Simulation driver: schedules, callbacks, output writers, the run loop.

The analog of Oceananigans' ``Simulation(model, Δt, stop_time)`` + ``run!``
+ ``Callback``/``IterationInterval``/``TimeInterval`` machinery the reference
drives every experiment with (jacobian_formulation/SWMHD_example.jl:42-97).

Accelerator-first structure (SURVEY §3.3): the hot loop is a jit-compiled
``lax.scan`` over RK3 steps; the driver advances in *chunks* sized so that no
schedule event falls inside a chunk, then fires callbacks/writers between
chunks. Nothing in the step graph touches the host.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time
from typing import Callable as _Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .models.state import Clock, State
from .utils.prettytime import prettytime

logger = logging.getLogger("swmhd_tpu")


# -- schedules -----------------------------------------------------------------


class IterationInterval:
    """Fires every n iterations (reference: SWMHD_example.jl:65,90)."""

    def __init__(self, n: int):
        self.n = int(n)

    def steps_until_due(self, iteration: int, time_: float, dt: float) -> int:
        r = self.n - (iteration % self.n)
        return r

    def is_due(self, iteration: int, time_: float, dt: float) -> bool:
        return iteration % self.n == 0


class TimeInterval:
    """Fires every `interval` of simulated time (reference:
    SWMHD_example.jl:82). Dates are compared with a half-Δt tolerance so
    float accumulation cannot skip an event.

    STATELESS (r4): due-ness is derived purely from the clock, so a
    checkpoint-resumed run fires the same events as an uninterrupted one
    (the r3 host-side ``_next`` cursor re-fired or skipped events on
    restore). The driver always lands within Δt/2 of
    an event (``steps_until_due`` sizes chunks that way), so "due" ==
    "within Δt/2 of a multiple of the interval"."""

    def __init__(self, interval: float):
        self.interval = float(interval)

    def steps_until_due(self, iteration: int, time_: float, dt: float) -> int:
        # smallest multiple of `interval` beyond the half-dt tolerance
        nxt = (math.floor((time_ + 0.5 * dt) / self.interval) + 1) \
            * self.interval
        return max(1, int(math.ceil((nxt - time_) / dt - 0.5)))

    def is_due(self, iteration: int, time_: float, dt: float) -> bool:
        nearest = round(time_ / self.interval) * self.interval
        return abs(time_ - nearest) <= 0.5 * dt


@dataclasses.dataclass
class Callback:
    """User callback `fn(simulation)` on a schedule
    (reference: SWMHD_example.jl:65)."""
    fn: _Callable
    schedule: object


# -- the driver -------------------------------------------------------------------


class Simulation:
    """``stepper`` defaults to the model itself (single-device path); pass
    a :class:`~swmhd_tpu.parallel.DomainDecomposition` to drive a sharded
    multi-chip/multi-host run through the same schedules, writers, and
    in-graph scalar series."""

    def __init__(self, model, dt: float, stop_time: Optional[float] = None,
                 stop_iteration: Optional[int] = None, stepper=None):
        if stop_time is None and stop_iteration is None:
            raise ValueError("need stop_time or stop_iteration")
        self.model = model
        self.stepper = stepper if stepper is not None else model
        self.dt = float(dt)
        self.stop_time = stop_time
        self.stop_iteration = stop_iteration
        self.callbacks: Dict[str, Callback] = {}
        self.output_writers: Dict[str, object] = {}
        self.state: Optional[State] = None
        self._compiled = {}
        self.run_wall_time = 0.0

    def _series_writers(self):
        from .io.writers import ScalarSeriesWriter
        return [w for w in self.output_writers.values()
                if isinstance(w, ScalarSeriesWriter)]

    def _diag_fn(self):
        """Combined in-graph diagnostics of all ScalarSeriesWriters."""
        writers = self._series_writers()
        if not writers:
            return None
        model = self.model

        def diag(state):
            out = {}
            for w in writers:
                out.update(w.fn(model, state))
            return out
        return diag

    # cache one compiled executable per distinct chunk length
    def _stepper(self, n_steps: int):
        fn = self._compiled.get(n_steps)
        if fn is None:
            fn = jax.jit(self.stepper.step_fn(self.dt, n_steps,
                                              diagnostics=self._diag_fn()))
            self._compiled[n_steps] = fn
        return fn

    def _schedules(self):
        """Schedules that constrain the chunk length. ScalarSeriesWriter
        cadences don't: their rows are computed in-graph every step and
        subsampled host-side."""
        series = set(id(w) for w in self._series_writers())
        for cb in self.callbacks.values():
            yield cb.schedule
        for w in self.output_writers.values():
            if id(w) not in series:
                yield w.schedule

    def _fire(self, iteration: int, t: float, force: bool = False):
        # Always evaluate is_due so stateful schedules (TimeInterval)
        # advance past events consumed by a forced initial fire.
        series = set(id(w) for w in self._series_writers())
        for cb in self.callbacks.values():
            if cb.schedule.is_due(iteration, t, self.dt) or force:
                cb.fn(self)
        for w in self.output_writers.values():
            if id(w) in series:
                continue
            if w.schedule.is_due(iteration, t, self.dt) or force:
                w.write(self)

    def run(self, state: State) -> State:
        """run! — advance to stop_time/stop_iteration, firing schedules."""
        self.state = state
        t0_wall = time.perf_counter()

        it = int(state.clock.iteration)
        t = float(state.clock.time)
        series_writers = self._series_writers()
        # initial outputs (Oceananigans writes at iteration 0 too)
        self._fire(it, t, force=True)
        if series_writers:
            diag0 = jax.jit(self._diag_fn())(state)
            for w in series_writers:
                w.write_series([t], [it],
                               {k: np.asarray(v)[None]
                                for k, v in jax.device_get(diag0).items()})

        while True:
            remaining = self._steps_remaining(it, t)
            if remaining <= 0:
                break
            n = remaining
            for s in self._schedules():
                n = min(n, s.steps_until_due(it, t, self.dt))
            n = max(1, n)
            # Clock resync (r5): the driver's t is exact f64; writing it
            # back caps the in-graph clock's error at one rounding of t
            # itself even when the clock is f32 (x64-off production).
            # The steppers' in-scan t0 + k*dt reconstruction bounds
            # within-chunk error; this bounds cross-chunk accumulation.
            # A host scalar write is async (no device round trip).
            self.state = self.state.replace(clock=Clock(
                time=jnp.asarray(t, self.state.clock.time.dtype),
                iteration=self.state.clock.iteration))
            out = self._stepper(n)(self.state)
            if series_writers:
                self.state, series = out
                times = t + self.dt * np.arange(1, n + 1)
                iters = it + np.arange(1, n + 1)
                series = jax.device_get(series)
                for w in series_writers:
                    w.write_series(times, iters, series)
            else:
                self.state = out
            it += n
            t += n * self.dt
            self._fire(it, t)

        jax.block_until_ready(self.state)
        self.run_wall_time = time.perf_counter() - t0_wall
        logger.info("simulation finished in %s (%d iterations)",
                    prettytime(self.run_wall_time), it)
        for w in self.output_writers.values():
            w.close()
        return self.state

    def _steps_remaining(self, it: int, t: float) -> int:
        n = 10 ** 12
        if self.stop_iteration is not None:
            n = min(n, self.stop_iteration - it)
        if self.stop_time is not None:
            n = min(n, int(round((self.stop_time - t) / self.dt)))
        return n


class TimeStepWizard:
    """Adaptive Δt controller — the analog of Oceananigans'
    ``TimeStepWizard``: attach as a Callback; it rescales ``sim.dt`` toward
    a target CFL, bounded by ``max_change``/``min_change`` per adjustment
    and ``(min_dt, max_dt)``. Each change invalidates the simulation's
    compiled-stepper cache (a jitted step closes over dt), so schedule it
    sparingly (e.g. every 50-100 iterations)."""

    def __init__(self, cfl: float = 0.7, max_change: float = 1.1,
                 min_change: float = 0.5, min_dt: float = 0.0,
                 max_dt: Optional[float] = None):
        self.cfl = cfl
        self.max_change = max_change
        self.min_change = min_change
        self.min_dt = min_dt
        self.max_dt = max_dt
        # jitted once PER MODEL (dt rides as a traced argument): a wizard
        # instance reattached to a different simulation must not reuse a
        # closure over the previous model's grid spacings
        self._cfl_cache = (None, None)  # (model, jitted fn)

    def __call__(self, sim: "Simulation"):
        from . import diagnostics
        model, fn = self._cfl_cache
        if model is not sim.model:
            model = sim.model
            fn = jax.jit(
                lambda s, dt: diagnostics.cfl_numbers(model, s, dt))
            self._cfl_cache = (model, fn)
        adv, wave = fn(sim.state, sim.dt)
        current = max(float(adv), float(wave))
        if current <= 0:
            return
        factor = min(self.max_change,
                     max(self.min_change, self.cfl / current))
        new_dt = sim.dt * factor
        if self.max_dt is not None:
            new_dt = min(new_dt, self.max_dt)
        new_dt = max(new_dt, self.min_dt)
        if abs(new_dt - sim.dt) / sim.dt > 1e-12:
            logger.info("TimeStepWizard: dt %.3e -> %.3e (CFL %.3f)",
                        sim.dt, new_dt, current)
            sim.dt = new_dt
            sim._compiled.clear()


def progress_callback(h0=None):
    """A ready-made progress logger matching the reference's fields
    (SWMHD_example.jl:47-65): time, iteration, max|u|, max A, min h, wall
    time per interval. The report is one jitted call (compiled once) so a
    progress fire costs one device round trip, not ~10 eager ops."""
    last_wall = [time.perf_counter()]
    jitted = {}

    def cb(sim: Simulation):
        from . import diagnostics
        st = sim.state
        model = sim.model
        rep_fn = jitted.get("fn")
        if rep_fn is None:
            def _report(s):
                u, v = model.velocities(s)
                return diagnostics.extrema_report(u, v, s.h, s.A,
                                                  model.grid)
            rep_fn = jitted["fn"] = jax.jit(_report)
        rep = jax.device_get(rep_fn(st))
        now = time.perf_counter()
        logger.info(
            "Time: %12s, iteration: %d, max(|u|): %.2e, max(A): %.2e, "
            "min(h): %.2e, wall time: %s",
            prettytime(float(st.clock.time)), int(st.clock.iteration),
            float(rep["max_abs_u"]), float(rep["max_A"]),
            float(rep["min_h"]), prettytime(now - last_wall[0]))
        last_wall[0] = now

    return cb
