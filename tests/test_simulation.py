"""Simulation driver, schedules, writers, readers, checkpointing."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from swmhd_tpu import (
    Grid, ShallowWaterModel, FPlane, Centered2,
    Simulation, IterationInterval, TimeInterval, Callback,
    VECTOR_INVARIANT, CONSERVATIVE, diagnostics,
)
from swmhd_tpu.io import FieldWriter, ScalarWriter, FieldTimeSeries, ScalarTimeSeries
from swmhd_tpu import checkpoint

L = 10.0


def small_model():
    g = Grid.regular(32, 32, (-L / 2, L / 2), (-L / 2, L / 2),
                     dtype=jnp.float64)
    return ShallowWaterModel(
        grid=g, formulation=VECTOR_INVARIANT,
        momentum_advection=Centered2, mass_advection=Centered2,
        tracer_advection=Centered2, coriolis=FPlane(1.0))


def small_state(model):
    return model.initial_state(
        u=lambda x, y: 0.1 * jnp.sin(2 * jnp.pi * y / L),
        h=1.0, A=lambda x, y: 0.1 * jnp.exp(-(x**2 + y**2)))


class TestSchedules:
    def test_iteration_interval(self):
        s = IterationInterval(5)
        assert s.is_due(5, 0.0, 0.1) and s.is_due(10, 0.0, 0.1)
        assert not s.is_due(7, 0.0, 0.1)
        assert s.steps_until_due(7, 0.0, 0.1) == 3

    def test_time_interval(self):
        s = TimeInterval(0.5)
        dt = 0.1
        assert s.is_due(0, 0.0, dt)       # fires at t=0
        assert not s.is_due(1, 0.1, dt)
        assert s.steps_until_due(1, 0.1, dt) == 4
        assert s.is_due(5, 0.5, dt)
        assert s.is_due(10, 1.0, dt)


class TestRunLoop:
    def test_stop_time_and_callback_cadence(self):
        model = small_model()
        sim = Simulation(model, dt=0.01, stop_time=0.2)
        fired = []
        sim.callbacks["progress"] = Callback(
            fn=lambda s: fired.append(int(s.state.clock.iteration)),
            schedule=IterationInterval(5))
        out = sim.run(small_state(model))
        assert int(out.clock.iteration) == 20
        assert float(out.clock.time) == pytest.approx(0.2, abs=1e-9)
        assert fired == [0, 5, 10, 15, 20]

    def test_stop_iteration(self):
        model = small_model()
        sim = Simulation(model, dt=0.01, stop_iteration=7)
        out = sim.run(small_state(model))
        assert int(out.clock.iteration) == 7


class TestWriters:
    def test_field_writer_roundtrip(self, tmp_path):
        model = small_model()
        sim = Simulation(model, dt=0.01, stop_time=0.1)
        path = str(tmp_path / "fields")
        sim.output_writers["fields"] = FieldWriter(
            outputs={
                "A": lambda s: s.state.A,
                "speed": lambda s: jnp.sqrt(
                    s.state.u**2 + s.state.v**2),
            },
            schedule=TimeInterval(0.05), path=path)
        sim.run(small_state(model))
        ts = FieldTimeSeries(path, "A")
        assert len(ts) == 3  # t = 0, 0.05, 0.1
        assert ts[0].shape == (32, 32)
        np.testing.assert_allclose(ts.times, [0.0, 0.05, 0.1], atol=1e-9)
        stacked = ts.stack()
        assert stacked.shape == (3, 32, 32)

    def test_scalar_writer_roundtrip(self, tmp_path):
        model = small_model()
        sim = Simulation(model, dt=0.01, stop_time=0.05)
        h0 = jnp.ones((32, 32), jnp.float64)
        path = str(tmp_path / "energies.csv")
        sim.output_writers["energies"] = ScalarWriter(
            outputs={"total_energy": lambda s: diagnostics.energy_report(
                s.model, s.state, h0)["total_energy"]},
            schedule=IterationInterval(1), path=path)
        sim.run(small_state(model))
        ts = ScalarTimeSeries(path)
        assert len(ts.time) == 6  # 0..5 iterations inclusive
        assert np.all(np.isfinite(ts.total_energy))
        # energy roughly conserved on this smooth problem
        assert abs(ts.total_energy[-1] - ts.total_energy[0]) \
            < 0.01 * abs(ts.total_energy[0]) + 1e-12


class TestCheckpoint:
    def test_time_step_wizard(self):
        from swmhd_tpu import (Grid, ShallowWaterModel, Simulation,
                               Callback, IterationInterval, TimeStepWizard)
        import jax.numpy as jnp
        g = Grid.regular(32, 32, (0, 1), (0, 1), dtype=jnp.float64)
        model = ShallowWaterModel(grid=g, momentum_advection="centered2",
                                  mass_advection="centered2",
                                  tracer_advection="centered2",
                                  gravitational_acceleration=1.0)
        state = model.initial_state(h=1.0)
        # dt grossly over the wave CFL: wizard must shrink it
        sim = Simulation(model, dt=0.5, stop_iteration=4)
        sim.callbacks["wizard"] = Callback(
            TimeStepWizard(cfl=0.5, min_change=0.1),
            IterationInterval(1))
        sim.run(state)
        assert sim.dt < 0.5

    def test_save_restore_resume(self, tmp_path):
        model = small_model()
        state = small_state(model)
        import jax
        mid = jax.jit(model.step_fn(0.01, 5))(state)
        p = str(tmp_path / "ckpt.npz")
        checkpoint.save(p, mid, model.grid)
        back = checkpoint.restore(p, model.grid)
        np.testing.assert_array_equal(np.asarray(back.h), np.asarray(mid.h))
        assert int(back.clock.iteration) == 5
        # resume and compare against uninterrupted run
        full = jax.jit(model.step_fn(0.01, 10))(state)
        resumed = jax.jit(model.step_fn(0.01, 5))(back)
        np.testing.assert_allclose(np.asarray(resumed.h),
                                   np.asarray(full.h), rtol=1e-12)

    def test_resume_time_interval_writer_no_dup_no_skip(self, tmp_path):
        """TimeInterval is stateless (derived
        from the clock), so a checkpoint-resumed run fires exactly the
        events an uninterrupted run fires after the resume point — no
        duplicated and no missing snapshots."""
        def writer(path):
            return FieldWriter(outputs={"A": lambda s: s.state.A},
                               schedule=TimeInterval(0.1), path=str(path))

        # uninterrupted 0 -> 0.3
        model = small_model()
        sim = Simulation(model, dt=0.01, stop_time=0.3)
        sim.output_writers["f"] = writer(tmp_path / "full")
        sim.run(small_state(model))
        full = FieldTimeSeries(str(tmp_path / "full"), "A")
        np.testing.assert_allclose(full.times, [0.0, 0.1, 0.2, 0.3],
                                   atol=1e-9)

        # interrupted at 0.15 (not an event time), checkpointed, resumed
        model2 = small_model()
        sim1 = Simulation(model2, dt=0.01, stop_time=0.15)
        sim1.output_writers["f"] = writer(tmp_path / "part1")
        mid = sim1.run(small_state(model2))
        p = str(tmp_path / "ckpt.npz")
        checkpoint.save(p, mid, model2.grid)

        back = checkpoint.restore(p, model2.grid)
        sim2 = Simulation(model2, dt=0.01, stop_time=0.3)
        sim2.output_writers["f"] = writer(tmp_path / "part2")
        sim2.run(back)
        part2 = FieldTimeSeries(str(tmp_path / "part2"), "A")
        # first entry is the forced initial fire at the resume time;
        # everything after must be exactly the uninterrupted events > 0.15
        np.testing.assert_allclose(part2.times[0], 0.15, atol=1e-9)
        np.testing.assert_allclose(part2.times[1:], [0.2, 0.3], atol=1e-9)
        for k, t_idx in enumerate((2, 3)):  # full indices of t=0.2, 0.3
            np.testing.assert_allclose(
                np.asarray(part2[k + 1]), np.asarray(full[t_idx]),
                rtol=1e-12, atol=1e-14)

    def test_grid_mismatch_raises(self, tmp_path):
        model = small_model()
        p = str(tmp_path / "c.npz")
        checkpoint.save(p, small_state(model), model.grid)
        other = Grid.regular(16, 16, (0, 1), (0, 1))
        with pytest.raises(ValueError):
            checkpoint.restore(p, other)


def _lorentz_model(formulation, topology, N=32):
    from swmhd_tpu import (jacobian_lorentz_forcing,
                           divergence_lorentz_forcing)
    g = Grid.regular(N, N, (-L / 2, L / 2), (-L / 2, L / 2),
                     topology=topology, dtype=jnp.float64)
    forcing = (jacobian_lorentz_forcing() if formulation == VECTOR_INVARIANT
               else divergence_lorentz_forcing())
    model = ShallowWaterModel(grid=g, formulation=formulation,
                              coriolis=FPlane(1.0), forcing=forcing)
    state = model.initial_state(
        u=lambda x, y: 2 * y * jnp.exp(-(x**2 + y**2)),
        v=lambda x, y: -2 * x * jnp.exp(-(x**2 + y**2)),
        h=1.0,
        A=lambda x, y: 0.3 * jnp.exp(-((x - 0.5)**2 + y**2))
        - 0.3 * jnp.exp(-((x + 0.5)**2 + y**2)))
    return model, state


@pytest.mark.parametrize("formulation", [VECTOR_INVARIANT, CONSERVATIVE])
@pytest.mark.parametrize("topology", [("periodic", "periodic"),
                                      ("periodic", "bounded"),
                                      ("bounded", "bounded")])
def test_simulation_series_matches_step_fn(tmp_path, formulation, topology):
    """Simulation with an in-graph series writer == the model's step_fn
    called directly: final state, clock, and every series row (row 0 is
    the initial state)."""
    import jax
    from swmhd_tpu.io import ScalarSeriesWriter

    model, state = _lorentz_model(formulation, topology)
    h0 = state.h

    def diag(m, s):
        return {"te": diagnostics.energy_report(m, s, h0)["total_energy"]}

    n, dt = 5, 0.01
    sim = Simulation(model, dt=dt, stop_iteration=n)
    sim.output_writers["e"] = ScalarSeriesWriter(
        fn=diag, schedule=IterationInterval(1), path=str(tmp_path / "e.csv"))
    out = sim.run(state)

    ref, series = jax.jit(model.step_fn(
        dt, n, diagnostics=lambda s: diag(model, s)))(state)
    for name in ("h", "u", "v", "A"):
        np.testing.assert_allclose(np.asarray(getattr(out, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-12, atol=1e-14, err_msg=name)
    assert int(out.clock.iteration) == n
    assert float(out.clock.time) == pytest.approx(n * dt, abs=1e-12)
    rows = ScalarTimeSeries(str(tmp_path / "e.csv"))
    want = np.concatenate([[float(diag(model, state)["te"])],
                           np.asarray(series["te"])])
    np.testing.assert_allclose(rows.te, want, rtol=1e-12)
    np.testing.assert_array_equal(rows.iteration, np.arange(n + 1))


def test_step_fn_chunk_invariance():
    """step_fn(dt, 6) == step_fn(dt, 4) then step_fn(dt, 2) == three
    step_fn(dt, 2): the scan chunking the driver picks changes nothing."""
    import jax
    model, state = _lorentz_model(VECTOR_INVARIANT, ("periodic", "bounded"))
    dt = 0.01
    whole = jax.jit(model.step_fn(dt, 6))(state)
    two = jax.jit(model.step_fn(dt, 2))
    split = two(jax.jit(model.step_fn(dt, 4))(state))
    thirds = two(two(two(state)))
    for out in (split, thirds):
        for name in ("h", "u", "v", "A"):
            np.testing.assert_allclose(np.asarray(getattr(out, name)),
                                       np.asarray(getattr(whole, name)),
                                       rtol=1e-12, atol=1e-14,
                                       err_msg=name)
        assert int(out.clock.iteration) == 6
        assert float(out.clock.time) == pytest.approx(6 * dt, abs=1e-12)


class TestClockPrecision:
    """Clock.time is f64 independent of the grid dtype:
    under f32 production the forcing-hook contract
    (sw_mhd_jacobian_functions.jl:20-26's ``clock`` argument) must hand
    user forcings full-precision time, and in-graph time must not
    accumulate f32 drift (O(1e-2) absolute by t≈70 with t += dt)."""

    def _f32_model(self, forcing=()):
        g = Grid.regular(16, 16, (-L / 2, L / 2), (-L / 2, L / 2),
                         dtype=jnp.float32)
        return ShallowWaterModel(
            grid=g, momentum_advection=Centered2, mass_advection=Centered2,
            tracer_advection=Centered2, forcing=forcing)

    def test_clock_dtype_decoupled_from_grid_dtype(self):
        model = self._f32_model()
        state = model.initial_state(h=1.0)
        assert state.h.dtype == jnp.float32
        assert state.clock.time.dtype == jnp.float64

    def test_10k_steps_in_graph_time_matches_host_time(self):
        import jax
        model = self._f32_model()
        state = model.initial_state(h=1.0)
        dt = 0.013  # not exactly representable: accumulation must not drift
        n = 10_000
        out = jax.jit(model.step_fn(dt, n))(state)
        assert out.clock.time.dtype == jnp.float64
        assert abs(float(out.clock.time) - n * dt) < 1e-9
        assert int(out.clock.iteration) == n

    def test_10k_steps_f32_clock_has_no_drift(self):
        """x64-off production carries an f32 clock; the in-scan
        t0 + k*dt reconstruction must keep it within ~2 ulp of true
        (vs O(n*ulp) for += dt accumulation). Forced-f32 clock here."""
        import jax
        from swmhd_tpu.models.state import Clock
        model = self._f32_model()
        state = model.initial_state(h=1.0)
        state = state.replace(clock=Clock.zero(dtype=jnp.float32))
        dt = 0.013
        n = 10_000
        out = jax.jit(model.step_fn(dt, n))(state)
        true_t = n * dt  # 130.0
        assert abs(float(out.clock.time) - true_t) < 3e-5  # ~2 ulp(130)

    def test_forcing_receives_f64_time_under_f32_grid(self):
        import jax
        seen = {}

        def force_u(grid, clock, fields):
            seen["dtype"] = clock.time.dtype
            return jnp.zeros(grid.shape, grid.dtype)

        model = self._f32_model(forcing={"u": force_u})
        state = model.initial_state(h=1.0)
        jax.eval_shape(model.tendencies, state)
        assert seen["dtype"] == jnp.float64

    def test_checkpoint_roundtrip_preserves_f64_time(self, tmp_path):
        import jax
        model = self._f32_model()
        state = model.initial_state(h=1.0)
        state = jax.jit(model.step_fn(0.013, 7))(state)
        p = os.path.join(tmp_path, "c.npz")
        checkpoint.save(p, state, model.grid)
        back = checkpoint.restore(p, model.grid)
        assert back.clock.time.dtype == jnp.float64
        assert float(back.clock.time) == float(state.clock.time)
        assert back.h.dtype == jnp.float32


def test_field_series_refuses_mixed_snapshot_forms(tmp_path):
    """A store holding BOTH a single .npy and per-process slabs for one
    index is two runs' data mixed together — the reader must refuse to
    guess rather than silently serve the stale single file."""
    import json as _json
    d = os.path.join(tmp_path, "store")
    os.makedirs(os.path.join(d, "A"))
    np.save(os.path.join(d, "A", "000000.npy"), np.zeros((4, 4)))
    np.savez(os.path.join(d, "A", "000000.p00000.npz"),
             data=np.ones((4, 2)), bounds=np.array([0, 4, 0, 2]),
             shape=np.array([4, 4]))
    np.savez(os.path.join(d, "A", "000000.p00001.npz"),
             data=np.ones((4, 2)), bounds=np.array([0, 4, 2, 4]),
             shape=np.array([4, 4]))
    with open(os.path.join(d, "meta.json"), "w") as f:
        _json.dump({"times": [0.0], "iterations": [0],
                    "fields": ["A"], "grid": None}, f)
    ts = FieldTimeSeries(d, "A")
    with pytest.raises(RuntimeError, match="mixed"):
        ts[0]
    # slab-only store stitches fine
    os.remove(os.path.join(d, "A", "000000.npy"))
    np.testing.assert_array_equal(ts[0], np.ones((4, 4)))
