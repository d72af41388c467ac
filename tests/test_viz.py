"""Smoke tests for the visualisation layer.

viz.py reproduces the reference's artifact layouts (4-panel energy figure,
SWMHD_example.jl:135-165; two-panel A/speed movie, :106-130; quiver
verification figures, MHD_visualize.jl:79-98). These tests render each into
tmp_path via the matplotlib Agg backend so an import/API break turns red.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from swmhd_tpu import scenarios, diagnostics, viz
from swmhd_tpu.simulation import Simulation, IterationInterval
from swmhd_tpu.io import FieldWriter, ScalarSeriesWriter
from swmhd_tpu.simulation import TimeInterval


@pytest.fixture(scope="module")
def short_run(tmp_path_factory):
    """A 20-step scenario run with both writers attached."""
    outdir = str(tmp_path_factory.mktemp("run"))
    model, state, sc = scenarios.build("64x64_two_Gaussians_high_B",
                                       dtype=jnp.float64)
    h0 = state.h
    sim = Simulation(model, dt=0.01, stop_iteration=20)
    sim.output_writers["fields"] = FieldWriter(
        outputs={"A": lambda s: s.state.A,
                 "s": lambda s: jnp.sqrt(s.state.u ** 2)},
        schedule=TimeInterval(0.05),
        path=os.path.join(outdir, "fields"))
    sim.output_writers["energies"] = ScalarSeriesWriter(
        fn=lambda m, s: {k: v for k, v in
                         diagnostics.energy_report(m, s, h0).items()
                         if k in ("kinetic_energy", "magnetic_energy",
                                  "potential_energy", "total_energy")},
        schedule=IterationInterval(1),
        path=os.path.join(outdir, "energies.csv"))
    sim.run(state)
    return outdir, model, state


def test_render_energy_plot(short_run, tmp_path):
    outdir, _, _ = short_run
    png = viz.render_energy_plot(os.path.join(outdir, "energies.csv"),
                                 str(tmp_path / "energy.png"),
                                 title="smoke")
    assert os.path.getsize(png) > 10_000


def test_render_movie_frames(short_run, tmp_path):
    outdir, _, _ = short_run
    out = viz.render_movie(os.path.join(outdir, "fields"),
                           str(tmp_path / "movie.mp4"))
    # no ffmpeg in CI -> a directory of frames; with ffmpeg -> the mp4
    if os.path.isdir(out):
        frames = os.listdir(out)
        assert len(frames) >= 2
        assert all(f.endswith(".png") for f in frames)
    else:
        assert os.path.getsize(out) > 10_000


def test_render_field_verification(short_run, tmp_path):
    _, model, state = short_run
    paths = viz.render_field_verification(
        model.grid, state.A, state.h, str(tmp_path / "verify"))
    assert len(paths) == 2
    for p in paths:
        assert os.path.getsize(p) > 10_000


def test_render_scenario_outputs(short_run):
    outdir, _, _ = short_run
    made = viz.render_scenario_outputs(outdir, title="smoke")
    assert len(made) == 2
    assert os.path.exists(os.path.join(outdir, "energy_plot.png"))
