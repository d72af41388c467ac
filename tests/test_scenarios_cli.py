"""Scenario registry, in-graph scalar series, and CLI end-to-end on CPU."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from swmhd_tpu import (
    scenarios, diagnostics, Simulation, IterationInterval,
    VECTOR_INVARIANT, CONSERVATIVE)
from swmhd_tpu.io import ScalarSeriesWriter


def test_registry_has_all_reference_scenarios():
    """The 6 recorded reference scenarios (SURVEY §2.1 C9) plus the two
    canonical driver configurations must exist."""
    names = scenarios.names()
    for N in (64, 128):
        for tag in ("two_Gaussians_low_B", "two_Gaussians_high_B",
                    "low_B_low_U"):
            assert f"{N}x{N}_{tag}" in names
    assert "adjustment_jacobian" in names
    assert "adjustment_divergence" in names


@pytest.mark.parametrize("formulation", [VECTOR_INVARIANT, CONSERVATIVE])
def test_build_every_scenario(formulation):
    for name in scenarios.names():
        model, state, sc = scenarios.build(name, formulation,
                                           dtype=jnp.float64)
        assert state.h.shape == (sc.N, sc.N)
        assert float(jnp.min(state.h)) > 0


def test_unknown_scenario_message():
    with pytest.raises(KeyError, match="available:"):
        scenarios.get("nope")


def test_in_graph_scalar_series(tmp_path):
    """ScalarSeriesWriter rows must equal eagerly recomputed diagnostics at
    every iteration (the in-graph series is exact, not sampled)."""
    model, state, sc = scenarios.build("64x64_two_Gaussians_low_B",
                                      dtype=jnp.float64)
    h0 = state.h
    path = os.path.join(tmp_path, "energies.csv")

    def fn(m, s):
        rep = diagnostics.energy_report(m, s, h0)
        return {"total_energy": rep["total_energy"],
                "kinetic_energy": rep["kinetic_energy"]}

    sim = Simulation(model, dt=0.01, stop_iteration=7)
    sim.output_writers["e"] = ScalarSeriesWriter(
        fn=fn, schedule=IterationInterval(1), path=path)
    final = sim.run(state)

    with open(path) as f:
        rows = list(csv.DictReader(f))
    assert [int(r["iteration"]) for r in rows] == list(range(8))

    # last row must match an eager recomputation from the final state
    rep = jax.jit(lambda s: fn(model, s))(final)
    assert float(rows[-1]["total_energy"]) == pytest.approx(
        float(rep["total_energy"]), rel=1e-12)
    assert float(rows[-1]["kinetic_energy"]) == pytest.approx(
        float(rep["kinetic_energy"]), rel=1e-12)


def test_series_subsampling(tmp_path):
    model, state, _ = scenarios.build("64x64_low_B_low_U",
                                      dtype=jnp.float64)
    path = os.path.join(tmp_path, "e.csv")
    sim = Simulation(model, dt=0.01, stop_iteration=9)
    sim.output_writers["e"] = ScalarSeriesWriter(
        fn=lambda m, s: {"mass": jnp.sum(s.h)},
        schedule=IterationInterval(3), path=path)
    sim.run(state)
    with open(path) as f:
        rows = list(csv.DictReader(f))
    assert [int(r["iteration"]) for r in rows] == [0, 3, 6, 9]


def test_cli_run_smoke(tmp_path, monkeypatch):
    """Drive the CLI main() end-to-end on CPU: outputs, checkpoint,
    final state, resumability."""
    from swmhd_tpu import cli

    outdir = os.path.join(tmp_path, "run")
    cli.main(["run", "64x64_low_B_low_U", "--stop-time", "0.05",
              "--outdir", outdir, "--checkpoint-every", "3",
              "--progress-every", "2"])
    assert os.path.isfile(os.path.join(outdir, "final.npz"))
    assert os.path.isfile(os.path.join(outdir, "checkpoint.npz"))
    with open(os.path.join(outdir, "energies.csv")) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 6  # iterations 0..5 at dt=0.01
    assert os.path.isdir(os.path.join(outdir, "fields", "A"))

    outdir2 = os.path.join(tmp_path, "resumed")
    cli.main(["run", "64x64_low_B_low_U", "--stop-time", "0.08",
              "--outdir", outdir2,
              "--resume", os.path.join(outdir, "checkpoint.npz")])
    assert os.path.isfile(os.path.join(outdir2, "final.npz"))
