"""Profiling utilities + multihost helpers (single-process smoke tests)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from swmhd_tpu import Grid, ShallowWaterModel, FPlane
from swmhd_tpu.profiling import benchmark_step, StepBenchmark
from swmhd_tpu.parallel import make_mesh, process_local_slab


def test_benchmark_step_counts():
    g = Grid.regular(32, 32, (0, 1), (0, 1), dtype=jnp.float64)
    model = ShallowWaterModel(grid=g, momentum_advection="centered2",
                              mass_advection="centered2",
                              tracer_advection="centered2")
    state = model.initial_state(h=1.0)
    step = jax.jit(model.step_fn(1e-3, 2))
    bench = benchmark_step(step, state, n_steps_per_call=2, n_calls=3)
    assert isinstance(bench, StepBenchmark)
    assert bench.n_steps == 6
    assert bench.grid_points == 32 * 32
    assert bench.points_per_s > 0
    assert "pts/s" in str(bench)


def test_process_local_slab_single_process():
    mesh = make_mesh(shape=(2, 2))
    (x0, x1), (y0, y1) = process_local_slab(mesh, 16, 16)
    # single process owns everything
    assert (x0, x1) == (0, 16)
    assert (y0, y1) == (0, 16)


def test_measure_overlap_tooling():
    """The BASELINE 'overlap % tracked' metric has a runnable
    implementation: profile the sharded step on the
    CPU fake mesh and get well-formed comm/compute/overlap stats out of
    the Perfetto trace. On CPU the number is thread-level (collectives
    appear as rendezvous events) — the assertion is on tooling shape,
    not on an overlap value only real hardware can produce."""
    import jax
    import jax.numpy as jnp
    from swmhd_tpu import (Grid, ShallowWaterModel, FPlane,
                           VECTOR_INVARIANT)
    from swmhd_tpu.parallel import DomainDecomposition, make_mesh
    from swmhd_tpu.profiling import measure_overlap

    if len(jax.devices()) < 4:
        import pytest
        pytest.skip("needs the virtual device mesh")
    g = Grid.regular(64, 64, (-5, 5), (-5, 5), dtype=jnp.float64)
    model = ShallowWaterModel(grid=g, formulation=VECTOR_INVARIANT,
                              coriolis=FPlane(1.0))
    state = model.initial_state(h=1.0,
                                A=lambda x, y: jnp.exp(-(x**2 + y**2)))
    dd = DomainDecomposition(model, make_mesh(shape=(2, 2)))
    step = dd.step_fn(1e-3, 2)
    ov = measure_overlap(step, dd.shard_state(state))
    assert ov.get("error") is None or "error" not in ov, ov
    assert ov["n_comm_events"] > 0, ov
    assert ov["n_compute_events"] > 0, ov
    assert ov["comm_ms"] >= 0 and ov["compute_ms"] > 0, ov
    assert ov["overlap_pct"] is None or 0 <= ov["overlap_pct"] <= 100, ov


def test_device_peaks_h100_sxm():
    """The H100 SXM resolves to its published peaks, and the analytic step
    is bound by float32 compute there (34 flop/B > ~20 flop/B balance)."""
    import bench
    from swmhd_tpu.profiling import device_peaks

    peaks = device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks.f32_flops_per_s == 67e12
    assert peaks.hbm_bytes_per_s == 3.35e12
    assert "data sheet" in peaks.source
    rate, binding = bench.roofline_points_per_s("NVIDIA H100 80GB HBM3")
    assert binding == "f32 compute"
    assert rate == 67e12 / bench.ANALYTIC_FLOPS_PER_POINT


@pytest.mark.parametrize("kind", ["NVIDIA H100 PCIe", "cpu",
                                  "NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100 80GB HBM3 "])
def test_device_peaks_unknown_kind_raises(kind):
    """No peak is assumed for a kind not in the table: the PCIe H100 has
    other peaks, and matching is exact (no substring fallback)."""
    from swmhd_tpu.profiling import device_peaks

    with pytest.raises(ValueError, match="no published peaks"):
        device_peaks(kind)


def test_compile_cache_env_set_changes_nothing(monkeypatch, tmp_path):
    from swmhd_tpu import runtime

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert runtime.configure_compile_cache() == str(tmp_path / "c")
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "c").exists()


def test_compile_cache_env_unset_uses_checkout(monkeypatch):
    import os
    from swmhd_tpu import runtime

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.configure_compile_cache()
    assert path == os.path.join(runtime.CHECKOUT, ".jax_cache")
    assert os.path.isfile(os.path.join(runtime.CHECKOUT, "chip_smoke.py"))
    assert jax.config.jax_compilation_cache_dir == path
    assert os.path.isdir(path)
