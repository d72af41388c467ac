"""The chip check (chip_smoke.py) and the benchmark's device gate.

On the CPU: both entry points refuse to run, and each phase function of
chip_smoke runs at a small size with the CPU standing in for the GPU.
Marked ``gpu``: phases 2 and 3 on the card (phase 3 at 256²).
"""

import jax
import numpy as np
import pytest

import bench
import chip_smoke

FORMULATIONS = ["vector_invariant", "conservative"]


def test_bench_refuses_cpu(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        bench.main()
    assert capsys.readouterr().out == ""


def test_chip_smoke_refuses_cpu(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("key", sorted(chip_smoke.REGRESSION_CASES))
def test_regression_drift_on_cpu(key):
    """Phase 2's f32 run against the float64 fixtures, on the CPU."""
    drift = chip_smoke.regression_drift(key, jax.devices()[0])
    assert sorted(drift) == sorted(chip_smoke.FIELDS)
    for name, (d, bound) in drift.items():
        assert 0 < d <= bound, (name, d, bound)


@pytest.mark.parametrize("formulation", FORMULATIONS)
def test_compare_step_at_32(formulation):
    """Phase 3 at 32², the CPU on both sides: identical results, no matrix
    product in the compiled program, a memory analysis and a rate."""
    cpu = jax.devices()[0]
    r = chip_smoke.compare_step(formulation, cpu, cpu, N=32, n_steps=2,
                                chunks=2)
    for name, (max_abs, max_rel) in r["errors"].items():
        assert max_rel <= chip_smoke.STEP_RTOL, name
    assert r["matmul_ops"] == []
    assert r["memory"]["argument_size_in_bytes"] > 0
    assert len(r["chunk_s"]) == 2 and r["points_per_s"] > 0


def test_matmul_pattern():
    pat = chip_smoke._MATMUL
    assert pat.search("%dot.3 = f32[4,4] dot(f32[4,4] %a, f32[4,4] %b)")
    assert pat.search('custom_call_target="__cublas$gemm"')
    assert pat.search("convolution(%x, %w)")
    assert not pat.search("%dot.3 = f32[4] fusion(%a), kind=kLoop")


def test_cli_roundtrip_on_cpu(tmp_path):
    """Phase 4 on the smallest walled scenario: run, checkpoint, resume."""
    chip_smoke.cli_roundtrip(print, str(tmp_path), "64x64_low_B_low_U",
                             stop=0.1, resume_stop=0.15, checkpoint_every=4)


@pytest.mark.parametrize("formulation, name", [
    ("vector_invariant", "64x64_two_Gaussians_high_B"),
    ("conservative", "64x64_low_B_low_U")])
def test_anchor_checks_initial_energies(tmp_path, formulation, name):
    """Phase 5's run and judge, cut to 5 steps: the initial-energy anchors
    are pure functions of the pinned ICs and must already hold."""
    got, checks = chip_smoke.anchor_checks(formulation, name, str(tmp_path),
                                           stop=0.05)
    assert set(checks) == {"me0", "ke0", "ke_end", "me_end", "dev_max"}
    assert checks["me0"] and checks["ke0"], got


def test_four_card_errors_on_cpu_mesh():
    """The four-card phase at 48² on four of the virtual CPU devices: the
    sharded step (2x2 periodic, 4x1 walls in y; overlap off and on)
    agrees with the single-device step."""
    errors = chip_smoke.four_card_errors(N=48, n_steps=1)
    assert len(errors) == 4
    for case, per_field in errors.items():
        for name, (max_abs, max_rel) in per_field.items():
            assert max_rel <= chip_smoke.STEP_RTOL, (case, name)


@pytest.mark.gpu
@pytest.mark.parametrize("key", sorted(chip_smoke.REGRESSION_CASES))
def test_gpu_regression_drift(gpu_device, key):
    for name, (d, bound) in chip_smoke.regression_drift(
            key, gpu_device).items():
        assert d <= bound, (name, d, bound)


@pytest.mark.gpu
@pytest.mark.parametrize("formulation", FORMULATIONS)
def test_gpu_step_matches_cpu_at_256(gpu_device, formulation):
    r = chip_smoke.compare_step(formulation, gpu_device,
                                jax.devices("cpu")[0], N=256)
    assert r["matmul_ops"] == []
    for name, (max_abs, max_rel) in r["errors"].items():
        assert np.isfinite(max_rel) and max_rel <= chip_smoke.STEP_RTOL, (
            name, max_abs, max_rel)
