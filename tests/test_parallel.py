"""Distributed correctness: sharded == single-device (SURVEY §4e).

Runs on the 8-virtual-CPU-device mesh from conftest — the fake-backend
substitute for several GPUs. Agreement of the shard_map + ppermute halo
path with the global roll path is this framework's race-detector analog.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from swmhd_tpu import (
    Grid, ShallowWaterModel, FPlane,
    VECTOR_INVARIANT, CONSERVATIVE,
    jacobian_lorentz_forcing, divergence_lorentz_forcing,
)
from swmhd_tpu.parallel import DomainDecomposition, make_mesh

L = 10.0


def build(formulation, N=64):
    g = Grid.regular(N, N, (-L / 2, L / 2), (-L / 2, L / 2),
                     dtype=jnp.float64)
    forcing = (jacobian_lorentz_forcing()
               if formulation == VECTOR_INVARIANT
               else divergence_lorentz_forcing())
    model = ShallowWaterModel(
        grid=g, formulation=formulation, coriolis=FPlane(1.0),
        forcing=forcing)
    state = model.initial_state(
        u=lambda x, y: 5 * y * jnp.exp(-(x**2 + y**2)),
        v=lambda x, y: -5 * x * jnp.exp(-(x**2 + y**2)),
        h=lambda x, y: 1.0 + 0.05 * jnp.exp(-(x**2 + y**2)),
        A=lambda x, y: 0.5 * jnp.exp(-((x - 0.5)**2 + y**2))
        - 0.5 * jnp.exp(-((x + 0.5)**2 + y**2)))
    return model, state


@pytest.mark.parametrize("formulation", [VECTOR_INVARIANT, CONSERVATIVE])
@pytest.mark.parametrize("mesh_shape", [(2, 4), (8, 1)])
def test_sharded_matches_single_device(formulation, mesh_shape):
    n_dev = mesh_shape[0] * mesh_shape[1]
    if len(jax.devices()) < n_dev:
        pytest.skip("not enough virtual devices")
    model, state = build(formulation)
    n_steps = 10
    dt = 0.01

    ref = jax.jit(model.step_fn(dt, n_steps))(state)

    mesh = make_mesh(shape=mesh_shape)
    dd = DomainDecomposition(model, mesh)
    sharded0 = dd.shard_state(state)
    out = dd.step_fn(dt, n_steps)(sharded0)

    for name in ("h", "u", "v", "A"):
        a = np.asarray(getattr(ref, name))
        b = np.asarray(jax.device_get(getattr(out, name)))
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12,
                                   err_msg=f"{name} mismatch {mesh_shape}")
    assert float(out.clock.time) == pytest.approx(float(ref.clock.time))
    assert int(out.clock.iteration) == int(ref.clock.iteration)


@pytest.mark.parametrize("formulation", [VECTOR_INVARIANT, CONSERVATIVE])
def test_overlap_matches_single_device(formulation):
    """The comm/compute-overlap split (interior from unpadded tile + edge
    bands from the exchanged pad) must agree exactly with the global path."""
    if len(jax.devices()) < 4:
        pytest.skip("not enough virtual devices")
    model, state = build(formulation, N=64)
    n_steps = 5
    dt = 0.01

    ref = jax.jit(model.step_fn(dt, n_steps))(state)

    mesh = make_mesh(shape=(2, 2))
    dd = DomainDecomposition(model, mesh, overlap=True)
    out = dd.step_fn(dt, n_steps)(dd.shard_state(state))

    for name in ("h", "u", "v", "A"):
        a = np.asarray(getattr(ref, name))
        b = np.asarray(jax.device_get(getattr(out, name)))
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12,
                                   err_msg=f"{name} mismatch (overlap)")


def build_bounded(formulation, topology, N=64):
    g = Grid.regular(N, N, (-L / 2, L / 2), (-L / 2, L / 2),
                     topology=topology, dtype=jnp.float64)
    forcing = (jacobian_lorentz_forcing()
               if formulation == VECTOR_INVARIANT
               else divergence_lorentz_forcing())
    model = ShallowWaterModel(
        grid=g, formulation=formulation, coriolis=FPlane(1.0),
        forcing=forcing)
    state = model.initial_state(
        u=lambda x, y: 5 * y * jnp.exp(-(x**2 + y**2)),
        v=lambda x, y: -5 * x * jnp.exp(-(x**2 + y**2)),
        h=lambda x, y: 1.0 + 0.05 * jnp.exp(-(x**2 + y**2)),
        A=lambda x, y: 0.5 * jnp.exp(-((x - 0.5)**2 + y**2))
        - 0.5 * jnp.exp(-((x + 0.5)**2 + y**2)))
    return model, state


@pytest.mark.parametrize("formulation", [VECTOR_INVARIANT, CONSERVATIVE])
@pytest.mark.parametrize("topology", [("periodic", "bounded"),
                                      ("bounded", "bounded")])
def test_sharded_bounded_matches_single_device(formulation, topology):
    """BOUNDED walls under shard_map: the IndexContext machinery must make
    wall masks / flux zeroing / near-wall stencil degradation act at the
    global walls on edge shards only (reference behavior preserved:
    sw_mhd_divergence_functions.jl:42-57)."""
    if len(jax.devices()) < 4:
        pytest.skip("not enough virtual devices")
    model, state = build_bounded(formulation, topology)
    n_steps = 10
    dt = 0.005

    ref = jax.jit(model.step_fn(dt, n_steps))(state)

    mesh = make_mesh(shape=(2, 2))
    dd = DomainDecomposition(model, mesh)
    out = dd.step_fn(dt, n_steps)(dd.shard_state(state))

    for name in ("h", "u", "v", "A"):
        a = np.asarray(getattr(ref, name))
        b = np.asarray(jax.device_get(getattr(out, name)))
        np.testing.assert_allclose(
            b, a, rtol=1e-12, atol=1e-12,
            err_msg=f"{name} mismatch ({formulation}, {topology})")


@pytest.mark.parametrize("topology", [("periodic", "bounded"),
                                      ("bounded", "bounded")])
def test_sharded_bounded_overlap_matches_single_device(topology):
    """Bounded walls + comm/compute overlap split: the edge bands carry
    their own global-index origins."""
    if len(jax.devices()) < 4:
        pytest.skip("not enough virtual devices")
    model, state = build_bounded(VECTOR_INVARIANT, topology)
    n_steps = 5
    dt = 0.005

    ref = jax.jit(model.step_fn(dt, n_steps))(state)

    mesh = make_mesh(shape=(2, 2))
    dd = DomainDecomposition(model, mesh, overlap=True)
    out = dd.step_fn(dt, n_steps)(dd.shard_state(state))

    for name in ("h", "u", "v", "A"):
        a = np.asarray(getattr(ref, name))
        b = np.asarray(jax.device_get(getattr(out, name)))
        np.testing.assert_allclose(
            b, a, rtol=1e-12, atol=1e-12,
            err_msg=f"{name} mismatch (overlap, {topology})")


def test_sharded_bounded_conserves_mass():
    """A closed basin must not leak mass through walls when sharded."""
    if len(jax.devices()) < 4:
        pytest.skip("not enough virtual devices")
    model, state = build_bounded(CONSERVATIVE, ("bounded", "bounded"))
    mesh = make_mesh(shape=(2, 2))
    dd = DomainDecomposition(model, mesh)
    out = dd.step_fn(0.005, 20)(dd.shard_state(state))
    m0 = float(jnp.sum(state.h))
    m1 = float(jnp.sum(jax.device_get(out.h)))
    assert m1 == pytest.approx(m0, rel=1e-13)


def test_sharded_simulation_with_series(tmp_path):
    """Simulation driving a DomainDecomposition stepper: per-step in-graph
    energy series must match the single-device Simulation exactly."""
    import csv
    import os
    from swmhd_tpu import Simulation, IterationInterval, diagnostics
    from swmhd_tpu.io import ScalarSeriesWriter

    if len(jax.devices()) < 4:
        pytest.skip("not enough virtual devices")
    model, state = build(VECTOR_INVARIANT, N=32)
    h0 = state.h

    def diag(m, s):
        rep = diagnostics.energy_report(m, s, h0)
        return {"total_energy": rep["total_energy"]}

    def run(stepper, state, path):
        sim = Simulation(model, dt=0.01, stop_iteration=6, stepper=stepper)
        sim.output_writers["e"] = ScalarSeriesWriter(
            fn=diag, schedule=IterationInterval(1), path=path)
        sim.run(state)
        with open(path) as f:
            return [(int(r["iteration"]), float(r["total_energy"]))
                    for r in csv.DictReader(f)]

    ref_rows = run(None, state, os.path.join(tmp_path, "single.csv"))

    mesh = make_mesh(shape=(2, 2))
    dd = DomainDecomposition(model, mesh, halo=6)
    dd_rows = run(dd, dd.shard_state(state),
                  os.path.join(tmp_path, "sharded.csv"))

    assert [i for i, _ in dd_rows] == [i for i, _ in ref_rows]
    for (_, a), (_, b) in zip(dd_rows, ref_rows):
        assert a == pytest.approx(b, rel=1e-12)


def test_halo_pad_roundtrip():
    """Padding then cropping is the identity; the pad ring equals the
    periodic wrap of the global field."""
    model, state = build(VECTOR_INVARIANT, N=32)
    mesh = make_mesh(shape=(2, 2))
    dd = DomainDecomposition(model, mesh, halo=6)

    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    f = shard_map(lambda a: dd._crop(dd._pad(a)), mesh=mesh,
                  in_specs=P("x", "y"), out_specs=P("x", "y"))
    arr = dd.shard_state(state).h
    out = f(arr)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(state.h))


def test_halo_pad_matches_global_roll():
    """Each padded tile's halo must equal the corresponding slice of the
    globally rolled array."""
    N = 16
    g = Grid.regular(N, N, (0, 1), (0, 1), dtype=jnp.float64)
    model = ShallowWaterModel(grid=g)
    rng = np.random.default_rng(3)
    glob = jnp.asarray(rng.standard_normal((N, N)))
    mesh = make_mesh(shape=(2, 2))
    dd = DomainDecomposition(model, mesh, halo=2)

    from jax import shard_map
    from jax.sharding import PartitionSpec as P, NamedSharding

    padded = shard_map(dd._pad, mesh=mesh, in_specs=P("x", "y"),
                       out_specs=P("x", "y"))(
        jax.device_put(glob, NamedSharding(mesh, P("x", "y"))))
    # device (0,0) tile with halo==2 should equal glob[-2:6, -2:6] wrapped
    H, nx, ny = 2, N // 2, N // 2
    tile00 = np.asarray(padded)[0:nx + 2 * H, 0:ny + 2 * H]
    want = np.asarray(jnp.roll(glob, (H, H), axis=(0, 1)))[
        0:nx + 2 * H, 0:ny + 2 * H]
    np.testing.assert_array_equal(tile00, want)


def test_sharded_checkpoint_roundtrip(tmp_path):
    """save_sharded -> restore_sharded -> resume == uninterrupted on the
    8-device mesh (single process; the 2-process variant runs in
    tests/multihost_worker.py). Completes M5's recovery story."""
    from swmhd_tpu import checkpoint
    model, state = build(VECTOR_INVARIANT)
    dt = 0.01
    mesh = make_mesh(shape=(2, 4))
    dd = DomainDecomposition(model, mesh)
    mid = dd.step_fn(dt, 5)(dd.shard_state(state))

    ckdir = str(tmp_path / "ck")
    checkpoint.save_sharded(ckdir, mid, model.grid, mesh)
    back = checkpoint.restore_sharded(ckdir, model.grid, mesh)
    assert int(back.clock.iteration) == 5
    for name in ("h", "u", "v", "A"):
        np.testing.assert_array_equal(
            np.asarray(jax.device_get(getattr(back, name))),
            np.asarray(jax.device_get(getattr(mid, name))), err_msg=name)

    resumed = dd.step_fn(dt, 5)(back)
    full = jax.jit(model.step_fn(dt, 10))(state)
    for name in ("h", "u", "v", "A"):
        np.testing.assert_allclose(
            np.asarray(jax.device_get(getattr(resumed, name))),
            np.asarray(getattr(full, name)),
            rtol=1e-12, atol=1e-12, err_msg=f"resumed {name}")

    # restore under a DIFFERENT mesh layout still assembles correctly
    mesh2 = make_mesh(shape=(4, 2))
    back2 = checkpoint.restore_sharded(ckdir, model.grid, mesh2)
    for name in ("h", "u", "v", "A"):
        np.testing.assert_array_equal(
            np.asarray(jax.device_get(getattr(back2, name))),
            np.asarray(jax.device_get(getattr(mid, name))),
            err_msg=f"relayout {name}")


@pytest.mark.parametrize("n, shape", [(1, (1, 1)), (2, (1, 2)),
                                      (4, (2, 2)), (8, (2, 4))])
def test_make_mesh_order_and_shape(n, shape):
    """make_mesh lays the first n devices out row-major in jax.devices()
    order, in the squarest factorisation; make_pod_mesh is the same
    factory."""
    from swmhd_tpu.parallel import multihost

    mesh = make_mesh(n_devices=n)
    assert mesh.axis_names == ("x", "y")
    assert (mesh.shape["x"], mesh.shape["y"]) == shape
    want = np.asarray(jax.devices()[:n]).reshape(shape)
    assert np.array_equal(np.asarray(mesh.devices), want)
    pod = multihost.make_pod_mesh(shape)
    assert np.array_equal(np.asarray(pod.devices), want)


@pytest.mark.parametrize("formulation", [VECTOR_INVARIANT, CONSERVATIVE])
def test_sharded_series_bounded_y_matches_single_device(formulation):
    """step_fn with a diagnostics series on a 2x2 mesh with walls in y:
    final state AND per-step series equal the single-device step's."""
    from swmhd_tpu import diagnostics

    model, state = build_bounded(formulation, ("periodic", "bounded"),
                                 N=32)
    h0 = state.h

    def diag(s):
        rep = diagnostics.energy_report(model, s, h0)
        return {"total_energy": rep["total_energy"],
                "mass": jnp.sum(s.h)}

    n_steps, dt = 4, 0.005
    ref, ref_series = jax.jit(model.step_fn(dt, n_steps,
                                            diagnostics=diag))(state)
    dd = DomainDecomposition(model, make_mesh(shape=(2, 2)))
    out, series = dd.step_fn(dt, n_steps, diagnostics=diag)(
        dd.shard_state(state))
    for name in ("h", "u", "v", "A"):
        np.testing.assert_allclose(
            np.asarray(jax.device_get(getattr(out, name))),
            np.asarray(getattr(ref, name)), rtol=1e-12, atol=1e-12,
            err_msg=name)
    for key in ("total_energy", "mass"):
        assert np.asarray(series[key]).shape == (n_steps,)
        np.testing.assert_allclose(np.asarray(series[key]),
                                   np.asarray(ref_series[key]),
                                   rtol=1e-12, err_msg=key)
    assert int(out.clock.iteration) == n_steps
