"""Worker for the 2-process multi-host CPU test (run by test_multihost.py).

Each process forces 2 CPU devices, joins a jax.distributed cluster over
localhost, builds the 2x2 mesh spanning both processes, runs a sharded
step, and checks its addressable shards against a locally-computed
single-device reference. Prints MULTIHOST-OK on success.

Usage: python tests/multihost_worker.py <process_id> <num_processes> <port>
"""

import os
import sys

proc_id, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=2")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from swmhd_tpu.parallel import multihost  # noqa: E402
from swmhd_tpu.parallel.decomposition import DomainDecomposition  # noqa: E402
from swmhd_tpu import scenarios  # noqa: E402


def main():
    multihost.initialize(coordinator_address=f"localhost:{port}",
                         num_processes=nproc, process_id=proc_id)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.local_devices()) == 2
    assert len(jax.devices()) == 2 * nproc

    mesh = multihost.make_pod_mesh((2, 2))
    assert mesh.shape == {"x": 2, "y": 2}

    model, state, _ = scenarios.build("64x64_two_Gaussians_high_B",
                                      dtype=jnp.float64)
    dd = DomainDecomposition(model, mesh)
    sharded = dd.shard_state(state)
    out = jax.jit(dd.step_fn(0.01, 5))(sharded)
    ref = jax.jit(model.step_fn(0.01, 5))(state)

    # every addressable shard must equal the single-device slice exactly
    for name in ("h", "u", "v", "A"):
        garr = getattr(out, name)
        want = np.asarray(getattr(ref, name))
        n_checked = 0
        for shard in garr.addressable_shards:
            np.testing.assert_allclose(np.asarray(shard.data),
                                       want[shard.index],
                                       rtol=1e-12, atol=1e-13,
                                       err_msg=f"{name} shard {shard.index}")
            n_checked += 1
        assert n_checked == 2, n_checked  # 2 local devices

    # host-local I/O slab covers exactly this process's shards
    (x0, x1), (y0, y1) = multihost.process_local_slab(mesh, 64, 64)
    assert 0 <= x0 < x1 <= 64 and 0 <= y0 < y1 <= 64
    area = (x1 - x0) * (y1 - y0)
    assert area == 64 * 64 // nproc, (area, nproc)

    # sharded checkpoint: save -> restore -> resume == uninterrupted,
    # with each process writing/reading only its own slab (the M5
    # recovery story across processes)
    import tempfile
    from swmhd_tpu import checkpoint
    ckdir = os.path.join(tempfile.gettempdir(), f"swmhd_mh_ckpt_{port}")
    checkpoint.save_sharded(ckdir, out, model.grid, mesh)
    back = checkpoint.restore_sharded(ckdir, model.grid, mesh)
    assert int(back.clock.iteration) == 5
    resumed = jax.jit(dd.step_fn(0.01, 5))(back)
    full = jax.jit(model.step_fn(0.01, 10))(state)
    for name in ("h", "u", "v", "A"):
        want = np.asarray(getattr(full, name))
        for shard in getattr(resumed, name).addressable_shards:
            np.testing.assert_allclose(
                np.asarray(shard.data), want[shard.index],
                rtol=1e-12, atol=1e-13,
                err_msg=f"resumed {name} shard {shard.index}")

    # restore into a DIFFERENT mesh layout (the relayout tolerance
    # restore_sharded documents): the (2,2) checkpoint re-read on a
    # (4,1) mesh must reproduce the same global state — each process
    # reads whichever slabs overlap its new shards (shared tmp FS here)
    mesh41 = multihost.make_pod_mesh((4, 1))
    dd41 = DomainDecomposition(model, mesh41)
    back41 = checkpoint.restore_sharded(ckdir, model.grid, mesh41)
    for name in ("h", "u", "v", "A"):
        full_want = np.asarray(getattr(ref, name))
        for shard in getattr(back41, name).addressable_shards:
            np.testing.assert_allclose(
                np.asarray(shard.data), full_want[shard.index],
                rtol=1e-12, atol=1e-13,
                err_msg=f"relayout {name} shard {shard.index}")
    resumed41 = jax.jit(dd41.step_fn(0.01, 5))(back41)
    for name in ("h", "u", "v", "A"):
        want = np.asarray(getattr(full, name))
        for shard in getattr(resumed41, name).addressable_shards:
            np.testing.assert_allclose(
                np.asarray(shard.data), want[shard.index],
                rtol=1e-12, atol=1e-13,
                err_msg=f"relayout-resumed {name} shard {shard.index}")

    # multi-process FieldWriter: drive a sharded
    # Simulation with field snapshots — each process writes only its own
    # slab (no gather), the reader stitches them back to the global field
    from swmhd_tpu.simulation import Simulation, IterationInterval
    from swmhd_tpu.io import FieldWriter
    from swmhd_tpu.io.readers import FieldTimeSeries

    outdir = os.path.join(tempfile.gettempdir(), f"swmhd_mh_fields_{port}")
    sim = Simulation(model, dt=0.01, stop_iteration=4, stepper=dd)
    sim.output_writers["fields"] = FieldWriter(
        outputs={"A": lambda s: s.state.A, "h": lambda s: s.state.h},
        schedule=IterationInterval(2), path=outdir)
    sim.run(sharded)  # close() ends with a cross-process barrier

    full4 = jax.jit(model.step_fn(0.01, 4))(state)
    if proc_id == 0:
        for name in ("A", "h"):
            ts = FieldTimeSeries(outdir, name)
            assert len(ts) == 3, len(ts)  # iterations 0, 2, 4
            np.testing.assert_allclose(
                ts[0], np.asarray(getattr(state, name)),
                rtol=1e-12, atol=1e-13, err_msg=f"{name} snapshot 0")
            np.testing.assert_allclose(
                ts[-1], np.asarray(getattr(full4, name)),
                rtol=1e-12, atol=1e-13, err_msg=f"{name} snapshot -1")
            # the snapshots really are per-process slabs, not gathers
            import glob
            assert glob.glob(os.path.join(outdir, name, "000000.p*.npz"))
            assert not glob.glob(os.path.join(outdir, name, "000000.npy"))

    print("MULTIHOST-OK", flush=True)


if __name__ == "__main__":
    main()
