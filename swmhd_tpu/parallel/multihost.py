"""Multi-process execution (SURVEY §7.2 M5; reference has nothing multi-node).

With several processes every process runs the same program;
:func:`initialize` wires them into one JAX runtime, and the existing
:class:`~swmhd_tpu.parallel.decomposition.DomainDecomposition` then spans
all processes' devices through the same ``Mesh`` + ``ppermute`` machinery
(NCCL between GPUs). The mesh lays devices out in ``jax.devices()`` order,
which groups each process's devices together.

Host-local I/O: each process owns the shards resident on its devices;
:func:`process_local_slab` gives the global index range a process should
write, so FieldWriter outputs can be sharded per process without gathers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh

from .decomposition import AXIS_X, AXIS_Y


def initialize(coordinator_address: str, num_processes: int,
               process_id: int) -> None:
    """``jax.distributed.initialize`` for one process of ``num_processes``.

    Nothing discovers a cluster on its own, so all three arguments are
    required; ``coordinator_address`` is ``host:port`` of process 0."""
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def make_pod_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """A 2-D ('x','y') mesh over ALL processes' devices — the same
    factory as ``decomposition.make_mesh``, so CLI, bench, dry run and
    multi-process runs share one mesh layout."""
    from .decomposition import make_mesh

    return make_mesh(shape=shape)


def process_local_slab(mesh: Mesh, Nx: int, Ny: int):
    """((x0, x1), (y0, y1)) global index bounds of the region whose shards
    live on this process — the slab this host writes during sharded I/O."""
    nx = Nx // mesh.shape[AXIS_X]
    ny = Ny // mesh.shape[AXIS_Y]
    dev = np.asarray(mesh.devices)
    mine = np.array([[d.process_index == jax.process_index()
                      for d in row] for row in dev])
    xs, ys = np.where(mine)
    return ((int(xs.min()) * nx, (int(xs.max()) + 1) * nx),
            (int(ys.min()) * ny, (int(ys.max()) + 1) * ny))


def array_local_slab(arr):
    """``(bounds, data)`` of the rectangular region of a sharded 2-D
    global array covered by THIS process's addressable shards, without any
    cross-host gather: ``bounds = (x0, x1, y0, y1)`` global indices,
    ``data`` the assembled host ndarray.

    This is the array-level primitive behind multi-process I/O
    (checkpoint.save_sharded, io.writers.FieldWriter): with several
    processes ``jax.device_get`` fails on non-addressable shards, so each
    process extracts exactly its own slab. Unlike
    :func:`process_local_slab` it derives bounds from the array's actual
    sharding, so it also covers derived outputs whose sharding was chosen
    by the compiler. Returns ``None`` when this process holds only
    redundant replicas (``replica_id != 0`` everywhere) — the replica-0
    holders cover the domain, so such a process correctly writes
    nothing. Raises if the replica-0 shards do not tile a rectangle
    (cannot happen for a 2-D ('x','y') mesh with one process per
    contiguous device block)."""
    shards = [s for s in arr.addressable_shards if s.replica_id == 0]
    if not shards:
        return None
    boxes = []
    for s in shards:
        sx, sy = s.index
        sx = sx.indices(arr.shape[0])
        sy = sy.indices(arr.shape[1])
        boxes.append((sx[0], sx[1], sy[0], sy[1]))
    x0 = min(b[0] for b in boxes)
    x1 = max(b[1] for b in boxes)
    y0 = min(b[2] for b in boxes)
    y1 = max(b[3] for b in boxes)
    out = np.empty((x1 - x0, y1 - y0), dtype=arr.dtype)
    filled = 0
    for s, (bx0, bx1, by0, by1) in zip(shards, boxes):
        data = np.asarray(s.data)
        out[bx0 - x0:bx1 - x0, by0 - y0:by1 - y0] = data
        filled += data.size
    if filled != out.size:
        raise RuntimeError(
            f"addressable shards cover {filled} of {out.size} points of "
            f"the bounding slab [{x0}:{x1}, {y0}:{y1}] — process shards "
            f"do not tile a rectangle")
    return (x0, x1, y0, y1), out


def sync(tag: str) -> None:
    """Cross-process barrier (no-op single-process)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(tag)
