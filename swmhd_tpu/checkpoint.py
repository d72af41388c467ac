"""Checkpoint / resume — the recovery story the reference lacks (SURVEY §5).

Serialises the full :class:`State` pytree + grid metadata to a single
``.npz``; :func:`restore` rebuilds the state and validates the grid. The
nearest reference analog is the JLD2 field snapshots that *could* seed a
restart but never do (SWMHD_example.jl:81-84).
"""

from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from .grid import Grid
from .models.state import State, Clock

_FORMAT_VERSION = 1


def save(path: str, state: State, grid: Grid) -> None:
    state = jax.device_get(state)
    meta = {
        "version": _FORMAT_VERSION,
        "grid": {
            "Nx": grid.Nx, "Ny": grid.Ny, "Lx": grid.Lx, "Ly": grid.Ly,
            "x0": grid.x0, "y0": grid.y0,
            "topology_x": grid.topology_x, "topology_y": grid.topology_y,
            "dtype_name": grid.dtype_name,
        },
    }
    tmp = path + ".tmp"
    np.savez(tmp if tmp.endswith(".npz") else tmp,
             h=np.asarray(state.h), u=np.asarray(state.u),
             v=np.asarray(state.v), A=np.asarray(state.A),
             time=np.asarray(state.clock.time),
             iteration=np.asarray(state.clock.iteration),
             meta=json.dumps(meta))
    # numpy appends .npz to the temp name
    actual_tmp = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(actual_tmp, path)


def restore(path: str, grid: Grid | None = None) -> State:
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if meta["version"] != _FORMAT_VERSION:
            raise ValueError(f"unknown checkpoint version {meta['version']}")
        if grid is not None:
            gm = meta["grid"]
            if (gm["Nx"], gm["Ny"]) != (grid.Nx, grid.Ny):
                raise ValueError(
                    f"checkpoint grid {gm['Nx']}x{gm['Ny']} != "
                    f"model grid {grid.Nx}x{grid.Ny}")
        dtype = meta["grid"]["dtype_name"] if grid is None else grid.dtype
        from .models.state import time_dtype
        return State(
            h=jnp.asarray(z["h"], dtype), u=jnp.asarray(z["u"], dtype),
            v=jnp.asarray(z["v"], dtype), A=jnp.asarray(z["A"], dtype),
            clock=Clock(time=jnp.asarray(z["time"], time_dtype()),
                        iteration=jnp.asarray(z["iteration"], jnp.int32)))


def grid_from_checkpoint(path: str) -> Grid:
    with np.load(path, allow_pickle=False) as z:
        gm = json.loads(str(z["meta"]))["grid"]
    return Grid(**gm)


# -- multi-process (pod) checkpointing -----------------------------------------
#
# On a multi-process pod, ``jax.device_get(state)`` fails on the shards this
# process cannot address, so :func:`save`/:func:`restore` are single-host
# only. The sharded pair below has each process write exactly the slab its
# addressable shards cover (parallel/multihost.process_local_slab is that
# rectangle) and rebuild its own shards on restore — no cross-host gather
# anywhere. Completes the M5 recovery story (SURVEY §5 checkpoint row).

_FIELDS = ("h", "u", "v", "A")


def _sync(tag: str) -> None:
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(tag)


def save_sharded(dirpath: str, state: State, grid: Grid, mesh) -> None:
    """Each process writes ``slab_{pid:05d}.npz`` covering its own shards;
    process 0 writes ``meta.json``. Returns after a cross-process barrier,
    so the checkpoint directory is complete when save returns."""
    from .parallel.multihost import process_local_slab

    os.makedirs(dirpath, exist_ok=True)
    (x0, x1), (y0, y1) = process_local_slab(mesh, grid.Nx, grid.Ny)
    slabs = {}
    for name in _FIELDS:
        arr = getattr(state, name)
        out = np.empty((x1 - x0, y1 - y0), dtype=arr.dtype)
        filled = 0
        for shard in arr.addressable_shards:
            if shard.replica_id != 0:
                continue
            sx, sy = shard.index
            data = np.asarray(shard.data)
            out[sx.start - x0:sx.stop - x0,
                sy.start - y0:sy.stop - y0] = data
            filled += data.size
        if filled != out.size:
            raise RuntimeError(
                f"process {jax.process_index()} addressable shards of "
                f"'{name}' cover {filled} of {out.size} slab points — "
                f"mesh/process layout does not tile into rectangles")
        slabs[name] = out
    pid = jax.process_index()
    tmp = os.path.join(dirpath, f"slab_{pid:05d}.npz.tmp.npz")
    np.savez(tmp, bounds=np.array([x0, x1, y0, y1]), **slabs)
    os.replace(tmp, os.path.join(dirpath, f"slab_{pid:05d}.npz"))
    if pid == 0:
        meta = {
            "version": _FORMAT_VERSION,
            "n_slabs": jax.process_count(),
            "time": float(jax.device_get(state.clock.time)),
            "iteration": int(jax.device_get(state.clock.iteration)),
            "grid": {
                "Nx": grid.Nx, "Ny": grid.Ny, "Lx": grid.Lx, "Ly": grid.Ly,
                "x0": grid.x0, "y0": grid.y0,
                "topology_x": grid.topology_x,
                "topology_y": grid.topology_y,
                "dtype_name": grid.dtype_name,
            },
        }
        mtmp = os.path.join(dirpath, "meta.json.tmp")
        with open(mtmp, "w") as f:
            json.dump(meta, f)
        os.replace(mtmp, os.path.join(dirpath, "meta.json"))
    _sync("swmhd:ckpt:save:" + os.path.basename(dirpath))


def restore_sharded(dirpath: str, grid: Grid, mesh) -> State:
    """Rebuild a sharded :class:`State` from :func:`save_sharded` output.

    Works with a different mesh/process layout than the one that saved:
    each process lazily reads whichever slab files overlap its own
    addressable shards (on a pod this requires the slabs the process
    needs to be visible on its filesystem — true for a shared FS or for
    an unchanged layout where it reads only its own slab)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from .parallel.decomposition import AXIS_X, AXIS_Y

    with open(os.path.join(dirpath, "meta.json")) as f:
        meta = json.load(f)
    if meta["version"] != _FORMAT_VERSION:
        raise ValueError(f"unknown checkpoint version {meta['version']}")
    gm = meta["grid"]
    if (gm["Nx"], gm["Ny"]) != (grid.Nx, grid.Ny):
        raise ValueError(f"checkpoint grid {gm['Nx']}x{gm['Ny']} != "
                         f"model grid {grid.Nx}x{grid.Ny}")

    cache = {}

    def slab(pid):
        ent = cache.get(pid)
        if ent is None:
            path = os.path.join(dirpath, f"slab_{pid:05d}.npz")
            z = np.load(path, allow_pickle=False)
            b = z["bounds"]
            ent = ((int(b[0]), int(b[1]), int(b[2]), int(b[3])), z)
            cache[pid] = ent
        return ent

    def assemble(name, idx):
        sx, sy = idx
        sx = slice(*sx.indices(grid.Nx))
        sy = slice(*sy.indices(grid.Ny))
        out = np.empty((sx.stop - sx.start, sy.stop - sy.start),
                       dtype=grid.dtype)
        filled = 0
        for pid in range(meta["n_slabs"]):
            (x0, x1, y0, y1), z = slab(pid)
            ix0, ix1 = max(sx.start, x0), min(sx.stop, x1)
            iy0, iy1 = max(sy.start, y0), min(sy.stop, y1)
            if ix0 >= ix1 or iy0 >= iy1:
                continue
            out[ix0 - sx.start:ix1 - sx.start,
                iy0 - sy.start:iy1 - sy.start] = \
                z[name][ix0 - x0:ix1 - x0, iy0 - y0:iy1 - y0]
            filled += (ix1 - ix0) * (iy1 - iy0)
        if filled != out.size:
            raise RuntimeError(
                f"slabs cover {filled} of {out.size} points of requested "
                f"shard {idx} of '{name}'")
        return out

    sharding = NamedSharding(mesh, P(AXIS_X, AXIS_Y))
    fields = {
        name: jax.make_array_from_callback(
            (grid.Nx, grid.Ny), sharding,
            lambda idx, name=name: assemble(name, idx))
        for name in _FIELDS
    }
    from .models.state import time_dtype
    return State(
        **fields,
        clock=Clock(time=jnp.asarray(meta["time"], time_dtype()),
                    iteration=jnp.asarray(meta["iteration"], jnp.int32)))
