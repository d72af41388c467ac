"""Output writers — the JLD2OutputWriter / NetCDFOutputWriter analogs.

The reference records gridded snapshots every 0.1 time units
(`JLD2OutputWriter(model, (;u,v,A,s), schedule=TimeInterval(0.1), …)`,
jacobian_formulation/SWMHD_example.jl:81-84) and 0-d energy series every
iteration (`NetCDFOutputWriter`, :87-92).

Here a :class:`FieldWriter` appends chunked, append-only ``.npy`` shards in a
directory store (a zarr-flavored layout without the dependency), and a
:class:`ScalarWriter` appends rows to a CSV — both are readable back through
:mod:`swmhd_tpu.io.readers` and by plain numpy/pandas. Device→host transfer
happens only at write time, outside the jitted step.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Callable, Dict, Mapping

import numpy as np
import jax


class FieldWriter:
    """Writes named 2-D fields on a schedule.

    ``outputs`` maps name -> callable(simulation) -> array (device or host).
    Layout: ``<path>/<name>/<index:06d>.npy`` + ``<path>/meta.json`` with
    times and grid metadata.

    Multi-process-safe: with several processes a
    global ``jax.device_get`` per snapshot fails on the shards this
    process cannot address, so any output that is a non-fully-addressable
    ``jax.Array`` is written WITHOUT a gather as one
    ``<index:06d>.p<pid:05d>.npz`` slab per process (bounds + data,
    mirroring ``checkpoint.save_sharded``); process 0 alone writes
    ``meta.json`` and fully-addressable outputs. The reader
    (:class:`~swmhd_tpu.io.readers.FieldTimeSeries`) stitches slabs back
    transparently. This is the reference's product surface
    (``JLD2OutputWriter``, jacobian_formulation/SWMHD_example.jl:81-84)
    at pod scale.
    """

    def __init__(self, outputs: Mapping[str, Callable], schedule, path: str,
                 overwrite_existing: bool = True):
        from ..parallel.multihost import sync
        self.outputs = dict(outputs)
        self.schedule = schedule
        self.path = path
        self._times = []
        self._iters = []
        self._idx = 0
        self._pid = jax.process_index()
        # directory (re)creation is process 0's job; everyone else waits
        # at the barrier so no process writes into a dir about to be
        # rmtree'd (the barrier is a no-op single-process)
        if self._pid == 0:
            if overwrite_existing and os.path.isdir(path):
                import shutil
                shutil.rmtree(path)
            os.makedirs(path, exist_ok=True)
            for name in self.outputs:
                os.makedirs(os.path.join(path, name), exist_ok=True)
        sync("swmhd:fieldwriter:init:" + os.path.basename(path))
        self._grid_meta = None

    def _write_array(self, name, arr):
        dirpath = os.path.join(self.path, name)
        if isinstance(arr, jax.Array) and not arr.is_fully_addressable:
            from ..parallel.multihost import array_local_slab
            slab = array_local_slab(arr)
            if slab is None:
                # only redundant replicas live here; the replica-0
                # holders write the covering slabs
                return
            bounds, data = slab
            tmp = os.path.join(
                dirpath, f"{self._idx:06d}.p{self._pid:05d}.tmp.npz")
            np.savez(tmp, data=data, bounds=np.asarray(bounds),
                     shape=np.asarray(arr.shape))
            os.replace(tmp, os.path.join(
                dirpath, f"{self._idx:06d}.p{self._pid:05d}.npz"))
        elif self._pid == 0:
            np.save(os.path.join(dirpath, f"{self._idx:06d}.npy"),
                    np.asarray(jax.device_get(arr)))

    def write(self, sim):
        st = sim.state
        self._times.append(float(st.clock.time))
        self._iters.append(int(st.clock.iteration))
        for name, fn in self.outputs.items():
            self._write_array(name, fn(sim))
        if self._grid_meta is None:
            g = sim.model.grid
            self._grid_meta = {
                "Nx": g.Nx, "Ny": g.Ny, "Lx": g.Lx, "Ly": g.Ly,
                "x0": g.x0, "y0": g.y0,
                "topology": [g.topology_x, g.topology_y],
            }
        self._idx += 1
        self._flush_meta()

    def _flush_meta(self):
        if self._pid != 0:
            return
        meta = {"times": self._times, "iterations": self._iters,
                "fields": sorted(self.outputs), "grid": self._grid_meta,
                "n_processes": jax.process_count()}
        with open(os.path.join(self.path, "meta.json"), "w") as f:
            json.dump(meta, f)

    def close(self):
        self._flush_meta()
        from ..parallel.multihost import sync
        sync("swmhd:fieldwriter:close:" + os.path.basename(self.path))


class ScalarSeriesWriter:
    """In-graph scalar diagnostics series → CSV.

    ``fn(model, state) -> {name: scalar}`` is traced INTO the simulation's
    scan chunk (see ShallowWaterModel.step_fn(diagnostics=...)), so the
    energies the reference recomputes eagerly every iteration
    (SWMHD_example.jl:87-92) cost one fused in-graph evaluation per step
    and one device→host transfer per *chunk*. ``schedule`` must be an
    IterationInterval; rows are subsampled host-side."""

    def __init__(self, fn: Callable, schedule, path: str,
                 overwrite_existing: bool = True):
        self.fn = fn
        self.schedule = schedule
        self.path = path
        self._every = int(getattr(schedule, "n", 1))
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._overwrite = overwrite_existing
        self._f = None
        self._csv = None
        self._names = None

    def _open(self, names):
        mode = "w" if self._overwrite or not os.path.exists(self.path) \
            else "a"
        self._f = open(self.path, mode, newline="")
        self._csv = csv.writer(self._f)
        self._names = sorted(names)
        if mode == "w":
            self._csv.writerow(["time", "iteration"] + self._names)

    def write_series(self, times, iterations, series: Mapping):
        """Append rows whose iteration is on this writer's cadence."""
        series = jax.device_get(series)
        if self._f is None:
            self._open(series.keys())
        cols = [np.asarray(series[n]) for n in self._names]
        for k, (t, it) in enumerate(zip(times, iterations)):
            if int(it) % self._every == 0:
                self._csv.writerow([float(t), int(it)]
                                   + [float(c[k]) for c in cols])
        self._f.flush()

    def close(self):
        if self._f is not None and not self._f.closed:
            self._f.close()


class ScalarWriter:
    """Appends scalar diagnostics (e.g. the four energies,
    SWMHD_example.jl:87-92) as CSV rows: time, iteration, <names...>."""

    def __init__(self, outputs: Mapping[str, Callable], schedule, path: str,
                 overwrite_existing: bool = True):
        self.outputs = dict(outputs)
        self.schedule = schedule
        self.path = path
        mode = "w" if overwrite_existing or not os.path.exists(path) else "a"
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, mode, newline="")
        self._csv = csv.writer(self._f)
        if mode == "w":
            self._csv.writerow(["time", "iteration"] + sorted(self.outputs))

    def write(self, sim):
        st = sim.state
        vals = {name: fn(sim) for name, fn in self.outputs.items()}
        vals = jax.device_get(vals)
        row = [float(st.clock.time), int(st.clock.iteration)]
        row += [float(np.asarray(vals[name])) for name in sorted(vals)]
        self._csv.writerow(row)
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.close()
