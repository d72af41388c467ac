"""Profiling & throughput measurement (SURVEY §5 tracing/profiling).

The reference's only instrumentation is wall-clock deltas inside its
progress callback (jacobian_formulation/SWMHD_example.jl:45-63,96-100).
Here:

  - :func:`benchmark_step` — steps/s and grid-points/s of any jitted
    ``state -> state`` (or ``state -> (state, aux)``) stepper, each timed
    call ended by ``jax.block_until_ready``.
  - :func:`device_peaks` — the published peaks of a device, keyed by its
    exact ``device_kind``, for roofline shares.
  - :func:`trace` — context manager around ``jax.profiler`` producing a
    Perfetto/XPlane dump for op-level analysis.
"""

from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import Callable, Optional

import jax


@dataclasses.dataclass
class StepBenchmark:
    steps_per_s: float         # from the median call
    points_per_s: float        # from the median call
    wall_s: float              # all timed calls
    n_steps: int               # all timed calls
    grid_points: int
    per_call_s: Optional[tuple] = None  # wall time of each timed call (s)

    @property
    def rel_spread(self) -> Optional[float]:
        if not self.per_call_s or len(self.per_call_s) < 2:
            return None
        s = sorted(self.per_call_s)
        return (s[-1] - s[0]) / s[0] if s[0] > 0 else None

    def __str__(self):
        return (f"{self.points_per_s:.3e} pts/s "
                f"({self.steps_per_s:.1f} steps/s, median of "
                f"{len(self.per_call_s or ())} calls; {self.n_steps} steps "
                f"in {self.wall_s:.4f}s)")


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    f32_flops_per_s: float     # float32 outside the tensor cores
    hbm_bytes_per_s: float
    source: str


# Published peaks, keyed by the exact ``device_kind`` JAX reports. The RK3
# step has no matrix product, so its compute bound is the float32 rate of
# the CUDA cores, not the tensor cores. The PCIe H100 has other peaks and
# is deliberately absent: a device not in this table is an error.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(
        f32_flops_per_s=67e12, hbm_bytes_per_s=3.35e12,
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, "
               "700 W"),
}


def device_peaks(kind: str) -> DevicePeaks:
    """Peaks of the device kind ``kind``; ``ValueError`` for any kind not in
    :data:`DEVICE_PEAKS` (no peak is assumed for an unknown device)."""
    try:
        return DEVICE_PEAKS[kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {kind!r}; known: "
            f"{sorted(DEVICE_PEAKS)}") from None


def benchmark_step(step_fn: Callable, state, n_steps_per_call: int,
                   n_calls: int = 5, grid_points: Optional[int] = None
                   ) -> StepBenchmark:
    """Measure a compiled stepper's throughput.

    ``step_fn`` advances ``n_steps_per_call`` RK3 steps per invocation and
    returns the new state (extra aux outputs are allowed). One warmup call
    triggers compilation and is excluded. Each of the ``n_calls`` timed
    calls ends in ``jax.block_until_ready``; the headline is their
    median."""
    def advance(s):
        out = step_fn(s)
        return out[0] if isinstance(out, tuple) else out

    if grid_points is None:
        grid_points = int(state.h.size)
    state = jax.block_until_ready(advance(state))

    per_call = []
    for _ in range(n_calls):
        t0 = time.perf_counter()
        state = jax.block_until_ready(advance(state))
        per_call.append(time.perf_counter() - t0)
    steps_per_s = n_steps_per_call / statistics.median(per_call)
    return StepBenchmark(steps_per_s=steps_per_s,
                         points_per_s=grid_points * steps_per_s,
                         wall_s=sum(per_call),
                         n_steps=n_calls * n_steps_per_call,
                         grid_points=grid_points,
                         per_call_s=tuple(per_call))


@contextlib.contextmanager
def trace(logdir: str, host_tracer_level: int = 2):
    """``with trace("/tmp/prof"):`` — jax.profiler trace for Perfetto/
    TensorBoard; the device-level analog of the reference's time_ns
    deltas."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


# -- halo-exchange / compute overlap measurement --------------------------------
#
# BASELINE names "halo-exchange overlapped with interior compute
# (overlap % tracked)"; this is the tracking implementation: run the sharded
# step under jax.profiler, parse the Perfetto trace, and report what
# fraction of collective (halo-exchange) time is covered by concurrent
# compute. Works on the CPU fake-device mesh (CPU collectives appear as
# rendezvous events; the number is thread-level and only validates the
# tooling) and on GPU traces (collective-permute events on the device
# streams).

_COMM_MARKERS = ("collective-permute", "collective_permute", "ppermute",
                 "all-reduce", "all_reduce", "all-gather", "all_gather",
                 "reduce-scatter", "reduce_scatter", "all-to-all",
                 "rendezvous")
_NON_COMPUTE_PREFIXES = ("wait", "thunkexecutor", "end:", "invoke",
                         "execute", "run", "buffer", "transfer",
                         "allocate", "deallocate", "program", "enqueue",
                         "stream", "callback", "barrier", "infeed",
                         "outfeed")


def _classify(name: str):
    n = name.lower()
    if any(m in n for m in _COMM_MARKERS):
        return "comm"
    if n.startswith(_NON_COMPUTE_PREFIXES):
        return None
    return "compute"


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _covered(span, cover):
    """Length of ``span`` ∩ union(cover); cover must be merged/sorted."""
    a, b = span
    tot = 0.0
    for c, d in cover:
        lo, hi = max(a, c), min(b, d)
        if lo < hi:
            tot += hi - lo
        if c >= b:
            break
    return tot


def parse_overlap(perfetto_json_gz: str) -> dict:
    """Overlap statistics from a Perfetto trace file (json.gz)."""
    import gzip
    import json as _json
    with gzip.open(perfetto_json_gz, "rt") as f:
        tr = _json.load(f)
    evs = tr["traceEvents"] if isinstance(tr, dict) else tr
    comm, compute = [], []
    for e in evs:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        kind = _classify(e.get("name", ""))
        if kind is None:
            continue
        span = (float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        (comm if kind == "comm" else compute).append(span)
    comm_u = _merge(comm)
    comp_u = _merge(compute)
    comm_us = sum(b - a for a, b in comm_u)
    hidden_us = sum(_covered(s, comp_u) for s in comm_u)
    return {
        "comm_ms": comm_us / 1e3,
        "compute_ms": sum(b - a for a, b in comp_u) / 1e3,
        "hidden_ms": hidden_us / 1e3,
        "overlap_pct": (100.0 * hidden_us / comm_us) if comm_us else None,
        "n_comm_events": len(comm),
        "n_compute_events": len(compute),
    }


def measure_overlap(step_fn: Callable, state, logdir: Optional[str] = None
                    ) -> dict:
    """Run ``step_fn`` once under the profiler and return
    :func:`parse_overlap` stats of the resulting trace. The stepper is
    warmed up (compiled) first so the trace holds steady-state execution."""
    import glob
    import os
    import shutil
    import tempfile

    def advance(s):
        out = step_fn(s)
        return out[0] if isinstance(out, tuple) else out

    state = jax.block_until_ready(advance(state))
    tmp = logdir or tempfile.mkdtemp(prefix="swmhd_overlap_")
    try:
        jax.profiler.start_trace(tmp, create_perfetto_trace=True)
        try:
            jax.block_until_ready(advance(state))
        finally:
            jax.profiler.stop_trace()
        files = glob.glob(os.path.join(
            tmp, "**", "perfetto_trace.json.gz"), recursive=True)
        if not files:
            return {"overlap_pct": None, "error": "no perfetto trace"}
        return parse_overlap(max(files, key=os.path.getmtime))
    finally:
        if logdir is None:
            shutil.rmtree(tmp, ignore_errors=True)
