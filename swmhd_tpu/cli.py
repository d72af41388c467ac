"""Command-line runner for named scenarios.

The reference has no CLI (each experiment is a standalone script,
SURVEY §1); this exposes the scenario registry:

    python -m swmhd_tpu.cli run 64x64_two_Gaussians_high_B \
        --formulation vector_invariant --outdir runs/high_B
    python -m swmhd_tpu.cli list
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import jax
import jax.numpy as jnp


def _add_run_args(p):
    p.add_argument("scenario")
    p.add_argument("--formulation", default="vector_invariant",
                   choices=["vector_invariant", "conservative"])
    p.add_argument("--dt", type=float, default=None)
    p.add_argument("--stop-time", type=float, default=None)
    p.add_argument("--outdir", default=None)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--fields-interval", type=float, default=0.1,
                   help="TimeInterval for field snapshots (reference: 0.1)")
    p.add_argument("--energies-every", type=int, default=1,
                   help="IterationInterval for energy series (reference: 1)")
    p.add_argument("--progress-every", type=int, default=100)
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="iterations between checkpoints (0 = off)")
    p.add_argument("--resume", default=None,
                   help="checkpoint file to resume from")
    p.add_argument("--movie", action="store_true",
                   help="render A/speed movie + energy plot after the run")
    p.add_argument("--nu", type=float, default=0.0,
                   help="momentum diffusivity (Laplacian; biharmonic with "
                        "--biharmonic)")
    p.add_argument("--kappa", type=float, default=0.0,
                   help="tracer diffusivity")
    p.add_argument("--biharmonic", action="store_true",
                   help="use -nu grad^4 / -kappa grad^4 instead of "
                        "Laplacian diffusion")


def cmd_list(_args):
    from . import scenarios
    for name in scenarios.names():
        sc = scenarios.get(name)
        print(f"{name:34s} N={sc.N:<5d} stop_time={sc.stop_time:<6g} "
              f"{sc.description}")


def cmd_run(args):
    from . import scenarios, diagnostics, checkpoint
    from .simulation import (
        Simulation, IterationInterval, TimeInterval, Callback,
        progress_callback)
    from .io import FieldWriter, ScalarSeriesWriter
    from .runtime import configure_compile_cache

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")

    # scenario reruns should not pay the WENO step's compile again
    configure_compile_cache()

    # x64 only for --dtype float64: under x64 the scalar clock rides
    # float64 (models.state.time_dtype). f32 runs get a drift-free f32
    # clock by reconstruction instead: the stepper computes t = t0 + k*dt
    # in-scan (single rounding, no accumulation) and the driver re-syncs
    # the clock from its exact host-side time between chunks
    # (simulation.Simulation.run).
    dtype = jnp.float64 if args.dtype == "float64" else jnp.float32
    if args.dtype == "float64":
        jax.config.update("jax_enable_x64", True)

    model_kwargs = {}
    if args.nu or args.kappa:
        from .physics.diffusion import (LaplacianDiffusion,
                                        BiharmonicDiffusion)
        cls = BiharmonicDiffusion if args.biharmonic else LaplacianDiffusion
        model_kwargs["closure"] = cls(nu=args.nu, kappa=args.kappa)

    model, state, sc = scenarios.build(args.scenario, args.formulation,
                                       dtype=dtype, **model_kwargs)
    dt = args.dt if args.dt is not None else sc.dt
    stop_time = args.stop_time if args.stop_time is not None else sc.stop_time

    # PE is measured against the t=0 height of the scenario
    # (SWMHD_example.jl:76) — capture it BEFORE any resume overwrite.
    h0 = state.h
    if args.resume:
        state = checkpoint.restore(args.resume, model.grid)

    outdir = args.outdir or os.path.join(
        "runs", f"{args.scenario}_{args.formulation}")
    os.makedirs(outdir, exist_ok=True)

    sim = Simulation(model, dt=dt, stop_time=stop_time)
    sim.callbacks["progress"] = Callback(
        progress_callback(), IterationInterval(args.progress_every))

    def field_outputs():
        # ONE jitted evaluation per snapshot shared by all five outputs
        # instead of O(10) eager dispatches per write
        import swmhd_tpu.operators as op

        @jax.jit
        def compute(st):
            u, v = model.velocities(st)
            g = model.grid
            s = jnp.sqrt(op.ix_c(u, g) ** 2 + op.iy_c(v, g) ** 2)
            return {"A": st.A, "h": st.h, "u": u, "v": v, "s": s}

        cache = {}

        def getter(name):
            def fn(sim):
                key = id(sim.state)
                if cache.get("key") != key:
                    cache["key"] = key
                    cache["val"] = compute(sim.state)
                return cache["val"][name]
            return fn
        return {name: getter(name) for name in ("A", "h", "u", "v", "s")}

    sim.output_writers["fields"] = FieldWriter(
        outputs=field_outputs(),
        schedule=TimeInterval(args.fields_interval),
        path=os.path.join(outdir, "fields"))

    energy_names = ("kinetic_energy", "magnetic_energy",
                    "potential_energy", "total_energy", "cross_helicity")

    def energies(model, state):
        rep = diagnostics.energy_report(model, state, h0)
        return {name: rep[name] for name in energy_names}

    sim.output_writers["energies"] = ScalarSeriesWriter(
        fn=energies,
        schedule=IterationInterval(args.energies_every),
        path=os.path.join(outdir, "energies.csv"))

    if args.checkpoint_every:
        def ckpt(s):
            checkpoint.save(os.path.join(outdir, "checkpoint.npz"),
                            s.state, s.model.grid)
        sim.callbacks["checkpoint"] = Callback(
            ckpt, IterationInterval(args.checkpoint_every))

    final = sim.run(state)
    checkpoint.save(os.path.join(outdir, "final.npz"), final, model.grid)
    print(f"done: {outdir} ({sim.run_wall_time:.1f}s wall)")

    if args.movie:
        from .viz import render_scenario_outputs
        render_scenario_outputs(outdir, title=args.scenario)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="swmhd_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list").set_defaults(func=cmd_list)
    runp = sub.add_parser("run")
    _add_run_args(runp)
    runp.set_defaults(func=cmd_run)
    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
