#!/usr/bin/env python
"""Offline model generation CLI — the reference's ``model_generate`` example
(``examples/ex_model_generate.cpp:8-73``): build the double-pendulum MPC
model, AOT-compile the solver, persist ``<name>.json`` + artifacts.

Usage:
    python examples/model_generate.py [--linear] [--name NAME] [--out DIR]
        [--model double_pendulum|pendulum|cartpole|two_link_arm|mahi_arm]
        [--dt 0.002] [--nodes 25] [--integrator euler|rk4]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _select_platform(argv):
    """Apply --platform before heavy imports."""
    if "--platform" in argv:
        plat = argv[argv.index("--platform") + 1]
        import jax
        jax.config.update("jax_platforms", plat)


_select_platform(sys.argv)

from mahi_mpc import ModelParameters, SolverOptions
from mahi_mpc.models import make_dynamics
from mahi_mpc.runtime import ModelGenerator


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--linear", action="store_true",
                    help="successive-linearization (LTV) mode (reference --linear)")
    ap.add_argument("--name", default=None)
    ap.add_argument("--model", default="double_pendulum")
    ap.add_argument("--out", default=".")
    # Reference canonical config: 2 ms steps, 25 nodes (ex_model_generate.cpp:56-57)
    ap.add_argument("--dt", type=float, default=0.002)
    ap.add_argument("--nodes", type=int, default=25)
    ap.add_argument("--integrator", default="euler", choices=["euler", "rk4"])
    ap.add_argument("--u-limit", type=float, default=None,
                    help="symmetric torque bound (default unbounded)")
    ap.add_argument("--platform", default=None,
                    help="jax platform override (e.g. cpu)")
    args = ap.parse_args()

    dyn = make_dynamics(args.model)
    name = args.name or (args.model + ("_linear" if args.linear else ""))
    ulim = ([-args.u_limit] * dyn.nu, [args.u_limit] * dyn.nu) \
        if args.u_limit else ([], [])
    mp = ModelParameters(
        name, num_x=dyn.nx, num_u=dyn.nu, step_size=args.dt,
        num_shooting_nodes=args.nodes, is_linear=args.linear,
        u_min=ulim[0], u_max=ulim[1],
        integrator=args.integrator, dynamics_name=args.model)

    print(f"generating model '{name}' ({args.model}, nx={dyn.nx}, nu={dyn.nu}, "
          f"N={args.nodes}, dt={args.dt*1e3:.1f} ms, "
          f"{'LTV' if args.linear else 'nonlinear'})")
    gen = ModelGenerator(mp, dyn, opts=SolverOptions())
    t0 = time.perf_counter()
    gen.create_model()
    print(f"  problem built in {time.perf_counter()-t0:.2f}s")
    t0 = time.perf_counter()
    art = gen.compile_model(args.out)
    print(f"  AOT artifact {art} ({art.stat().st_size/1e3:.1f} kB) "
          f"in {time.perf_counter()-t0:.2f}s")
    print(f"  params file  {args.out}/{name}.json")


if __name__ == "__main__":
    main()
