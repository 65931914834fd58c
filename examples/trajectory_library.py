#!/usr/bin/env python
"""Offline trajectory-library generation — completes the reference's WIP
``TrajectoryGenerator`` flow (C16): waypoint CSV in, batched min-effort
point-to-point solves, library CSV out.

    python examples/trajectory_library.py --model pendulum \
        --waypoints wps.csv --out lib.csv
If --waypoints is omitted, a demo waypoint set is used.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _select_platform(argv):
    if "--platform" in argv:
        import jax
        jax.config.update("jax_platforms", argv[argv.index("--platform") + 1])


_select_platform(sys.argv)

from mahi_mpc import SolverOptions, TrajectoryParameters  # noqa: E402
from mahi_mpc.models import make_dynamics  # noqa: E402
from mahi_mpc.trajgen import TrajectoryGenerator, write_library_csv  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--model", default="pendulum")
    ap.add_argument("--waypoints", default=None, help="CSV of waypoint states")
    ap.add_argument("--out", default="trajectory_library.csv")
    ap.add_argument("--nodes", type=int, default=40)
    ap.add_argument("--dt", type=float, default=0.05)
    ap.add_argument("--u-limit", type=float, default=None)
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()

    dyn = make_dynamics(args.model)
    tp = TrajectoryParameters("lib_" + args.model, num_x=dyn.nx, num_u=dyn.nu,
                              step_size=args.dt,
                              num_shooting_nodes=args.nodes)
    lims = dict(u_min=[-args.u_limit] * dyn.nu,
                u_max=[args.u_limit] * dyn.nu) if args.u_limit else {}
    gen = TrajectoryGenerator(tp, dyn,
                              opts=SolverOptions(tol=1e-6, max_iter=100),
                              **lims)

    if args.waypoints:
        segs = gen.generate_from_csv(args.waypoints, args.out)
    else:
        half = dyn.nx // 2
        qs = np.linspace(0.0, 0.8, 4)
        wps = np.zeros((len(qs), dyn.nx))
        wps[:, 0] = qs
        print(f"demo waypoints:\n{wps}")
        segs = gen.generate(wps)
        write_library_csv(args.out, segs, gen.mp)

    for i, s in enumerate(segs):
        print(f"segment {i}: status={s.status} endpoint_err={s.endpoint_err:.2e} "
              f"mean|u|={np.abs(s.U).mean():.3f}")
    print(f"library written to {args.out}")


if __name__ == "__main__":
    main()
