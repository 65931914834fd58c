#!/usr/bin/env python
"""Synchronous MPC simulation — the reference's ``model_control`` example
(``examples/model_control_example.cpp``): sim loop at the model step size,
re-solve every Mth cycle (``:74-76``), ZOH control lookup between solves,
plant propagation distinct from the predictor (``:82-86``), results export +
solve-time report (``:95-152``).

    python examples/model_generate.py --name dp --u-limit 60 --dt 0.01
    python examples/model_control.py --name dp [--resolve-every 5] [--out results]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _select_platform(argv):
    if "--platform" in argv:
        import jax
        jax.config.update("jax_platforms", argv[argv.index("--platform") + 1])


_select_platform(sys.argv)

import jax.numpy as jnp  # noqa: E402

from mahi_mpc import SolverOptions  # noqa: E402
from mahi_mpc.models import make_dynamics  # noqa: E402
from mahi_mpc.models.integrators import rk4_step  # noqa: E402
from mahi_mpc.runtime import ModelControl  # noqa: E402
from mahi_mpc.utils import ControlLog  # noqa: E402


def reference_traj(mp, t, amp=0.3, freq=1.0):
    N, nx = mp.num_shooting_nodes, mp.num_x
    tt = t + (1 + np.arange(N)) * mp.step_size
    half = nx // 2
    traj = np.zeros((N, nx))
    w = 2 * np.pi * freq
    for j in range(half):
        sgn = 1.0 if j % 2 == 0 else -1.0
        traj[:, j] = sgn * amp * np.sin(w * tt)
        traj[:, half + j] = sgn * amp * w * np.cos(w * tt)
    return traj


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--name", default="double_pendulum")
    ap.add_argument("--dir", default=".")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--resolve-every", type=int, default=5,
                    help="solve cadence in sim ticks (reference: 5)")
    ap.add_argument("--out", default=None, help="export prefix (csv/npz/png)")
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()

    mc = ModelControl(args.name, directory=args.dir,
                      opts=SolverOptions(tol=1e-4, max_iter=40))
    mp = mc.params
    qdef = ([10.0, 1.0, 5.0, 5.0][: mp.num_x]
            + [1.0] * max(0, mp.num_x - 4))
    mc.update_weights(Q=qdef, R=[0.5] * mp.num_u, Rm=[0.0] * mp.num_u)
    dyn = mc.dynamics or make_dynamics(mp.dynamics_name)
    plant = rk4_step(dyn.f, mp.step_size)
    print(f"loaded '{mp.name}': nx={mp.num_x}, nu={mp.num_u}, "
          f"N={mp.num_shooting_nodes}, dt={mp.step_size*1e3:.1f} ms")
    mc.warmup()

    log = ControlLog()
    x = np.zeros(mp.num_x)
    x[0] = 0.3
    u = np.zeros(mp.num_u)
    for k in range(args.steps):
        t = k * mp.step_size
        traj = reference_traj(mp, t)
        if k % args.resolve_every == 0:
            t0 = time.perf_counter()
            plan = mc.calc_u(t, x, u, traj)
            solve_ms = (time.perf_counter() - t0) * 1e3
        else:
            solve_ms = np.nan
        u = mc.control_at_time(t)
        x = np.asarray(plant(jnp.asarray(x), jnp.asarray(u)))
        log.append(t, x, u, x_des=traj[0], solve_ms=solve_ms,
                   iters=mc.control_results().iters)

    rep = log.timing_report()
    t_arr, x_arr, _, xd_arr = log.arrays()
    err = np.abs(x_arr[:, 0] - xd_arr[:, 0])
    print(f"avg solve time: {rep['mean_ms']:.2f} ms "
          f"(p50 {rep['p50_ms']:.2f}, p99 {rep['p99_ms']:.2f}) "
          f"over {rep['solves']} solves")
    print(f"tracking |err| mean {err.mean():.4f} "
          f"(first-50 {err[:50].mean():.4f} -> last-50 {err[-50:].mean():.4f})")
    if args.out:
        print("exported:", log.to_csv(args.out + ".csv"),
              log.to_npz(args.out + ".npz"), log.to_png(args.out + ".png"))


if __name__ == "__main__":
    main()
