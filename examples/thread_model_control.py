#!/usr/bin/env python
"""Asynchronous real-time MPC — the reference's flagship
``thread_model_control`` example (``examples/thread_model_control_example.cpp``):
a free-running solver thread continuously re-plans while a 1 kHz control loop
samples ``control_at_time`` and steps the plant.

Usage:
    python examples/model_generate.py --name dp --u-limit 60   # once
    python examples/thread_model_control.py --name dp [--seconds 2.0]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _select_platform(argv):
    if "--platform" in argv:
        plat = argv[argv.index("--platform") + 1]
        import jax
        jax.config.update("jax_platforms", plat)


_select_platform(sys.argv)

from mahi_mpc import SolverOptions
from mahi_mpc.models import make_dynamics
from mahi_mpc.models.integrators import rk4_step
from mahi_mpc.runtime import ModelControl


def reference_traj(mp, t):
    """Sinusoid per node (reference ``thread_model_control_example.cpp:78-86``)."""
    N, nx = mp.num_shooting_nodes, mp.num_x
    tt = t + (1 + np.arange(N)) * mp.step_size
    half = nx // 2
    traj = np.zeros((N, nx))
    for j in range(half):
        sgn = 1.0 if j % 2 == 0 else -1.0
        traj[:, j] = sgn * 0.3 * np.sin(2 * np.pi * tt)
        traj[:, half + j] = sgn * 0.3 * 2 * np.pi * np.cos(2 * np.pi * tt)
    return traj


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--name", default="double_pendulum")
    ap.add_argument("--dir", default=".")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--rate", type=float, default=1000.0,
                    help="control loop rate Hz (reference: 1 kHz Timer)")
    # Reference defaults Q=[10,1,5,5], R=[5,5] (thread_model_control_example.cpp:24-25)
    ap.add_argument("-q", type=float, nargs="*", default=None)
    ap.add_argument("-r", type=float, nargs="*", default=None)
    ap.add_argument("--warm-solver", default="auto",
                    choices=["auto", "fixed", "adaptive"],
                    help="'fixed' serves warm re-solves from the "
                         "straight-line 3-iteration program (solve_fixed)")
    ap.add_argument("--platform", default=None,
                    help="jax platform override (e.g. cpu)")
    args = ap.parse_args()

    mc = ModelControl(args.name, directory=args.dir, Q=args.q, R=args.r,
                      Rm=None, opts=SolverOptions(tol=1e-4, max_iter=40,
                                                  warm_solver=args.warm_solver,
                                                  fixed_warm_iters=3 if
                                                  args.warm_solver == "fixed"
                                                  else 0))
    mp = mc.params
    print(f"loaded '{mp.name}': nx={mp.num_x}, nu={mp.num_u}, N={mp.num_shooting_nodes}")
    if args.q is None:
        qdef = [10.0, 1.0, 5.0, 5.0][: mp.num_x] + [1.0] * max(0, mp.num_x - 4)
        mc.update_weights(Q=qdef, R=[0.5] * mp.num_u, Rm=[0.0] * mp.num_u)

    dyn = mc.dynamics or make_dynamics(mp.dynamics_name)
    dt_ctrl = 1.0 / args.rate
    plant = rk4_step(dyn.f, dt_ctrl)

    print("warming up (compiling)...")
    mc.warmup()

    x = np.zeros(mp.num_x)
    x[0] = 0.3
    u = np.zeros(mp.num_u)
    mc.set_state(0.0, x, u, reference_traj(mp, 0.0))
    mc.start_calc()
    # Reference warm-start sleep: 100 ms (thread_model_control_example.cpp:68)
    time.sleep(0.1)

    import jax.numpy as jnp
    steps = int(args.seconds * args.rate)
    deadline_miss = 0
    errs = []
    t_wall0 = time.perf_counter()
    for k in range(steps):
        t = k * dt_ctrl
        u = mc.control_at_time(t)
        x = np.asarray(plant(jnp.asarray(x), jnp.asarray(u)))
        mc.set_state(t + dt_ctrl, x, u, reference_traj(mp, t + dt_ctrl))
        errs.append(abs(x[0] - 0.3 * np.sin(2 * np.pi * (t + dt_ctrl))))
        # deadline pacing (reference Timer.wait)
        next_t = t_wall0 + (k + 1) * dt_ctrl
        slack = next_t - time.perf_counter()
        if slack > 0:
            time.sleep(slack)
        else:
            deadline_miss += 1
    mc.stop_calc()

    s = mc.stats.summary()
    errs = np.asarray(errs)
    print(f"\ncontrol loop: {steps} ticks @ {args.rate:.0f} Hz, "
          f"{deadline_miss} deadline misses ({100*deadline_miss/steps:.1f}%)")
    print(f"solver thread: {s['solves']} solves, mean {s['mean_ms']:.2f} ms, "
          f"p50 {s['p50_ms']:.2f} ms, p99 {s['p99_ms']:.2f} ms, "
          f"mean iters {s['mean_iters']:.1f}, failures {s['failures']}")
    print(f"tracking |err| mean {errs.mean():.4f}, "
          f"first-100 {errs[:100].mean():.4f} -> last-100 {errs[-100:].mean():.4f}")


if __name__ == "__main__":
    main()
