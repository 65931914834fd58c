#!/usr/bin/env python
"""Batched scenario MPC demo (BASELINE config #5): thousands of randomized
4-DOF-arm instances regulated to random goals in one closed loop on the
device mesh.

    python examples/batch_scenarios.py [--batch 4096] [--steps 50] [--platform cpu]
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

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mahi_mpc import ModelParameters, SolverOptions  # noqa: E402
from mahi_mpc.models import make_dynamics  # noqa: E402
from mahi_mpc.models.integrators import rk4_step  # noqa: E402
from mahi_mpc.runtime import BatchModelControl  # noqa: E402
from mahi_mpc.utils.cache import enable_compile_cache  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--model", default="mahi_arm")
    ap.add_argument("--platform", default=None)
    args = ap.parse_args()
    enable_compile_cache()

    dyn = make_dynamics(args.model)
    nq = dyn.nx // 2
    mp = ModelParameters(
        "batch_demo", num_x=dyn.nx, num_u=dyn.nu, step_size=0.01,
        num_shooting_nodes=25, u_min=[-20.0] * dyn.nu, u_max=[20.0] * dyn.nu,
        dynamics_name=args.model)
    svc = BatchModelControl(
        mp, batch=args.batch, dynamics=dyn,
        opts=SolverOptions(tol=1e-4, max_iter=12),
        Q=[10.0] * nq + [1.0] * nq, R=[0.1] * dyn.nu, Rm=[0.01] * dyn.nu)

    rng = np.random.default_rng(0)
    B = args.batch
    x = np.zeros((B, dyn.nx))
    x[:, :nq] = rng.uniform(-0.5, 0.5, (B, nq))
    goals = rng.uniform(-0.5, 0.5, (B, nq))
    x_des = np.zeros((B, mp.num_shooting_nodes, dyn.nx))
    x_des[:, :, :nq] = goals[:, None, :]
    svc.set_references(x_des)

    plant = jax.jit(jax.vmap(rk4_step(dyn.f, mp.step_size)))
    print(f"batch={B} on {jax.devices()[0]}; compiling...")
    err0 = None
    t_all = time.perf_counter()
    for k in range(args.steps):
        svc.set_states(x)
        u = svc.step()
        x = np.asarray(plant(jnp.asarray(x), jnp.asarray(u)))
        err = np.abs(x[:, :nq] - goals).max(axis=1)
        if err0 is None:
            err0 = err.copy()
            print(f"  step 0 (cold): {svc.solve_time_s:.1f}s")
        elif k % 10 == 0 or k == args.steps - 1:
            m = svc.metrics()
            print(f"  step {k}: {m['solves_per_s']:.0f} solves/s, "
                  f"iters {m['mean_iters']:.1f}, conv {m['converged_frac']:.2f}, "
                  f"median err {np.median(err):.4f}")
    el = time.perf_counter() - t_all
    frac = float(np.mean(err < 0.05))
    print(f"\n{args.steps} steps x {B} instances in {el:.1f}s")
    print(f"instances within 0.05 rad of goal: {100*frac:.1f}% "
          f"(median err {np.median(err0):.3f} -> {np.median(err):.4f})")


if __name__ == "__main__":
    main()
