#!/usr/bin/env python
"""Same-process full-solve A/B over linearize formulations.

The choice of stage-Jacobian formulation (solver/batched.py
_linearize_lanes) must come from back-to-back timings in one process: this
jits solve_batch_lanes once per SolverOptions.linearize_mode on the headline
problem and times warm receding-horizon rounds for each, interleaved
A/B/A/B to cancel drift between passes.

    python benchmarks/bench_lin_modes.py [--cpu] [--batch 1024] [--rounds 6]
        [--out FILE]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--modes", nargs="*", default=["rev", "fan"])
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from mahi_mpc import ModelParameters, SolverOptions
    from mahi_mpc.models import make_dynamics
    from mahi_mpc.solver.batched import solve_batch_lanes
    from mahi_mpc.transcribe.shooting import default_params, make_problem
    from mahi_mpc.utils.cache import enable_compile_cache
    enable_compile_cache()

    dev = f"{jax.devices()[0].platform}:{jax.devices()[0].device_kind}"
    B = args.batch
    dyn = make_dynamics("mahi_arm")
    mp = ModelParameters(
        "linmode", num_x=dyn.nx, num_u=dyn.nu, step_size=0.002,
        num_shooting_nodes=25, u_min=[-20.0] * dyn.nu, u_max=[20.0] * dyn.nu,
        dynamics_name="mahi_arm")
    prob = make_problem(mp, dyn)
    dtype = jnp.float32
    rng = np.random.default_rng(0)
    p = default_params(mp, dtype=dtype)
    p = p._replace(q=jnp.full((mp.num_x,), 10.0, dtype),
                   r=jnp.full((mp.num_u,), 0.5, dtype),
                   rm=jnp.full((mp.num_u,), 0.01, dtype))
    pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p)
    pb = pb._replace(
        x0=jnp.asarray(0.2 * rng.standard_normal((B, prob.nx)), dtype),
        x_des=jnp.asarray(0.2 * rng.standard_normal((B, prob.N, prob.nx)),
                          dtype))
    X0 = jnp.zeros((B, prob.N + 1, prob.nx), dtype)
    U0 = jnp.zeros((B, prob.N, prob.nu), dtype)
    opts = SolverOptions(tol=1e-4, max_iter=12)
    mu_cold = jnp.asarray(opts.mu_init, dtype)
    mu_warm = jnp.asarray(opts.warm_mu_factor * opts.tol, dtype)

    import dataclasses
    fns, warm = {}, {}
    for m in args.modes:
        opts_m = dataclasses.replace(opts, linearize_mode=m)
        fn = jax.jit(lambda pp, xx, uu, mu, o=opts_m: solve_batch_lanes(
            prob, pp, xx, uu, o, mu0=mu))
        t0 = time.perf_counter()
        res = jax.block_until_ready(fn(pb, X0, U0, mu_cold))  # traces m
        print(json.dumps({"mode": m, "cold_s": round(
            time.perf_counter() - t0, 1)}), flush=True)
        fns[m] = fn
        warm[m] = res

    rows = []
    for pa in range(args.passes):            # interleave to cancel drift
        for m in args.modes:
            fn, res = fns[m], warm[m]
            pb_i = pb
            t0 = time.perf_counter()
            for i in range(args.rounds):
                pb_i = pb_i._replace(
                    x0=pb_i.x0 + jnp.asarray(0.01 * np.sin(i + pa), dtype))
                res = fn(pb_i, res.X, res.U, mu_warm)
            jax.block_until_ready(res)
            dt = (time.perf_counter() - t0) / args.rounds
            warm[m] = res
            row = {"pass": pa, "mode": m, "warm_ms": round(dt * 1e3, 2),
                   "solves_per_s": round(B / dt, 1)}
            rows.append(row)
            print(json.dumps(row), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": dev, "batch": B, "rows": rows}, f, indent=1)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
