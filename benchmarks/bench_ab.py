#!/usr/bin/env python
"""Full-solve A/B: the batched SQP driver x KKT backend.

Times `solve_batch_lanes` on the headline problem (4-DOF arm, N=25,
bounded, warm receding-horizon regime) with each KKT backend, chaining warm
starts and ending each timed region with `jax.block_until_ready`.

Usage:
    python benchmarks/bench_ab.py [--cpu] [--batches 256 1024 4096]
        [--kkts riccati pariccati] [--out FILE]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batches", type=int, nargs="*", default=[256, 1024, 4096])
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--solvers", nargs="*",
                    default=["batched_lanes"])
    ap.add_argument("--kkts", nargs="*", default=["riccati", "pariccati"])
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
    import mahi_mpc.solver.pariccati  # noqa: F401  (registers the backend)
    from mahi_mpc.solver.batched import solve_batch_lanes
    from mahi_mpc.transcribe.shooting import default_params, make_problem
    from mahi_mpc.utils.cache import enable_compile_cache
    enable_compile_cache()

    dev = f"{jax.devices()[0].platform}:{jax.devices()[0].device_kind}"
    report = {"device": dev, "rounds": args.rounds, "rows": []}
    print(json.dumps({"event": "start", "device": dev}), flush=True)

    dyn = make_dynamics("mahi_arm")
    mp = ModelParameters(
        "ab_mahi", num_x=dyn.nx, num_u=dyn.nu, step_size=0.002,
        num_shooting_nodes=25, u_min=[-20.0] * dyn.nu, u_max=[20.0] * dyn.nu,
        dynamics_name="mahi_arm")
    prob = make_problem(mp, dyn)
    dtype = jnp.float32
    rng = np.random.default_rng(0)

    all_solvers = {"batched_lanes": solve_batch_lanes}
    unknown = [k for k in args.solvers if k not in all_solvers]
    if unknown:
        raise SystemExit(
            f"unknown --solvers {unknown}; available: {sorted(all_solvers)}")
    solvers = {k: all_solvers[k] for k in args.solvers}
    backends = args.kkts

    for B in args.batches:
        p = default_params(mp, dtype=dtype)
        p = p._replace(q=jnp.full((mp.num_x,), 10.0, dtype),
                       r=jnp.full((mp.num_u,), 0.5, dtype),
                       rm=jnp.full((mp.num_u,), 0.01, dtype))
        pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p)
        pb = pb._replace(
            x0=jnp.asarray(0.2 * rng.standard_normal((B, prob.nx)), dtype),
            x_des=jnp.asarray(
                0.2 * rng.standard_normal((B, prob.N, prob.nx)), dtype))
        X0 = jnp.zeros((B, prob.N + 1, prob.nx), dtype)
        U0 = jnp.zeros((B, prob.N, prob.nu), dtype)

        for sname, sfn in solvers.items():
            for bk in backends:
                opts = SolverOptions(tol=1e-4, max_iter=12, kkt_backend=bk)
                fn = jax.jit(lambda pp, xx, uu, mu, sfn=sfn, opts=opts:
                             sfn(prob, pp, xx, uu, opts, mu0=mu))
                mu_cold = jnp.asarray(opts.mu_init, dtype)
                mu_warm = jnp.asarray(opts.warm_mu_factor * opts.tol, dtype)
                try:
                    t0 = time.perf_counter()
                    res = jax.block_until_ready(fn(pb, X0, U0, mu_cold))
                    cold_s = time.perf_counter() - t0
                    t0 = time.perf_counter()
                    pb_i = pb
                    for i in range(args.rounds):
                        pb_i = pb_i._replace(
                            x0=pb_i.x0 + jnp.asarray(0.01 * np.sin(i), dtype))
                        res = fn(pb_i, res.X, res.U, mu_warm)
                    jax.block_until_ready(res)
                    dt = (time.perf_counter() - t0) / args.rounds
                    it, st = jax.device_get((res.iters, res.status))
                    row = {"solver": sname, "kkt": bk, "batch": B,
                           "warm_ms": round(dt * 1e3, 2),
                           "solves_per_s": round(B / dt, 1),
                           "cold_s": round(cold_s, 1),
                           "mean_iters": round(float(np.mean(it)), 2),
                           "max_iters": int(np.max(it)),
                           "converged_frac": round(float(np.mean(st == 0)), 4)}
                except Exception as e:  # noqa: BLE001 - record and continue
                    row = {"solver": sname, "kkt": bk, "batch": B,
                           "error": repr(e)[:300]}
                report["rows"].append(row)
                print(json.dumps(row), flush=True)
                if args.out:  # flush after every row: a timeout still
                    with open(args.out, "w") as f:  # leaves data
                        json.dump(report, f, indent=2)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
