#!/usr/bin/env python
"""Per-stage SQP profiling on the current jax.devices() backend.

Times each stage of one SQP iteration separately — linearize (lanes), QP
build, KKT solve (scan), merit/line-search evaluation — at several batch
sizes.  Emits one JSON line per measurement so a partial run still leaves
data.

Usage:  python benchmarks/profile_stages.py [--cpu] [--batches 256,1024]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def emit(**kw):
    print(json.dumps(kw), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batches", default="256,1024,4096")
    ap.add_argument("--model", default="mahi_arm")
    ap.add_argument("--horizon", type=int, default=25)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", action="store_true",
                    help="also time the three linearize formulations "
                    "(vmapped JVP fan / unrolled JVP fan / unrolled "
                    "reverse rows) — the data behind the unrolled-"
                    "direction rule in solver/batched.py")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from mahi_mpc import ModelParameters, SolverOptions
    from mahi_mpc.models import make_dynamics
    from mahi_mpc.solver.batched import (_defects_lanes, _linearize_lanes,
                                             _merit_batch)
    from mahi_mpc.solver.riccati import solve_lqr_scan
    from mahi_mpc.solver.stage_qp import build_stage_qp
    from mahi_mpc.transcribe.shooting import default_params, make_problem
    from mahi_mpc.utils.cache import enable_compile_cache
    enable_compile_cache()

    dev = jax.devices()[0]
    emit(event="start", platform=dev.platform, kind=dev.device_kind,
         model=args.model, N=args.horizon)

    dyn = make_dynamics(args.model)
    mp = ModelParameters(
        "prof", num_x=dyn.nx, num_u=dyn.nu, step_size=0.002,
        num_shooting_nodes=args.horizon,
        u_min=[-20.0] * dyn.nu, u_max=[20.0] * dyn.nu,
        dynamics_name=args.model)
    prob = make_problem(mp, dyn)
    dtype = jnp.float32

    def timed(name, fn, *xs, batch=None):
        """Mean time of ``args.reps`` calls, ended by block_until_ready."""
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*xs))
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = fn(*xs)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / args.reps
        emit(event="stage", stage=name, batch=batch,
             ms=round(dt * 1e3, 3), compile_s=round(t_first, 2))
        return out

    for B in [int(b) for b in args.batches.split(",")]:
        rng = np.random.default_rng(0)
        p = default_params(mp, dtype=dtype)
        p = p._replace(q=jnp.full((mp.num_x,), 10.0, dtype),
                       r=jnp.full((mp.num_u,), 0.5, dtype),
                       rm=jnp.full((mp.num_u,), 0.01, dtype))
        p_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p)
        p_b = p_b._replace(
            x0=jnp.asarray(0.2 * rng.standard_normal((B, prob.nx)), dtype),
            x_des=jnp.asarray(
                0.2 * rng.standard_normal((B, prob.N, prob.nx)), dtype))
        X = jnp.asarray(0.1 * rng.standard_normal(
            (B, prob.N + 1, prob.nx)), dtype)
        U = jnp.asarray(0.1 * rng.standard_normal(
            (B, prob.N, prob.nu)), dtype)
        mu = jnp.full((B,), 1e-3, dtype)
        reg = jnp.full((B,), 1e-8, dtype)
        nu_pen = jnp.ones((B,), dtype)

        lin_fn = jax.jit(lambda X, U: _linearize_lanes(prob, X, U))
        lin = timed("linearize_lanes", lin_fn, X, U, batch=B)

        if args.variants:
            # The three formulations of the stage-Jacobian computation,
            # timed on identical inputs (solver/batched.py
            # _linearize_lanes).
            from mahi_mpc.models.integrators import make_step
            nx, nuu = prob.nx, prob.nu
            nzz = nx + nuu
            step1 = make_step(prob.dynamics.f, prob.dt, prob.integrator)
            stepw = lambda w: step1(w[:nx], w[nx:])

            def fan_vmap(W):
                def jvp_one(e):
                    t = jnp.broadcast_to(e[:, None], W.shape)
                    return jax.jvp(stepw, (W,), (t,))[1]
                return jax.vmap(jvp_one)(jnp.eye(nzz, dtype=W.dtype))

            def fan_unrolled(W):
                cols = []
                for i in range(nzz):
                    e = np.zeros((nzz, 1), np.float32)
                    e[i] = 1.0
                    t = jnp.broadcast_to(jnp.asarray(e), W.shape)
                    cols.append(jax.jvp(stepw, (W,), (t,))[1])
                return jnp.stack(cols)

            def vjp_rows(W):
                Mw = W.shape[-1]
                _, pull = jax.vjp(
                    lambda w: prob.dynamics.f(w[:nx], w[nx:]), W)
                rows = []
                for i in range(nx // 2, nx):
                    e = np.zeros((nx, 1), np.float32)
                    e[i] = 1.0
                    rows.append(pull(jnp.broadcast_to(
                        jnp.asarray(e), (nx, Mw)))[0])
                return jnp.stack(rows)

            Wl = jnp.concatenate(
                [X[:, :-1].reshape(B * prob.N, nx).T,
                 U.reshape(B * prob.N, nuu).T], axis=0)
            for nm, fn in (("lin_fan_vmap", fan_vmap),
                           ("lin_fan_unrolled", fan_unrolled),
                           ("lin_vjp_rows", vjp_rows)):
                timed(nm, jax.jit(fn), Wl, batch=B)

        qp_fn = jax.jit(lambda X, U, p, mu, reg, A, Bm, c: jax.vmap(
            lambda X_, U_, p_, mu_, reg_, A_, B_, c_: build_stage_qp(
                prob, X_, U_, p_, mu_, reg_, lin=(A_, B_, c_)))(
            X, U, p, mu, reg, A, Bm, c))
        qp = timed("build_qp", qp_fn, X, U, p_b, mu, reg, *lin, batch=B)

        scan_fn = jax.jit(lambda qp: jax.vmap(solve_lqr_scan)(qp))
        timed("riccati_scan_vmap", scan_fn, qp, batch=B)

        merit_fn = jax.jit(
            lambda X, U, p, mu, nu_pen: _merit_batch(prob, X, U, p, mu, nu_pen))
        timed("merit_lanes", merit_fn, X, U, p_b, mu, nu_pen, batch=B)

        defect_fn = jax.jit(lambda X, U: _defects_lanes(prob, X, U))
        timed("defects_lanes", defect_fn, X, U, batch=B)

    emit(event="done")


if __name__ == "__main__":
    main()
