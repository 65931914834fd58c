#!/usr/bin/env python
"""Benchmark harness: the five BASELINE.json configs + scaling report.

Usage:
    python benchmarks/run_all.py [--cpu] [--configs 1 2 3] [--batch 1024]
        [--out benchmarks/results.json]

Per config: warm-started receding-horizon solve timing (p50/p99), SQP
iterations, convergence fraction, and for config #5 the batched solves/s.
Prints a JSON report; the repo-root bench.py remains the one-line headline.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIGS = {
    1: dict(name="pendulum_swingup", model="pendulum", nx=2, nu=1, N=25,
            dt=0.04, u_lim=6.0, q=[20.0, 1.0], desc="pendulum swing-up"),
    2: dict(name="cartpole_swingup", model="cartpole", nx=4, nu=1, N=50,
            dt=0.04, u_lim=10.0, q=[10.0, 20.0, 1.0, 1.0],
            desc="cart-pole swing-up with input bounds"),
    3: dict(name="two_link_reach", model="two_link_arm", nx=4, nu=2, N=50,
            dt=0.02, u_lim=40.0, q=[10.0, 10.0, 1.0, 1.0],
            desc="2-DOF arm reaching, horizon 50"),
    4: dict(name="mahi_arm_rt", model="mahi_arm", nx=8, nu=4, N=25,
            dt=0.002, u_lim=20.0, q=[10.0] * 4 + [1.0] * 4,
            desc="4-DOF MAHI-class arm, 1 kHz budget"),
    5: dict(name="batch_scenarios", model="mahi_arm", nx=8, nu=4, N=25,
            dt=0.002, u_lim=20.0, q=[10.0] * 4 + [1.0] * 4,
            desc="batched scenario MPC"),
    6: dict(name="mahi_arm_ltv", model="mahi_arm", nx=8, nu=4, N=25,
            dt=0.002, u_lim=20.0, q=[10.0] * 4 + [1.0] * 4, is_linear=True,
            desc="4-DOF arm, LTV successive-linearization mode (C8)"),
    7: dict(name="mahi_arm_xbounds", model="mahi_arm", nx=8, nu=4, N=25,
            dt=0.002, u_lim=20.0, q=[10.0] * 4 + [1.0] * 4,
            x_lim=[None] * 4 + [2.0] * 4,
            desc="4-DOF arm with joint-velocity state bounds (C5)"),
}


def bench_config(cfg, batch, rounds, opts_kw):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mahi_mpc import ModelParameters, SolverOptions
    from mahi_mpc.solver.batched import solve_batch_lanes
    from mahi_mpc.models import make_dynamics
    from mahi_mpc.transcribe.shooting import default_params, make_problem

    dyn = make_dynamics(cfg["model"])
    x_lim = cfg.get("x_lim")
    xb = {}
    if x_lim is not None:
        xb = {"x_min": [-(v if v is not None else np.inf) for v in x_lim],
              "x_max": [(v if v is not None else np.inf) for v in x_lim]}
    mp = ModelParameters(
        cfg["name"], num_x=dyn.nx, num_u=dyn.nu, step_size=cfg["dt"],
        num_shooting_nodes=cfg["N"], u_min=[-cfg["u_lim"]] * dyn.nu,
        u_max=[cfg["u_lim"]] * dyn.nu, dynamics_name=cfg["model"],
        is_linear=cfg.get("is_linear", False), **xb)
    prob = make_problem(mp, dyn)
    opts = SolverOptions(**opts_kw)
    dtype = jnp.dtype(opts.dtype)
    rng = np.random.default_rng(0)

    p = default_params(mp, dtype=dtype)
    p = p._replace(q=jnp.asarray(cfg["q"], dtype),
                   r=jnp.full((dyn.nu,), 0.1, dtype),
                   rm=jnp.full((dyn.nu,), 0.01, dtype))
    B = batch
    pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p)
    pb = pb._replace(
        x0=jnp.asarray(0.2 * rng.standard_normal((B, dyn.nx)), dtype),
        x_des=jnp.asarray(0.2 * rng.standard_normal((B, cfg["N"], dyn.nx)),
                          dtype))
    if prob.is_linear:
        # LTV mode: freeze per-instance (A, B, x_dot0) at the measured state
        # (reference C8, ModelControl.cpp:125-135), in one jitted program.
        from mahi_mpc.transcribe.shooting import LinPoint
        relin = jax.jit(lambda x0, u0: jax.vmap(dyn.linearize)(x0, u0))
        u0 = jnp.zeros((B, dyn.nu), dtype)
        A, Bm, xd0 = relin(pb.x0, u0)
        pb = pb._replace(lin=LinPoint(A, Bm, xd0, pb.x0, u0))

    # Lanes-batched path — the production batch layout.
    fn = jax.jit(lambda pp, xx, uu, mu: solve_batch_lanes(
        prob, pp, xx, uu, opts, mu0=mu))
    X = jnp.zeros((B, cfg["N"] + 1, dyn.nx), dtype)
    U = jnp.zeros((B, cfg["N"], dyn.nu), dtype)
    mu_cold = jnp.asarray(opts.mu_init, dtype)
    mu_warm = jnp.asarray(opts.warm_mu_factor * opts.tol, dtype)

    # Warm-regime schedule, identical to bench.py: pregenerated
    # per-instance perturbations and a phase-shifting sinusoid reference
    # (model_control_example.cpp:60-68).
    perts = jnp.asarray(0.01 * rng.standard_normal(
        (rounds, B, dyn.nx)), dtype)
    tgrid = np.arange(1, cfg["N"] + 1) * cfg["dt"]
    ph = rng.uniform(0, 2 * np.pi, (B, 1, 1))
    amp = 0.2 * rng.standard_normal((B, 1, dyn.nx))
    refs = [jnp.asarray(amp * np.sin(
        2 * np.pi * 1.0 * (tgrid[None, :, None] + r_ * cfg["dt"]) + ph),
        dtype) for r_ in range(rounds)]
    x0_base = pb.x0

    def perturbed(i):
        out = pb._replace(x0=x0_base + perts[i], x_des=refs[i])
        if prob.is_linear:
            A_, B_, xd0_ = relin(out.x0, out.u_prev)
            out = out._replace(lin=LinPoint(A_, B_, xd0_, out.x0, out.u_prev))
        return out

    t0 = time.perf_counter()
    res = jax.block_until_ready(fn(pb, X, U, mu_cold))
    t_cold = time.perf_counter() - t0

    lat = []
    round_iters = []
    for i in range(rounds):
        p_i = perturbed(i)
        t0 = time.perf_counter()
        res = jax.block_until_ready(fn(p_i, res.X, res.U, mu_warm))
        lat.append(time.perf_counter() - t0)
        round_iters.append((float(jnp.mean(res.iters)),
                            int(jnp.max(res.iters))))
    lat = np.asarray(lat)

    return {
        "desc": cfg["desc"],
        "batch": B,
        "cold_s": round(t_cold, 3),
        "warm_p50_ms": round(float(np.percentile(lat, 50) * 1e3), 2),
        "warm_p99_ms": round(float(np.percentile(lat, 99) * 1e3), 2),
        # Steady-state throughput (median round): the first warm re-solve
        # after a cold solve can burn straggler instances to the iteration
        # cap, a one-time transient that a receding-horizon deployment never
        # revisits; the mean-based field keeps that transient priced in.
        "solves_per_s": round(B / float(np.percentile(lat, 50)), 1),
        "solves_per_s_incl_first_warm": round(B / float(np.mean(lat)), 1),
        "mean_iters": round(float(jnp.mean(res.iters)), 2),
        "max_iters": int(jnp.max(res.iters)),
        "converged_frac": round(float(jnp.mean(
            (res.status == 0).astype(jnp.float32))), 3),
        "round_ms": [round(v * 1e3, 1) for v in lat.tolist()],
        "round_max_iters": [mi for _, mi in round_iters],
    }


def bench_batch1_fixed(cfg, rounds, opts_kw):
    """Batch-1 latency of the latency-shaped fixed-3-iteration program
    (solver/fixed.py, no While ops), plus a null-program round trip — the
    dispatch floor — so warm_p50 decomposes into dispatch + compute."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from mahi_mpc import ModelParameters, SolverOptions
    from mahi_mpc.models import make_dynamics
    from mahi_mpc.solver import solve, solve_fixed
    from mahi_mpc.transcribe.shooting import default_params, make_problem

    dyn = make_dynamics(cfg["model"])
    mp = ModelParameters(
        cfg["name"] + "_fx", num_x=dyn.nx, num_u=dyn.nu, step_size=cfg["dt"],
        num_shooting_nodes=cfg["N"], u_min=[-cfg["u_lim"]] * dyn.nu,
        u_max=[cfg["u_lim"]] * dyn.nu, dynamics_name=cfg["model"])
    prob = make_problem(mp, dyn)
    opts = SolverOptions(**opts_kw)
    dtype = jnp.dtype(opts.dtype)
    rng = np.random.default_rng(0)
    p = default_params(mp, dtype=dtype)
    p = p._replace(q=jnp.asarray(cfg["q"], dtype),
                   r=jnp.full((dyn.nu,), 0.1, dtype),
                   rm=jnp.full((dyn.nu,), 0.01, dtype),
                   x0=jnp.asarray(0.2 * rng.standard_normal(dyn.nx), dtype),
                   x_des=jnp.asarray(
                       0.2 * rng.standard_normal((cfg["N"], dyn.nx)), dtype))

    # Null-program floor: dispatch + completion of an empty program.
    null = jax.jit(lambda x: x + 1.0)
    x = jax.block_until_ready(null(jnp.zeros((), dtype)))
    reps = 30
    t0 = time.perf_counter()
    for _ in range(reps):
        x = jax.block_until_ready(null(x))
    null_ms = (time.perf_counter() - t0) / reps * 1e3


    cold = jax.jit(lambda pp, X, U, mu: solve(prob, pp, X, U, opts, mu0=mu))
    fixed = jax.jit(lambda pp, X, U, mu: solve_fixed(
        prob, pp, X, U, opts, mu0=mu, n_iter=3))

    mu_cold = jnp.asarray(opts.mu_init, dtype)
    mu_warm = jnp.asarray(opts.warm_mu_factor * opts.tol, dtype)


    def loop(fn, tag):
        nonlocal p
        res_l = jax.block_until_ready(cold(
            p, jnp.zeros((cfg["N"] + 1, dyn.nx), dtype),
            jnp.zeros((cfg["N"], dyn.nu), dtype), mu_cold))
        lat = []
        for i in range(rounds):
            p = p._replace(x0=p.x0 + jnp.asarray(0.002 * np.sin(i), dtype))
            t0 = time.perf_counter()
            res_l = jax.block_until_ready(fn(p, res_l.X, res_l.U, mu_warm))
            lat.append(time.perf_counter() - t0)
        lat = np.asarray(lat[1:])  # drop the compile round
        p50 = float(np.percentile(lat, 50) * 1e3)
        # Chained pass: per-solve time with overlapped dispatch (one
        # completion barrier at the end) — the free-running-solver-thread
        # cadence.
        t0 = time.perf_counter()
        nch = len(lat)
        for i in range(nch):
            p_l = p._replace(x0=p.x0 + jnp.asarray(0.002 * np.sin(i), dtype))
            res_l = fn(p_l, res_l.X, res_l.U, mu_warm)
        jax.block_until_ready(res_l)
        chained_ms = (time.perf_counter() - t0) / nch * 1e3
        return {
            "desc": cfg["desc"] + f" — {tag}",
            "batch": 1,
            "warm_p50_ms": round(p50, 2),
            "warm_p99_ms": round(float(np.percentile(lat, 99) * 1e3), 2),
            "warm_chained_ms_per_solve": round(chained_ms, 2),
            "null_blocking_roundtrip_ms": round(null_ms, 2),
            "compute_ms_est": round(p50 - null_ms, 2),
            "kkt": float(res_l.kkt),
            "converged": bool(res_l.status == 0),
            "fits_1kHz_budget": bool(
                float(np.percentile(lat, 99) * 1e3) <= 1.0),
        }

    return loop(fixed, "fixed-3-iteration latency program")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--configs", type=int, nargs="*",
                    default=[1, 2, 3, 4, 5, 6, 7])
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--max-iter", type=int, default=12)
    ap.add_argument("--out", default=None)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a jax.profiler trace of the whole run "
                         "into DIR (Perfetto/TensorBoard viewable)")
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from mahi_mpc.utils.cache import enable_compile_cache
    from mahi_mpc.utils.profiling import device_trace
    enable_compile_cache()

    dev = jax.devices()[0]
    report = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())}, "configs": {}}
    with device_trace(args.profile):
        _run_configs(args, report)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print("wrote", args.out)


def _run_configs(args, report):
    import json as _json  # noqa: F401
    for c in args.configs:
        cfg = CONFIGS[c]
        batch = args.batch or (4096 if c == 5 else 256)
        r = bench_config(cfg, batch, args.rounds,
                         dict(tol=args.tol, max_iter=args.max_iter))
        report["configs"][str(c)] = r
        print(f"config {c} ({cfg['desc']}): {json.dumps(r)}", flush=True)
        if args.out:  # flush after every config: a timeout still
            with open(args.out, "w") as f:  # leaves data
                json.dump(report, f, indent=2)
        if c == 4:
            # The 1 kHz budget check: one warm solve at batch 1 vs the
            # reference's 1000 us control period
            # (thread_model_control_example.cpp:70-71,108).
            r1 = bench_config(cfg, 1, max(args.rounds, 50),
                              dict(tol=args.tol, max_iter=args.max_iter))
            r1["fits_1kHz_budget"] = bool(r1["warm_p99_ms"] <= 1.0)
            report["configs"]["4_batch1_latency"] = r1
            print(f"config 4 @ batch 1 (1 kHz check): {json.dumps(r1)}",
                  flush=True)
            r1f = bench_batch1_fixed(cfg, max(args.rounds, 50),
                                     dict(tol=args.tol,
                                          max_iter=args.max_iter))
            report["configs"]["4_batch1_fixed"] = r1f
            print(f"config 4 @ batch 1 (fixed program): "
                  f"{json.dumps(r1f)}", flush=True)


if __name__ == "__main__":
    main()
