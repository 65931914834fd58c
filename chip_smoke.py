#!/usr/bin/env python
"""Smoke run of the MPC engine on one NVIDIA GPU, through its entry points.

    python chip_smoke.py           # phases 0-3 on one card
    python chip_smoke.py --four    # only the 4-card scenario-batch mesh

Model: the 4-DOF MAHI arm (nx=8, nu=4), N=25, dt=2 ms, +-20 Nm torque
bounds (BASELINE.json config #4), with seeded random states and references.

- Phase 0: the device.  No GPU, no run: there is no CPU fallback.
- Phase 1: ``ModelGenerator.compile_model`` -> ``ModelControl`` closed loop
  against an RK4 plant, then a short run of the solver thread.
- Phase 2: ``BatchModelControl.step`` at batch 4096 and 65536: one cold
  step, then warm steps under the bench warm regime (per-instance state
  noise and a phase-shifting sinusoid reference).
- Phase 3: 64 instances of the batch-4096 warm step re-solved from the same
  inputs by the plain single-instance ``solve`` on the CPU device.

Every failure exits non-zero.  The last line of standard output is the JSON
result ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))

# Phase 3 needs the CPU device beside the GPU.
_plats = os.environ.get("JAX_PLATFORMS", "")
if _plats and "cpu" not in _plats.split(","):
    os.environ["JAX_PLATFORMS"] = _plats + ",cpu"

N_NODES = 25
DT = 0.002
U_LIM = 20.0
Q_DIAG = [10.0] * 4 + [1.0] * 4
R_DIAG = [0.1] * 4
RM_DIAG = [0.01] * 4
# Max |dU| against the plain reference, Nm.  Holds for float32 under
# "highest" matmul precision; TF32 products are not expected to meet it.
PARITY_TOL = 5e-3
WARM_CONV_MIN = 0.99


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def mahi_params(name: str):
    from mahi_mpc import ModelParameters
    return ModelParameters(
        name, num_x=8, num_u=4, step_size=DT, num_shooting_nodes=N_NODES,
        u_min=[-U_LIM] * 4, u_max=[U_LIM] * 4, dynamics_name="mahi_arm")


def solver_options():
    from mahi_mpc import SolverOptions
    return SolverOptions(tol=1e-4, max_iter=40, dtype="float32")


def warm_schedule(rng, batch: int, n: int, nx: int):
    """Bench warm regime: per-instance state noise and a phase-shifting
    sinusoid reference (model_control_example.cpp:60-68)."""
    import numpy as np
    tgrid = np.arange(1, N_NODES + 1) * DT
    phase = rng.uniform(0, 2 * np.pi, (batch, 1, 1))
    amp = 0.2 * rng.standard_normal((batch, 1, nx))
    refs = [(amp * np.sin(2 * np.pi * (tgrid[None, :, None] + r * DT)
                          + phase)).astype(np.float32) for r in range(n)]
    perts = [(0.01 * rng.standard_normal((batch, nx))).astype(np.float32)
             for _ in range(n)]
    return refs, perts


# ---------------------------------------------------------------------------
# Phase 1: the single-robot runtime
# ---------------------------------------------------------------------------

def phase_runtime(workdir: str, steps: int = 200,
                  thread_seconds: float = 0.5) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mahi_mpc.models import make_dynamics
    from mahi_mpc.models.integrators import rk4_step
    from mahi_mpc.runtime import ModelControl, ModelGenerator
    from mahi_mpc.solver.sqp import CONVERGED

    dyn = make_dynamics("mahi_arm")
    mp = mahi_params("smoke_mahi_arm")
    opts = solver_options()
    t0 = time.perf_counter()
    ModelGenerator(mp, dyn, opts).compile_model(workdir)
    gen_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    # Stiffer position weights than the fleet: the 50 ms horizon has to pull
    # the arm to its goal within the run's 0.4 s.
    mc = ModelControl(mp.name, directory=workdir, opts=opts,
                      Q=[100.0] * 4 + [1.0] * 4, R=[0.01] * 4, Rm=[0.0] * 4)
    mc.warmup()
    load_s = time.perf_counter() - t0

    plant = jax.jit(rk4_step(dyn.f, DT))
    q_goal = np.array([0.3, -0.2, 0.2, 0.1])
    traj = np.tile(np.concatenate([q_goal, np.zeros(4)]), (N_NODES, 1))
    x = np.zeros(8)
    u = np.zeros(4)
    errs, replan_s = [], []
    held = 0
    for k in range(steps):
        t = k * DT
        prev = mc.control_results()
        fails = mc.stats.summary().get("failures", 0)
        plan = mc.calc_u(t, x, u, traj)
        if mc.stats.summary()["failures"] > fails:
            check(plan is prev, f"step {k}: failed solve did not hold the "
                                f"previous plan")
            held += 1
        else:
            check(plan.status == CONVERGED,
                  f"step {k}: status {plan.status}, not CONVERGED")
            if k > 0:
                replan_s.append(plan.solve_time_s)
        u = np.asarray(mc.control_at_time(t))
        check(bool(np.all(np.abs(u) <= U_LIM + 1e-3)),
              f"step {k}: u={u} outside +-{U_LIM}")
        x = np.asarray(plant(jnp.asarray(x, jnp.float32),
                             jnp.asarray(u, jnp.float32)), float)
        check(bool(np.all(np.isfinite(x))), f"step {k}: plant state {x}")
        errs.append(float(np.linalg.norm(x[:4] - q_goal)))
    err0 = float(np.linalg.norm(q_goal))
    err_end = float(np.mean(errs[-20:]))
    check(err_end < 0.5 * err0,
          f"tracking error did not decay: {err0:.4f} -> {err_end:.4f}")
    check(len(replan_s) >= steps // 2, f"only {len(replan_s)} warm re-plans")

    # The free-running solver thread beside a control loop paced at DT.
    before = mc.stats.summary()["solves"]
    mc.set_state(steps * DT, x, u, traj)
    mc.start_calc()
    try:
        t_wall = time.perf_counter()
        k = 0
        while time.perf_counter() - t_wall < thread_seconds:
            t = (steps + k) * DT
            u = np.asarray(mc.control_at_time(t))
            check(bool(np.all(np.abs(u) <= U_LIM + 1e-3)),
                  f"thread tick {k}: u={u} outside bounds")
            x = np.asarray(plant(jnp.asarray(x, jnp.float32),
                                 jnp.asarray(u, jnp.float32)), float)
            mc.set_state(t + DT, x, u, traj)
            k += 1
            slack = t_wall + k * DT - time.perf_counter()
            if slack > 0:
                time.sleep(slack)
    finally:
        mc.stop_calc()
    s = mc.stats.summary()
    thread_solves = s["solves"] - before
    check(thread_solves >= 5, f"solver thread ran {thread_solves} solves")
    check(s["served_placeholder"] == 0, "a placeholder plan was served")
    return {
        "generate_s": gen_s, "load_and_warmup_s": load_s,
        "warm_solver": mc.warm_solver, "steps": steps, "held": held,
        "replan_p50_ms": float(np.percentile(replan_s, 50) * 1e3),
        "replan_p99_ms": float(np.percentile(replan_s, 99) * 1e3),
        "track_err_start": err0, "track_err_end": err_end,
        "thread_solves": thread_solves, "thread_ticks": k,
        "failures": s["failures"],
    }


# ---------------------------------------------------------------------------
# Phase 2: the fleet service
# ---------------------------------------------------------------------------

def phase_service(batch: int, mesh, n_warm: int = 10, seed: int = 0):
    """Returns (metrics, parity inputs of the last warm step)."""
    import numpy as np
    from mahi_mpc.models import make_dynamics
    from mahi_mpc.runtime import BatchModelControl

    dyn = make_dynamics("mahi_arm")
    mp = mahi_params("smoke_fleet")
    opts = solver_options()
    rng = np.random.default_rng(seed)
    svc = BatchModelControl(mp, batch, dynamics=dyn, opts=opts, mesh=mesh,
                            Q=Q_DIAG, R=R_DIAG, Rm=RM_DIAG)
    x0 = (0.2 * rng.standard_normal((batch, 8))).astype(np.float32)
    refs, perts = warm_schedule(rng, batch, n_warm + 2, 8)
    svc.set_states(x0)
    svc.set_references(refs[0])
    fresh = svc.state_dict()

    t0 = time.perf_counter()
    svc.step()
    first_s = time.perf_counter() - t0
    svc.load_state(fresh)
    t0 = time.perf_counter()
    svc.step()
    cold_s = time.perf_counter() - t0
    cold = svc.metrics()

    # One warm step outside the timed window, reported on its own.
    svc.set_states(x0 + perts[0])
    svc.set_references(refs[1])
    t0 = time.perf_counter()
    svc.step()
    first_warm_s = time.perf_counter() - t0
    m = svc.metrics()
    check(m["converged_frac"] >= WARM_CONV_MIN,
          f"batch {batch} first warm step: converged_frac "
          f"{m['converged_frac']} < {WARM_CONV_MIN}")

    window, times, conv = [], [], []
    parity_in = None
    for i in range(n_warm):
        tr = time.perf_counter()
        svc.set_states(x0 + perts[i + 1])
        svc.set_references(refs[i + 2])
        place_s = time.perf_counter() - tr
        if i == n_warm - 1:
            parity_in = svc.state_dict()     # untimed
        t0 = time.perf_counter()
        u0 = svc.step()
        times.append(time.perf_counter() - t0)
        window.append(place_s + times[-1])
        m = svc.metrics()
        conv.append(m["converged_frac"])
        check(bool(np.all(np.isfinite(u0))), f"batch {batch}: non-finite u")
        check(bool(np.all(np.abs(u0) <= U_LIM + 1e-3)),
              f"batch {batch}: u outside bounds")
        check(m["converged_frac"] >= WARM_CONV_MIN,
              f"batch {batch} warm step {i}: converged_frac "
              f"{m['converged_frac']} < {WARM_CONV_MIN}")
    w = np.asarray(times)
    metrics = {
        "batch": batch, "warm_solver": svc.warm_solver,
        "compile_s": first_s - cold_s, "cold_s": cold_s,
        "cold_converged_frac": cold["converged_frac"],
        "cold_mean_iters": cold["mean_iters"],
        "first_warm_ms": first_warm_s * 1e3,
        "warm_p50_ms": float(np.percentile(w, 50) * 1e3),
        "warm_p99_ms": float(np.percentile(w, 99) * 1e3),
        "warm_step_ms": [float(t * 1e3) for t in w],
        # Over the whole timed window (input placement and step), not
        # batch / p50.
        "solves_per_s": batch * n_warm / float(np.sum(window)),
        "warm_converged_frac_min": float(min(conv)),
        "warm_mean_iters": m["mean_iters"],
    }
    return metrics, (svc.problem, parity_in, np.asarray(svc.last.U))


# ---------------------------------------------------------------------------
# Phase 3: parity with the plain reference solver on the CPU device
# ---------------------------------------------------------------------------

def phase_parity(prob, state: dict, U_dev, n: int = 64) -> dict:
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    from mahi_mpc.solver.sqp import solve
    from mahi_mpc.transcribe.shooting import MPCParams

    opts = solver_options()
    mu_warm = max(opts.warm_mu_factor * opts.tol, opts.mu_min)
    batch = U_dev.shape[0]
    idx = np.linspace(0, batch - 1, n).astype(int)
    cpu = jax.devices("cpu")[0]
    # float64 on the CPU only: the context leaves the float32 programs
    # already compiled for the card untouched.
    with jax.enable_x64(True), jax.default_device(cpu):
        opts64 = dataclasses.replace(opts, dtype="float64")
        take = lambda a: jnp.asarray(np.asarray(a)[idx], jnp.float64)
        p = jax.tree.map(take, MPCParams(*state["params"]))
        X, U = take(state["X"]), take(state["U"])
        ref = jax.jit(jax.vmap(lambda pp, xx, uu: solve(
            prob, pp, xx, uu, opts64, mu0=mu_warm)))(p, X, U)
        U_ref = np.asarray(ref.U)
        status = np.asarray(ref.status)
    du = float(np.max(np.abs(U_ref - U_dev[idx])))
    check(du <= PARITY_TOL,
          f"max |dU| {du:.3e} Nm against the plain solve > {PARITY_TOL}")
    return {"instances": n, "reference": "sqp.solve float64 on cpu",
            "max_du_nm": du, "tol_nm": PARITY_TOL,
            "reference_converged_frac": float(np.mean(status == 0))}


# ---------------------------------------------------------------------------
# --four: the scenario-batch mesh over four cards
# ---------------------------------------------------------------------------

def phase_four(batch: int = 16384, n_warm: int = 5) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from mahi_mpc.models import make_dynamics
    from mahi_mpc.parallel.mesh import (batch_spec, make_mesh,
                                        make_sharded_solver, shard_params)
    from mahi_mpc.transcribe.shooting import default_params, make_problem

    devs = jax.devices()
    check(len(devs) >= 4, f"--four needs 4 devices, found {len(devs)}")
    dyn = make_dynamics("mahi_arm")
    mp = mahi_params("smoke_mesh")
    opts = solver_options()
    prob = make_problem(mp, dyn)
    rng = np.random.default_rng(1)
    p = default_params(mp, dtype=jnp.float32)._replace(
        q=jnp.asarray(Q_DIAG, jnp.float32),
        r=jnp.asarray(R_DIAG, jnp.float32),
        rm=jnp.asarray(RM_DIAG, jnp.float32))
    p = jax.tree.map(lambda a: np.broadcast_to(
        np.asarray(a), (batch,) + a.shape).copy(), p)
    x0 = (0.2 * rng.standard_normal((batch, 8))).astype(np.float32)
    refs, perts = warm_schedule(rng, batch, n_warm + 1, 8)
    mu_warm = jnp.asarray(max(opts.warm_mu_factor * opts.tol, opts.mu_min),
                          jnp.float32)

    def cold(n_dev: int):
        """Compile and cold-solve on an n-card mesh.  Warm starts and
        inputs carry the batch sharding, so warm steps reuse the program."""
        mesh = make_mesh(n_batch=n_dev, n_time=1, devices=devs[:n_dev])
        fn = make_sharded_solver(prob, mesh, opts, donate_warm_start=False)
        spec = batch_spec(mesh)
        pb = shard_params(p._replace(x0=x0, x_des=refs[0]), mesh)
        X0 = jax.device_put(jnp.zeros((batch, N_NODES + 1, 8), jnp.float32),
                            spec)
        U0 = jax.device_put(jnp.zeros((batch, N_NODES, 4), jnp.float32),
                            spec)
        return mesh, fn, jax.block_until_ready(fn(pb, X0, U0))

    def warm(mesh, fn, res):
        n_dev = mesh.devices.size
        times = []
        for i in range(n_warm):
            pi = shard_params(p._replace(x0=x0 + perts[i],
                                         x_des=refs[i + 1]), mesh)
            t0 = time.perf_counter()
            res = jax.block_until_ready(fn(pi, res.X, res.U, mu_warm))
            times.append(time.perf_counter() - t0)
        for leaf in jax.tree.leaves((pi, res)):
            check(len(leaf.sharding.device_set) == n_dev,
                  f"array on {len(leaf.sharding.device_set)} of {n_dev} "
                  f"devices")
        conv = float(np.mean(np.asarray(res.status) == 0))
        # The first warm call is untimed; solves/s is over the rest.
        w = times[1:]
        return np.asarray(res.U), {
            "devices": n_dev, "warm_p50_ms": float(np.median(w)) * 1e3,
            "solves_per_s": batch * len(w) / float(np.sum(w)),
            "converged_frac": conv}

    # The two programs compile concurrently (XLA releases the GIL); the
    # timed warm loops then run one after the other.
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        four, one = pool.map(cold, (4, 1))
    compile_and_cold_s = time.perf_counter() - t0
    U4, m4 = warm(*four)
    U1, m1 = warm(*one)
    du = float(np.max(np.abs(U4 - U1)))
    check(du <= PARITY_TOL, f"4-card vs 1-card max |dU| {du:.3e}")
    check(min(m4["converged_frac"], m1["converged_frac"]) >= WARM_CONV_MIN,
          f"converged_frac {m4['converged_frac']}, {m1['converged_frac']}")
    return {"batch": batch, "four": m4, "one": m1, "max_du_nm": du,
            "tol_nm": PARITY_TOL, "compile_and_cold_s": compile_and_cold_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card scenario-batch mesh path")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    try:
        import mahi_mpc
    except ImportError as e:
        print(f"chip_smoke: the mahi_mpc package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    if os.path.dirname(os.path.dirname(os.path.abspath(
            mahi_mpc.__file__))) != HERE:
        print("chip_smoke: mahi_mpc was imported from outside this checkout",
              file=sys.stderr)
        return 2

    import jax
    from mahi_mpc.utils.cache import enable_compile_cache
    enable_compile_cache()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU: JAX's first device is {dev.platform!r} "
              f"({dev.device_kind})", file=sys.stderr)
        return 1
    log("device", platform=dev.platform, kind=dev.device_kind,
        count=len(jax.devices()), jax=jax.__version__)
    print(nvidia_smi(), flush=True)

    t_start = time.perf_counter()
    try:
        if args.four:
            log("four", **phase_four())
        else:
            from mahi_mpc.parallel.mesh import make_mesh
            workdir = tempfile.mkdtemp(prefix="chip_smoke_")
            try:
                log("runtime", **phase_runtime(workdir))
            finally:
                shutil.rmtree(workdir, ignore_errors=True)
            mesh = make_mesh(n_batch=1, n_time=1, devices=[dev])
            m, parity_in = phase_service(4096, mesh)
            log("service", **m)
            m, _ = phase_service(65536, mesh)
            log("service", **m)
            log("parity", **phase_parity(*parity_in))
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1
    log("done", seconds=time.perf_counter() - t_start)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
