#!/usr/bin/env python
"""Headline benchmark: warm MPC solves/s on one GPU, 4-DOF arm, horizon 25.

Drives ``BatchModelControl.step`` (the served fleet path, with whatever
``warm_solver="auto"`` resolves to) over a batch ladder.  Prints one JSON line
per phase (compile/cold/warm at each batch size), each naming the device and
its power limit, and finishes with the headline line:
  {"metric": ..., "value": N, "unit": "solves/s/chip", "vs_baseline": N}

The reference publishes no numbers (SURVEY.md §6); its implied envelope is a
few ms per warm IPOPT solve of the same problem on a desktop CPU — we take
250 solves/s (4 ms/solve, one instance at a time) as the baseline for
``vs_baseline``, per BASELINE.md.

Warm regime: per-instance, per-coordinate state perturbations and a
reference trajectory that shifts every cycle (the reference rebuilds its
sinusoid reference each control tick, ``model_control_example.cpp:60-68``).
A rung's solves/s is batch x rounds over the whole timed warm window (host
input placement and the step, after one untimed warm step); p50/p99 are the
step latencies inside it.  A rung whose warm converged_frac is below 0.99
gives no headline number.

    python bench.py [--cpu]     # BENCH_BATCHES=256,4096,65536 BENCH_ROUNDS=10

Without ``--cpu`` a run that finds no GPU fails; any rung that raises makes
the run exit non-zero.
"""

import json
import os
import subprocess
import sys
import time

BASELINE_SOLVES_PER_S = 250.0  # implied reference envelope (BASELINE.md)
T0 = time.perf_counter()
DEVICE = {}


def emit(**kw):
    kw["t"] = round(time.perf_counter() - T0, 3)
    print(json.dumps({**kw, "device": DEVICE}), flush=True)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not available"


def main():
    import jax
    import numpy as np

    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mahi_mpc import ModelParameters, SolverOptions
    from mahi_mpc.models import make_dynamics
    from mahi_mpc.parallel.mesh import make_mesh
    from mahi_mpc.runtime import BatchModelControl
    from mahi_mpc.utils.cache import enable_compile_cache
    enable_compile_cache()

    dev = jax.devices()[0]
    if dev.platform != "gpu" and "--cpu" not in sys.argv:
        print(f"bench.py: no GPU (first device is {dev.platform!r}); pass "
              f"--cpu for a CPU run", file=sys.stderr)
        sys.exit(1)
    DEVICE.update(platform=dev.platform, kind=dev.device_kind,
                  count=len(jax.devices()),
                  smi=power_limit() if dev.platform == "gpu" else None)
    emit(phase="start")

    dyn = make_dynamics("mahi_arm")
    mp = ModelParameters(
        "bench_mahi", num_x=dyn.nx, num_u=dyn.nu, step_size=0.002,
        num_shooting_nodes=25, u_min=[-20.0] * dyn.nu, u_max=[20.0] * dyn.nu,
        dynamics_name="mahi_arm")
    opts = SolverOptions(tol=1e-4, max_iter=30, dtype="float32")
    mesh = make_mesh(n_batch=1, n_time=1, devices=[dev])
    rng = np.random.default_rng(0)
    N, nx = mp.num_shooting_nodes, mp.num_x

    ladder = [int(b) for b in os.environ.get(
        "BENCH_BATCHES", "256,4096,65536").split(",")]
    n_rounds = int(os.environ.get("BENCH_ROUNDS", "10"))
    best, failed = None, False

    for batch in ladder:
        try:
            svc = BatchModelControl(mp, batch, dynamics=dyn, opts=opts,
                                    mesh=mesh, Q=[10.0] * 4 + [1.0] * 4,
                                    R=[0.1] * 4, Rm=[0.01] * 4)
            x0 = (0.2 * rng.standard_normal((batch, nx))).astype(np.float32)
            tgrid = np.arange(1, N + 1) * mp.step_size
            phase = rng.uniform(0, 2 * np.pi, (batch, 1, 1))
            amp = 0.2 * rng.standard_normal((batch, 1, nx))
            refs = [(amp * np.sin(2 * np.pi * (tgrid[None, :, None]
                                               + r * mp.step_size) + phase)
                     ).astype(np.float32) for r in range(n_rounds + 2)]
            perts = (0.01 * rng.standard_normal((n_rounds + 1, batch, nx))
                     ).astype(np.float32)
            svc.set_states(x0)
            svc.set_references(refs[0])
            fresh = svc.state_dict()

            tc = time.perf_counter()
            svc.step()
            first_s = time.perf_counter() - tc
            svc.load_state(fresh)
            tc = time.perf_counter()
            svc.step()
            cold_s = time.perf_counter() - tc
            m = svc.metrics()
            emit(phase="cold", batch=batch, compile_s=first_s - cold_s,
                 cold_s=cold_s, converged_frac=m["converged_frac"],
                 mean_iters=m["mean_iters"], solver=svc.warm_solver)

            # One warm step outside the timed window, reported on its own.
            svc.set_states(x0 + perts[0])
            svc.set_references(refs[1])
            tw = time.perf_counter()
            svc.step()
            first_warm_s = time.perf_counter() - tw

            # The timed window: per round, the host inputs are placed and the
            # batch re-solved; reading the convergence metric is not timed.
            window, times, conv = [], [], []
            for i in range(n_rounds):
                tr = time.perf_counter()
                svc.set_states(x0 + perts[i + 1])
                svc.set_references(refs[i + 2])
                tw = time.perf_counter()
                svc.step()
                t1 = time.perf_counter()
                times.append(t1 - tw)
                window.append(t1 - tr)
                conv.append(svc.metrics()["converged_frac"])
            sps = batch * n_rounds / sum(window)
            emit(phase="warm", batch=batch, solves_per_s=sps,
                 window_s=sum(window), rounds=n_rounds,
                 p50_ms=float(np.median(times)) * 1e3,
                 p99_ms=float(np.percentile(times, 99)) * 1e3,
                 step_ms=[t * 1e3 for t in times],
                 first_warm_ms=first_warm_s * 1e3,
                 converged_frac_min=min(conv),
                 mean_iters=svc.metrics()["mean_iters"],
                 solver=svc.warm_solver)
            if min(conv) >= 0.99 and (best is None or sps > best["sps"]):
                best = {"sps": sps, "batch": batch,
                        "dt": sum(window) / n_rounds, "conv": min(conv)}
        except Exception as e:  # noqa: BLE001 — report, finish, then fail
            failed = True
            emit(phase="error", batch=batch, error=repr(e)[:500])

    if best is None:
        emit(phase="failed", note="no batch size produced a valid number")
        sys.exit(1)
    out = {
        "metric": "warm MPC solves/s/chip (4-DOF arm, N=25, bounded, "
                  "batch=%d, BatchModelControl)" % best["batch"],
        "value": best["sps"],
        "unit": "solves/s/chip",
        "vs_baseline": best["sps"] / BASELINE_SOLVES_PER_S,
        "detail": {"device": DEVICE, "batch": best["batch"],
                   "ms_per_round": best["dt"] * 1e3,
                   "converged_frac": best["conv"]},
    }
    print(json.dumps(out), flush=True)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
