#!/usr/bin/env python
"""LTV production-service check, end to end.

Config 6 (4-DOF arm, LTV successive-linearization mode, batch 256) driven
through `BatchModelControl.step()` — states update, the service
relinearizes in one jitted program, solves, and returns first controls each
step.  The step time should land near run_all's config-6 harness number.

    python benchmarks/bench_ltv_service.py [--cpu] [--out FILE]
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np

    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")

    from mahi_mpc import ModelParameters, SolverOptions
    from mahi_mpc.runtime import BatchModelControl
    from mahi_mpc.utils.cache import enable_compile_cache
    enable_compile_cache()

    B = int(os.environ.get("LTV_BATCH", "256"))
    steps = int(os.environ.get("LTV_STEPS", "12"))
    mp = ModelParameters(
        "ltv_svc", num_x=8, num_u=4, step_size=0.002,
        num_shooting_nodes=25, u_min=[-20.0] * 4, u_max=[20.0] * 4,
        dynamics_name="mahi_arm", is_linear=True)
    svc = BatchModelControl(
        mp, batch=B, opts=SolverOptions(tol=1e-4, max_iter=12),
        Q=[10.0] * 4 + [1.0] * 4, R=[0.1] * 4, Rm=[0.01] * 4)

    rng = np.random.default_rng(0)
    x = 0.2 * rng.standard_normal((B, 8))
    svc.set_references(0.2 * rng.standard_normal((B, 25, 8)))
    svc.set_states(x)
    svc.step()                      # cold compile + first solve
    per_step = []
    for k in range(steps):
        x = x + 0.01 * rng.standard_normal((B, 8))
        svc.set_states(x)
        t0 = time.perf_counter()
        svc.step()                  # relinearize + warm solve, blocking
        per_step.append(time.perf_counter() - t0)
    m = svc.metrics()
    lat = np.asarray(per_step[1:])
    p50 = float(np.percentile(lat, 50) * 1e3)
    # Blocking-readback floor: step() returns first controls to the host
    # every call, so each step pays one dispatch->execute->pull round trip.
    null = jax.jit(lambda v: v + 1.0)
    z = jnp.zeros((), jnp.float32)
    float(null(z))
    t0 = time.perf_counter()
    for _ in range(20):
        z = null(z)
        float(z)
    null_ms = (time.perf_counter() - t0) / 20 * 1e3
    out = {
        "desc": "config 6 through BatchModelControl.step() "
                "(jitted LTV relinearize)",
        "batch": B,
        "steps": steps,
        "step_p50_ms": round(p50, 2),
        "null_blocking_roundtrip_ms": round(null_ms, 2),
        "step_compute_ms_est": round(p50 - null_ms, 2),
        "solves_per_s": round(B / p50 * 1e3, 1),
        "converged_frac": round(m["converged_frac"], 4),
        "mean_iters": m["mean_iters"],
        "device": f"{jax.devices()[0].platform}:"
                  f"{jax.devices()[0].device_kind}",
    }
    print(json.dumps(out), flush=True)
    if "--out" in sys.argv:
        with open(sys.argv[sys.argv.index("--out") + 1], "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
