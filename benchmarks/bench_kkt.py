#!/usr/bin/env python
"""KKT (Riccati) backend shootout: sequential scan vs pariccati on batches.

Measures each backend across a batch sweep, reports each against the
read-once/write-once bandwidth lower bound of the solve, and is the data
for the default backend.

The bound: a batched Riccati solve must at minimum read every QP block once
and write the solution once.  Per instance that is

    bytes = 4 * [ N*(2*nz^2 + 2*nz*nu + nu^2 + 2*nz + 2*nu) + nz^2 + nz     (read)
                  + (N+1)*nz + N*nu ]                                        (write)

so %SoL = bound_bytes / (measured_s * HBM_BW), with the device's
published memory bandwidth from ``HBM_BW`` (keyed by ``device_kind``).

Usage:
    python benchmarks/bench_kkt.py [--cpu] [--batches 128 512 2048 8192]
        [--n 25] [--out FILE]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Published memory bandwidth, bytes/s (NVIDIA H100 SXM data sheet).
HBM_BW = {"NVIDIA H100 80GB HBM3": 3.35e12}


def make_qp_batch(B, N, nx, nu, seed=0):
    import jax.numpy as jnp
    import numpy as np
    from mahi_mpc.solver.stage_qp import StageQP

    nz = nx + nu
    rng = np.random.default_rng(seed)

    def spd(n, scale):
        A = rng.standard_normal((B, N, n, n)) * scale
        return jnp.asarray(A @ A.transpose(0, 1, 3, 2)
                           + 2.0 * np.eye(n), jnp.float32)

    Az = jnp.asarray(0.3 * rng.standard_normal((B, N, nz, nz))
                     + np.eye(nz), jnp.float32)
    Bz = jnp.asarray(0.3 * rng.standard_normal((B, N, nz, nu)), jnp.float32)
    r = jnp.asarray(0.1 * rng.standard_normal((B, N, nz)), jnp.float32)
    Hzz = spd(nz, 0.2)
    Hzu = jnp.asarray(0.05 * rng.standard_normal((B, N, nz, nu)), jnp.float32)
    Huu = spd(nu, 0.2)[:, :, :nu, :nu]
    gz = jnp.asarray(0.1 * rng.standard_normal((B, N, nz)), jnp.float32)
    gu = jnp.asarray(0.1 * rng.standard_normal((B, N, nu)), jnp.float32)
    HfA = rng.standard_normal((B, nz, nz)) * 0.2
    Hf = jnp.asarray(HfA @ HfA.transpose(0, 2, 1) + 2.0 * np.eye(nz),
                     jnp.float32)
    gf = jnp.asarray(0.1 * rng.standard_normal((B, nz)), jnp.float32)
    return StageQP(Az, Bz, r, Hzz, Hzu, Huu, gz, gu, Hf, gf)


def bound_bytes(B, N, nz, nu):
    per = (N * (2 * nz * nz + 2 * nz * nu + nu * nu + 2 * nz + 2 * nu)
           + nz * nz + nz + (N + 1) * nz + N * nu)
    return 4.0 * per * B


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batches", type=int, nargs="*",
                    default=[128, 512, 2048, 8192])
    ap.add_argument("--n", type=int, default=25)
    ap.add_argument("--nx", type=int, default=8)
    ap.add_argument("--nu", type=int, default=4)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    from mahi_mpc.solver.riccati import solve_lqr_scan
    from mahi_mpc.solver.pariccati import solve_lqr_parallel
    from mahi_mpc.utils.cache import enable_compile_cache
    enable_compile_cache()

    dev = jax.devices()[0]
    bw = HBM_BW.get(dev.device_kind)
    if bw is None and dev.platform != "cpu":
        raise SystemExit(f"no bandwidth peak for {dev.device_kind!r} in "
                         f"HBM_BW")
    nz = args.nx + args.nu
    report = {"device": {"platform": dev.platform, "kind": dev.device_kind},
              "N": args.n, "nz": nz, "nu": args.nu,
              "hbm_bw_GBs": bw / 1e9 if bw else None, "rows": []}

    backends = {
        "scan": jax.jit(jax.vmap(solve_lqr_scan)),
        "pariccati": jax.jit(jax.vmap(solve_lqr_parallel)),
    }

    ref_sol = None
    for B in args.batches:
        qp = make_qp_batch(B, args.n, args.nx, args.nu)
        bb = bound_bytes(B, args.n, nz, args.nu)
        for name, fn in backends.items():
            try:
                t0 = time.perf_counter()
                out = jax.block_until_ready(fn(qp))
                compile_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                for _ in range(args.reps):
                    out = fn(qp)
                jax.block_until_ready(out)
                dt = (time.perf_counter() - t0) / args.reps
                if name == "scan":
                    ref_sol = out
                    max_err = 0.0
                else:
                    max_err = float(jnp.max(jnp.abs(out.du - ref_sol.du)))
                row = {"backend": name, "batch": B,
                       "ms": round(dt * 1e3, 3),
                       "solves_per_s": round(B / dt, 1),
                       "pct_of_bandwidth_bound": (
                           round(100.0 * bb / dt / bw, 2) if bw else None),
                       "compile_s": round(compile_s, 1),
                       "max_abs_err_vs_scan": max_err}
            except Exception as e:  # noqa: BLE001 - record and continue
                row = {"backend": name, "batch": B, "error": repr(e)[:300]}
            report["rows"].append(row)
            print(json.dumps(row), flush=True)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
