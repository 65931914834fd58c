#!/usr/bin/env python
"""Scaling efficiency (BASELINE.md last row): solves/s at 1 device and at
all local devices, via ``parallel.distributed.scaling_table``.

- ``--cpu``: the virtual 8-device CPU mesh — checks the batch-sharding
  path, not its speed.
- default: the local GPUs; with one card, one_host is skipped and only the
  absolute row is recorded.

    python benchmarks/bench_scaling.py [--cpu] [--batch B] [--out FILE]
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8").strip()
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from mahi_mpc import ModelParameters, SolverOptions
    from mahi_mpc.models import make_dynamics
    from mahi_mpc.parallel.distributed import scaling_table
    from mahi_mpc.transcribe.shooting import default_params, make_problem
    from mahi_mpc.utils.cache import enable_compile_cache
    enable_compile_cache()

    batch = args.batch or (256 if args.cpu else 4096)
    dyn = make_dynamics("mahi_arm")
    mp = ModelParameters(
        "scale_mahi", num_x=dyn.nx, num_u=dyn.nu, step_size=0.002,
        num_shooting_nodes=25, u_min=[-20.0] * dyn.nu, u_max=[20.0] * dyn.nu,
        dynamics_name="mahi_arm")
    prob = make_problem(mp, dyn)
    opts = SolverOptions(tol=1e-4, max_iter=12, dtype="float32")
    dtype = jnp.float32
    rng = np.random.default_rng(0)
    p = default_params(mp, dtype=dtype)
    p = p._replace(q=jnp.asarray([10.0] * 4 + [1.0] * 4, dtype),
                   r=jnp.full((dyn.nu,), 0.1, dtype),
                   rm=jnp.full((dyn.nu,), 0.01, dtype))
    pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (batch,) + a.shape), p)
    pb = pb._replace(
        x0=jnp.asarray(0.2 * rng.standard_normal((batch, prob.nx)), dtype),
        x_des=jnp.asarray(
            0.2 * rng.standard_normal((batch, prob.N, prob.nx)), dtype))

    table = scaling_table(prob, pb, opts)
    dev = jax.devices()[0]
    entry = {"batch": batch, "platform": dev.platform,
             "kind": dev.device_kind, **table}
    print(json.dumps(entry, indent=1), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(entry, f, indent=1)
        print("wrote", args.out)


if __name__ == "__main__":
    main()
