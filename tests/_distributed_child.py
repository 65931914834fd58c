"""Child process for the multi-host CPU simulation test (SURVEY.md §4:
"test multi-node without a cluster").  Launched by tests/test_distributed.py:

    python tests/_distributed_child.py <port> <num_procs> <proc_id> <outdir>

Each process owns 4 virtual CPU devices; together they form one global
8-device mesh running the identical sharded solve program.
"""

import json
import os
import sys


def main():
    port, num_procs, proc_id, outdir = (
        int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])

    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4"
                               ).strip()
    import jax
    jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from mahi_mpc.parallel.distributed import initialize_distributed

    assert initialize_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=num_procs, process_id=proc_id)
    assert jax.process_count() == num_procs
    assert jax.device_count() == 4 * num_procs

    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils

    from mahi_mpc import ModelParameters, SolverOptions
    from mahi_mpc.models import make_dynamics
    from mahi_mpc.parallel.distributed import (global_batch_mesh,
                                                   scaling_table,
                                                   shard_params_global)
    from mahi_mpc.parallel.mesh import make_sharded_solver
    from mahi_mpc.transcribe.shooting import default_params, make_problem

    dyn = make_dynamics("double_pendulum")
    mp = ModelParameters("dist_dp", num_x=4, num_u=2, step_size=0.02,
                         num_shooting_nodes=8, u_min=[-6.0, -6.0],
                         u_max=[6.0, 6.0], dynamics_name="double_pendulum")
    prob = make_problem(mp, dyn)
    opts = SolverOptions(tol=1e-5, max_iter=25)

    B = 16
    rng = np.random.default_rng(7)  # same seed in every process
    p = default_params(mp)
    p = p._replace(q=jnp.array([10.0, 1.0, 5.0, 5.0], jnp.float32),
                   r=jnp.array([5.0, 5.0], jnp.float32),
                   rm=jnp.array([0.1, 0.1], jnp.float32))
    p_b = jax.tree.map(lambda a: np.broadcast_to(
        np.asarray(a), (B,) + a.shape), p)
    p_b = p_b._replace(
        x0=(0.2 * rng.standard_normal((B, 4))).astype(np.float32),
        x_des=(0.2 * rng.standard_normal((B, 8, 4))).astype(np.float32))

    mesh = global_batch_mesh()
    p_g = shard_params_global(p_b, mesh)
    fn = make_sharded_solver(prob, mesh, opts, donate_warm_start=False)
    from mahi_mpc.parallel.mesh import batch_spec
    Zx = np.zeros((B, 9, 4), np.float32)
    Zu = np.zeros((B, 8, 2), np.float32)
    spec = batch_spec(mesh)
    X0 = jax.make_array_from_callback(Zx.shape, spec, lambda i: Zx[i])
    U0 = jax.make_array_from_callback(Zu.shape, spec, lambda i: Zu[i])

    res = fn(p_g, X0, U0)
    U_full = np.asarray(multihost_utils.process_allgather(
        res.U, tiled=True))
    status_full = np.asarray(multihost_utils.process_allgather(
        res.status, tiled=True))

    table = scaling_table(prob, p_b, opts)
    out = {"proc": proc_id, "U_sum": float(np.sum(U_full)),
           "all_finite": bool(np.all(np.isfinite(U_full))),
           "converged_frac": float(np.mean(status_full == 0)),
           "global_solves_per_s": table["global"]["solves_per_s"],
           "global_devices": table["global_devices"]}
    if proc_id == 0:
        np.save(os.path.join(outdir, "U_global.npy"), U_full)
    with open(os.path.join(outdir, f"proc{proc_id}.json"), "w") as f:
        json.dump(out, f)
    print("child ok", proc_id, flush=True)


if __name__ == "__main__":
    main()
