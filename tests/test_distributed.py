"""Multi-host (multi-process) execution test on the CPU simulation
(SURVEY.md §4c: jax.distributed init + a 2-process variant of the sharded
solve, results equal to single-process).

Two processes x 4 virtual CPU devices = one global 8-device mesh; both run
the identical sharded program; process 0 allgathers the full result, and the
parent compares it against a single-process vmap reference.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

CHILD = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "_distributed_child.py")


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_global_mesh(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # children set their own device count
    procs = [
        subprocess.Popen(
            [sys.executable, CHILD, str(port), "2", str(i), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)
    ]
    outs = [p.communicate(timeout=600)[0].decode() for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]

    with open(tmp_path / "proc0.json") as f:
        r0 = json.load(f)
    with open(tmp_path / "proc1.json") as f:
        r1 = json.load(f)
    assert r0["global_devices"] == 8
    assert r0["all_finite"] and r1["all_finite"]
    # Both processes observed the same global result.
    assert abs(r0["U_sum"] - r1["U_sum"]) < 1e-4 * max(1.0, abs(r0["U_sum"]))

    # Single-process reference on the same problem/seed.
    from mahi_mpc import ModelParameters, SolverOptions
    from mahi_mpc.models import make_dynamics
    from mahi_mpc.solver.batched import solve_batch_lanes
    from mahi_mpc.transcribe.shooting import default_params, make_problem

    dyn = make_dynamics("double_pendulum")
    mp = ModelParameters("dist_dp", num_x=4, num_u=2, step_size=0.02,
                         num_shooting_nodes=8, u_min=[-6.0, -6.0],
                         u_max=[6.0, 6.0], dynamics_name="double_pendulum")
    prob = make_problem(mp, dyn)
    opts = SolverOptions(tol=1e-5, max_iter=25)
    B = 16
    rng = np.random.default_rng(7)
    p = default_params(mp)
    p = p._replace(q=jnp.array([10.0, 1.0, 5.0, 5.0], jnp.float32),
                   r=jnp.array([5.0, 5.0], jnp.float32),
                   rm=jnp.array([0.1, 0.1], jnp.float32))
    p_b = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p)
    p_b = p_b._replace(
        x0=jnp.asarray((0.2 * rng.standard_normal((B, 4))), jnp.float32),
        x_des=jnp.asarray((0.2 * rng.standard_normal((B, 8, 4))), jnp.float32))
    ref = solve_batch_lanes(prob, p_b, opts=opts)

    # Distribution must not change convergence: the 2-process run matches the
    # single-process run instance-for-instance (0.875 at these fp32 settings).
    assert r0["converged_frac"] == pytest.approx(
        float(np.mean(np.asarray(ref.status) == 0)))

    U_global = np.load(tmp_path / "U_global.npy")
    np.testing.assert_allclose(U_global, np.asarray(ref.U),
                               atol=5e-4, rtol=1e-4)
