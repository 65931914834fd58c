"""Scenario-batch sharding tests on the virtual 8-device CPU mesh
(SURVEY.md §4: multi-chip correctness = per-instance equality between the
1-device and sharded runs of the same batched solve)."""

import numpy as np
import jax
import jax.numpy as jnp

from mahi_mpc import ModelParameters, SolverOptions
from mahi_mpc.models import make_dynamics
from mahi_mpc.parallel import (make_mesh, make_sharded_solver,
                                   scaling_report, shard_params)
from mahi_mpc.solver import solve
from mahi_mpc.transcribe.shooting import default_params, make_problem


def _batch_problem(B=16, N=10, dtype=jnp.float32):
    dyn = make_dynamics("double_pendulum")
    mp = ModelParameters("shard_dp", num_x=4, num_u=2, step_size=0.01,
                         num_shooting_nodes=N, u_min=[-50.0] * 2,
                         u_max=[50.0] * 2, dynamics_name="double_pendulum")
    prob = make_problem(mp, dyn)
    rng = np.random.default_rng(0)
    p = default_params(mp, dtype=dtype)
    p = p._replace(q=jnp.asarray([10.0, 1.0, 5.0, 5.0], dtype),
                   r=jnp.asarray([0.5, 0.5], dtype),
                   rm=jnp.asarray([0.01, 0.01], dtype))
    pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape).copy(), p)
    pb = pb._replace(
        x0=jnp.asarray(0.2 * rng.standard_normal((B, 4)), dtype),
        x_des=jnp.asarray(0.2 * rng.standard_normal((B, N, 4)), dtype))
    return prob, pb


def test_sharded_matches_single_device():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    prob, pb = _batch_problem(B=16)
    opts = SolverOptions(tol=1e-5, max_iter=40)
    B = 16
    dtype = jnp.float32
    X0 = jnp.zeros((B, prob.N + 1, prob.nx), dtype)
    U0 = jnp.zeros((B, prob.N, prob.nu), dtype)

    # single-device reference: the same (lanes) implementation on one device
    from mahi_mpc.solver.batched import solve_batch_lanes
    ref = jax.jit(lambda p, x, u: solve_batch_lanes(prob, p, x, u, opts))(
        pb, X0, U0)

    mesh = make_mesh(n_batch=8, n_time=1)
    fn = make_sharded_solver(prob, mesh, opts, donate_warm_start=False)
    got = fn(shard_params(pb, mesh), X0, U0)

    np.testing.assert_allclose(np.asarray(got.U), np.asarray(ref.U),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(np.asarray(got.status),
                                  np.asarray(ref.status))

    # (lanes-vs-vmap algorithm equivalence is covered in
    # tests/test_batched_lanes.py)


def test_uneven_batch_not_divisible_by_mesh():
    """Batch not divisible by device count must still work (XLA pads)."""
    prob, pb = _batch_problem(B=12)  # 12 over 8 devices
    opts = SolverOptions(tol=1e-4, max_iter=20)
    mesh = make_mesh(n_batch=8)
    fn = make_sharded_solver(prob, mesh, opts, donate_warm_start=False)
    dtype = jnp.float32
    X0 = jnp.zeros((12, prob.N + 1, prob.nx), dtype)
    U0 = jnp.zeros((12, prob.N, prob.nu), dtype)
    res = fn(shard_params(pb, mesh), X0, U0)
    assert res.X.shape[0] == 12
    assert bool(jnp.all(jnp.isfinite(res.X)))


def test_scaling_report_runs():
    prob, pb = _batch_problem(B=16, N=8)
    mesh = make_mesh(n_batch=8)
    rep = scaling_report(prob, pb, mesh,
                         SolverOptions(tol=1e-4, max_iter=10), iters=1)
    assert rep["batch"] == 16 and rep["devices"] == 8
    assert rep["solves_per_s"] > 0


def test_donated_warm_start_loop():
    """Receding-horizon steady state: donated buffers re-solve in place."""
    prob, pb = _batch_problem(B=8)
    opts = SolverOptions(tol=1e-4, max_iter=25)
    mesh = make_mesh(n_batch=8)
    fn = make_sharded_solver(prob, mesh, opts, donate_warm_start=True)
    dtype = jnp.float32
    X = jnp.zeros((8, prob.N + 1, prob.nx), dtype)
    U = jnp.zeros((8, prob.N, prob.nu), dtype)
    pb = shard_params(pb, mesh)
    iters = []
    for k in range(3):
        res = fn(pb, X, U)
        X, U = res.X, res.U
        iters.append(float(jnp.mean(res.iters)))
    assert iters[-1] <= iters[0]  # warm starts converge faster (or equal)
