"""Horizon (time-axis) sharding: the shard_map parallel Riccati must equal
the sequential scan bit-for-tolerance (SURVEY.md §5 long-context row), at
n_time=2 and 4."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from mahi_mpc import ModelParameters
from mahi_mpc.models import make_double_pendulum
from mahi_mpc.parallel.time_shard import solve_lqr_time_sharded
from mahi_mpc.solver.riccati import solve_lqr_scan
from mahi_mpc.solver.stage_qp import build_stage_qp
from mahi_mpc.transcribe.shooting import default_params, make_problem

jax.config.update("jax_enable_x64", True)


def _qp(N=24, seed=0):
    mp = ModelParameters("ts", num_x=4, num_u=2, step_size=0.02,
                         num_shooting_nodes=N,
                         u_min=[-5.0, -5.0], u_max=[5.0, 5.0])
    prob = make_problem(mp, make_double_pendulum())
    rng = np.random.default_rng(seed)
    p = default_params(mp, dtype=jnp.float64)
    p = p._replace(q=jnp.array([10.0, 1.0, 5.0, 5.0]),
                   r=jnp.array([5.0, 5.0]), rm=jnp.array([0.1, 0.1]),
                   x_des=jnp.asarray(0.3 * rng.standard_normal((N, 4))),
                   x0=jnp.asarray(0.2 * rng.standard_normal(4)))
    X = jnp.asarray(0.1 * rng.standard_normal((N + 1, 4)))
    U = jnp.asarray(0.5 * rng.standard_normal((N, 2)))
    return build_stage_qp(prob, X, U, p, jnp.asarray(1e-2), jnp.asarray(1e-8))


@pytest.mark.parametrize("n_time", [
    2, pytest.param(4, marks=pytest.mark.slow)])
def test_time_sharded_equals_scan(n_time):
    devs = jax.devices()[:n_time]
    assert len(devs) == n_time, "conftest provides an 8-device CPU mesh"
    mesh = Mesh(np.asarray(devs).reshape(n_time), axis_names=("time",))
    qp = _qp(N=24)

    ref = solve_lqr_scan(qp)
    got = jax.jit(lambda q: solve_lqr_time_sharded(q, mesh))(qp)

    np.testing.assert_allclose(np.asarray(got.du), np.asarray(ref.du),
                               atol=1e-9, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(got.dz), np.asarray(ref.dz),
                               atol=1e-9, rtol=1e-9)
    np.testing.assert_allclose(np.asarray(got.lam), np.asarray(ref.lam),
                               atol=1e-8, rtol=1e-8)


def test_time_shard_requires_divisible_horizon():
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2), axis_names=("time",))
    qp = _qp(N=24)
    bad = jax.tree.map(lambda a: a[:-1] if a.ndim and a.shape[0] == 24 else a,
                       qp)
    with pytest.raises(AssertionError):
        solve_lqr_time_sharded(bad, mesh)


def test_time_shard_backend_reachable_from_solver_options():
    """SolverOptions(kkt_backend='time_shard') routes the full SQP's KKT
    solves through the sharded path and matches the scan backend."""
    from mahi_mpc import SolverOptions
    from mahi_mpc.parallel.time_shard import enable_time_shard_backend
    from mahi_mpc.solver import solve

    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), axis_names=("time",))
    name = enable_time_shard_backend(mesh)

    N = 24
    mp = ModelParameters("ts_e2e", num_x=4, num_u=2, step_size=0.02,
                         num_shooting_nodes=N,
                         u_min=[-5.0, -5.0], u_max=[5.0, 5.0])
    prob = make_problem(mp, make_double_pendulum())
    rng = np.random.default_rng(1)
    p = default_params(mp, dtype=jnp.float64)
    p = p._replace(q=jnp.array([10.0, 1.0, 5.0, 5.0]),
                   r=jnp.array([5.0, 5.0]), rm=jnp.array([0.1, 0.1]),
                   x_des=jnp.asarray(0.3 * rng.standard_normal((N, 4))),
                   x0=jnp.asarray([0.1, -0.05, 0.0, 0.0]))

    ref = solve(prob, p, opts=SolverOptions(tol=1e-8, max_iter=60,
                                            kkt_backend="riccati"))
    got = solve(prob, p, opts=SolverOptions(tol=1e-8, max_iter=60,
                                            kkt_backend=name))
    assert int(ref.status) == 0 and int(got.status) == 0
    np.testing.assert_allclose(np.asarray(got.U), np.asarray(ref.U),
                               atol=1e-7, rtol=1e-7)
