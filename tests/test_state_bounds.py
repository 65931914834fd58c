"""State (x) box bounds exercised end-to-end (reference C5:
``ModelParameters.hpp:22-25``, runtime-stamped ``ModelControl.cpp:37-50``).

The barrier-on-X path (stage_qp.py barrier terms on
X, fraction-to-boundary on dX) previously had no test, oracle, or benchmark
with finite state bounds — only u-bounds were ever exercised.  These tests
give the x-bound path the same evidence level:

- f64 oracle vs scipy SLSQP on the double pendulum with *binding* velocity
  limits;
- the same on the 4-DOF arm (warm-started SLSQP, as the config-4 oracle);
- lanes and parallel-scan KKT backend parity on a bounded batch.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mahi_mpc import ModelParameters, SolverOptions
from mahi_mpc.models import make_double_pendulum
from mahi_mpc.solver import CONVERGED, solve
from mahi_mpc.transcribe.shooting import default_params, make_problem

from test_solver_oracle import _tracking_params, scipy_solve

jax.config.update("jax_enable_x64", True)


def test_state_bounds_oracle_double_pendulum():
    """Velocity limits tight enough to bind while tracking a fast sinusoid;
    trajectory parity with SLSQP on the identical NLP."""
    vlim = 1.5
    mp = ModelParameters("dpx", num_x=4, num_u=2, step_size=0.02,
                         num_shooting_nodes=20,
                         x_min=[-np.inf, -np.inf, -vlim, -vlim],
                         x_max=[np.inf, np.inf, vlim, vlim])
    prob = make_problem(mp, make_double_pendulum())
    p = _tracking_params(mp, prob, amp=1.0)
    p = p._replace(x0=jnp.array([0.3, -0.2, 0.0, 0.0]))

    res = solve(prob, p, opts=SolverOptions(tol=1e-7, max_iter=150,
                                            mu_min=1e-10))
    assert int(res.status) == CONVERGED, (res.status, res.kkt, res.feas)
    X = np.asarray(res.X)
    assert np.all(X[1:, 2:] >= -vlim - 1e-8) and np.all(X[1:, 2:] <= vlim + 1e-8)
    # the state bounds must actually bind for this test to mean anything
    assert np.any(np.abs(X[1:, 2:]) > vlim - 1e-3), np.abs(X[1:, 2:]).max()

    Xs, Us = scipy_solve(prob, p)
    np.testing.assert_allclose(np.asarray(res.U), np.asarray(Us),
                               atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(X, np.asarray(Xs), atol=2e-3, rtol=2e-3)
    J_ours = float(prob.cost(res.X, res.U, p))
    J_ref = float(prob.cost(Xs, Us, p))
    assert J_ours <= J_ref + 1e-5 * max(1.0, abs(J_ref))


@pytest.mark.slow
def test_state_bounds_oracle_mahi_arm():
    """4-DOF arm with binding joint-velocity limits (the flagship problem of
    BASELINE config #4, now with finite x bounds)."""
    from mahi_mpc.models import make_mahi_arm

    dyn = make_mahi_arm()
    vlim = 2.0
    mp = ModelParameters("arm4x", num_x=dyn.nx, num_u=dyn.nu, step_size=0.002,
                         num_shooting_nodes=25,
                         u_min=[-20.0] * dyn.nu, u_max=[20.0] * dyn.nu,
                         x_min=[-np.inf] * 4 + [-vlim] * 4,
                         x_max=[np.inf] * 4 + [vlim] * 4)
    prob = make_problem(mp, dyn)
    p = _tracking_params(mp, prob, amp=0.4, freq=3.0)
    p = p._replace(q=jnp.array([10.0] * 4 + [1.0] * 4),
                   r=jnp.array([0.5] * 4), rm=jnp.array([0.01] * 4),
                   x0=jnp.array([0.2, -0.1, 0.15, 0.1, 1.9, -1.9, 1.5, 0.0]))

    res = solve(prob, p, opts=SolverOptions(tol=1e-7, max_iter=120,
                                            mu_min=1e-10))
    assert int(res.status) == CONVERGED, (res.status, res.kkt, res.feas)
    X = np.asarray(res.X)
    assert np.all(np.abs(X[1:, 4:]) <= vlim + 1e-8)
    assert np.any(np.abs(X[1:, 4:]) > vlim - 5e-3), np.abs(X[1:, 4:]).max()

    rng = np.random.default_rng(3)
    v0 = (np.asarray(prob.pack_v(res.X, res.U), np.float64)
          + 0.02 * rng.standard_normal(prob.nv))
    Xs, Us = scipy_solve(prob, p, v0=v0)
    np.testing.assert_allclose(np.asarray(res.U), np.asarray(Us),
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(X, np.asarray(Xs), atol=1e-3, rtol=1e-3)


def _bounded_batch(B=8, N=12, vlim=1.0):
    dyn = make_double_pendulum()
    mp = ModelParameters(
        "dpx_b", num_x=dyn.nx, num_u=dyn.nu, step_size=0.01,
        num_shooting_nodes=N,
        u_min=[-40.0] * dyn.nu, u_max=[40.0] * dyn.nu,
        x_min=[-np.inf, -np.inf, -vlim, -vlim],
        x_max=[np.inf, np.inf, vlim, vlim])
    prob = make_problem(mp, dyn)
    rng = np.random.default_rng(0)
    p = default_params(mp)
    p = p._replace(q=jnp.full((dyn.nx,), 10.0), r=jnp.full((dyn.nu,), 0.5),
                   rm=jnp.full((dyn.nu,), 0.01))
    pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p)
    pb = pb._replace(
        x0=jnp.asarray(0.2 * rng.standard_normal((B, dyn.nx)), jnp.float32),
        x_des=jnp.asarray(1.2 * rng.standard_normal((B, N, dyn.nx)),
                          jnp.float32))
    return prob, pb


def test_state_bounds_lanes_parity():
    """solve_batch_lanes agrees with jax.vmap(solve) on a batch with finite
    state bounds (same algorithm, lanes layout)."""
    from mahi_mpc.solver.batched import solve_batch_lanes

    prob, pb = _bounded_batch()
    opts = SolverOptions(tol=1e-4, max_iter=60)
    B = 8
    X0 = jnp.zeros((B, prob.N + 1, prob.nx), jnp.float32)
    U0 = jnp.zeros((B, prob.N, prob.nu), jnp.float32)

    ref = jax.jit(jax.vmap(lambda p_, x, u: solve(prob, p_, x, u, opts)))(
        pb, X0, U0)
    got_l = jax.jit(lambda p_, x, u: solve_batch_lanes(prob, p_, x, u, opts))(
        pb, X0, U0)

    vlim = 1.0
    for got in (got_l,):
        ok = (np.asarray(ref.status) == 0) & (np.asarray(got.status) == 0)
        assert ok.mean() >= 0.75, (ref.status, got.status)
        X = np.asarray(got.X)
        assert np.all(np.abs(X[:, 1:, 2:]) <= vlim + 1e-6)
        np.testing.assert_allclose(np.asarray(got.U)[ok],
                                   np.asarray(ref.U)[ok],
                                   atol=5e-3, rtol=5e-3)
    # the bounds bind somewhere in the batch
    Xl = np.asarray(got_l.X)
    assert np.any(np.abs(Xl[:, 1:, 2:]) > vlim - 5e-2)


def test_state_bounds_pariccati_backend_parity():
    """kkt_backend='pariccati' (the O(log N) associative scan) agrees with
    the sequential scan through the full SQP on a state-bounded batch."""
    import mahi_mpc.solver.pariccati  # noqa: F401  (registers the backend)
    from mahi_mpc.solver.batched import solve_batch_lanes

    prob, pb = _bounded_batch(B=4)
    B = 4
    X0 = jnp.zeros((B, prob.N + 1, prob.nx), jnp.float32)
    U0 = jnp.zeros((B, prob.N, prob.nu), jnp.float32)
    opts_scan = SolverOptions(tol=1e-4, max_iter=40, kkt_backend="riccati")
    opts_pal = SolverOptions(tol=1e-4, max_iter=40, kkt_backend="pariccati")

    a = jax.jit(lambda p_, x, u: solve_batch_lanes(prob, p_, x, u, opts_scan))(
        pb, X0, U0)
    b = jax.jit(lambda p_, x, u: solve_batch_lanes(prob, p_, x, u, opts_pal))(
        pb, X0, U0)
    ok = (np.asarray(a.status) == 0) & (np.asarray(b.status) == 0)
    assert ok.mean() >= 0.75, (a.status, b.status)
    np.testing.assert_allclose(np.asarray(b.U)[ok], np.asarray(a.U)[ok],
                               atol=5e-3, rtol=5e-3)
