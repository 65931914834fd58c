"""Lanes-batched solver vs vmapped reference solver: identical semantics."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mahi_mpc import ModelParameters, SolverOptions
from mahi_mpc.models import make_dynamics
from mahi_mpc.solver import solve
from mahi_mpc.solver.batched import (_defects_lanes, _linearize_lanes,
                                         solve_batch_lanes)
from mahi_mpc.transcribe.shooting import default_params, make_problem


def _setup(model="double_pendulum", B=8, N=12, bounded=True):
    dyn = make_dynamics(model)
    lim = 40.0
    mp = ModelParameters(
        "lanes_t", num_x=dyn.nx, num_u=dyn.nu, step_size=0.01,
        num_shooting_nodes=N,
        u_min=[-lim] * dyn.nu if bounded else [],
        u_max=[lim] * dyn.nu if bounded else [])
    prob = make_problem(mp, dyn)
    rng = np.random.default_rng(0)
    p = default_params(mp)
    p = p._replace(q=jnp.full((dyn.nx,), 10.0), r=jnp.full((dyn.nu,), 0.5),
                   rm=jnp.full((dyn.nu,), 0.01))
    pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p)
    pb = pb._replace(
        x0=jnp.asarray(0.2 * rng.standard_normal((B, dyn.nx)), jnp.float32),
        x_des=jnp.asarray(0.2 * rng.standard_normal((B, N, dyn.nx)),
                          jnp.float32))
    return prob, pb


def test_lanes_defects_and_linearize_match_vmap():
    prob, pb = _setup()
    B, N = 8, 12
    rng = np.random.default_rng(1)
    X = jnp.asarray(rng.standard_normal((B, N + 1, prob.nx)) * 0.1, jnp.float32)
    U = jnp.asarray(rng.standard_normal((B, N, prob.nu)) * 0.1, jnp.float32)

    c_l = _defects_lanes(prob, X, U)
    c_v = jax.vmap(lambda X_, U_, p_: prob.defects(X_, U_, p_))(X, U, pb)
    np.testing.assert_allclose(np.asarray(c_l), np.asarray(c_v),
                               rtol=1e-6, atol=1e-6)

    A_l, B_l, cc_l = _linearize_lanes(prob, X, U)
    A_v, B_v, cc_v = jax.vmap(
        lambda X_, U_, p_: prob.linearize_stages(X_, U_, p_))(X, U, pb)
    np.testing.assert_allclose(np.asarray(A_l), np.asarray(A_v),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(B_l), np.asarray(B_v),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(cc_l), np.asarray(cc_v),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("model", [
    "double_pendulum",
    pytest.param("mahi_arm", marks=pytest.mark.slow),
])
def test_lanes_solver_matches_vmap(model):
    """Identical algorithm; float32 op-order differs (lanes vs vmap layout),
    so borderline instances may take one extra/fewer iteration near the
    tolerance.  Require: most instances converge in both, and converged
    solutions agree."""
    prob, pb = _setup(model=model)
    opts = SolverOptions(tol=1e-4, max_iter=60)
    B = 8
    X0 = jnp.zeros((B, prob.N + 1, prob.nx), jnp.float32)
    U0 = jnp.zeros((B, prob.N, prob.nu), jnp.float32)

    ref = jax.jit(jax.vmap(lambda p_, x, u: solve(prob, p_, x, u, opts)))(
        pb, X0, U0)
    got = jax.jit(lambda p_, x, u: solve_batch_lanes(prob, p_, x, u, opts))(
        pb, X0, U0)

    ok_ref = np.asarray(ref.status) == 0
    ok_got = np.asarray(got.status) == 0
    assert ok_got.mean() >= 0.8, got.status
    assert ok_ref.mean() >= 0.8, ref.status
    both = ok_ref & ok_got
    assert both.mean() >= 0.75
    np.testing.assert_allclose(np.asarray(got.U)[both],
                               np.asarray(ref.U)[both],
                               rtol=5e-3, atol=5e-3)


def test_lanes_solver_unbounded():
    prob, pb = _setup(bounded=False)
    opts = SolverOptions(tol=1e-5, max_iter=40)
    B = 8
    got = solve_batch_lanes(prob, pb, None, None, opts)
    assert np.all(np.asarray(got.status) == 0), got.status
    assert float(jnp.max(got.feas)) < 1e-5


def test_lanes_warm_start_and_mu0():
    prob, pb = _setup()
    opts = SolverOptions(tol=1e-5, max_iter=40)
    cold = solve_batch_lanes(prob, pb, None, None, opts)
    warm = solve_batch_lanes(prob, pb, cold.X, cold.U, opts,
                             mu0=jnp.float32(10 * opts.tol))
    assert float(jnp.mean(warm.iters)) <= float(jnp.mean(cold.iters))
    np.testing.assert_allclose(np.asarray(warm.U), np.asarray(cold.U),
                               atol=5e-3)


def test_lanes_solver_ltv_mode():
    """LTV (successive-linearization, reference C8) through the lanes path:
    per-instance frozen (A, B), identical results to jax.vmap(solve)."""
    from mahi_mpc.transcribe.shooting import LinPoint

    dyn = make_dynamics("double_pendulum")
    B, N = 8, 12
    mp = ModelParameters(
        "lanes_ltv", num_x=dyn.nx, num_u=dyn.nu, step_size=0.01,
        num_shooting_nodes=N, is_linear=True,
        u_min=[-40.0] * dyn.nu, u_max=[40.0] * dyn.nu)
    prob = make_problem(mp, dyn)
    rng = np.random.default_rng(5)
    p = default_params(mp)
    p = p._replace(q=jnp.full((dyn.nx,), 10.0), r=jnp.full((dyn.nu,), 0.5),
                   rm=jnp.full((dyn.nu,), 0.01))
    pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p)
    x0 = jnp.asarray(0.2 * rng.standard_normal((B, dyn.nx)), jnp.float32)
    u0 = jnp.asarray(0.1 * rng.standard_normal((B, dyn.nu)), jnp.float32)
    A, Bm, xd0 = jax.vmap(dyn.linearize)(x0, u0)
    pb = pb._replace(
        x0=x0, u_prev=u0,
        x_des=jnp.asarray(0.2 * rng.standard_normal((B, N, dyn.nx)),
                          jnp.float32),
        lin=LinPoint(A, Bm, xd0, x0, u0))

    opts = SolverOptions(tol=1e-5, max_iter=40)
    X0 = jnp.zeros((B, prob.N + 1, prob.nx), jnp.float32)
    U0 = jnp.zeros((B, prob.N, prob.nu), jnp.float32)

    ref = jax.jit(jax.vmap(lambda p_, x, u: solve(prob, p_, x, u, opts)))(
        pb, X0, U0)
    got = jax.jit(lambda p_, x, u: solve_batch_lanes(prob, p_, x, u, opts))(
        pb, X0, U0)

    ok = (np.asarray(ref.status) == 0) & (np.asarray(got.status) == 0)
    assert ok.mean() >= 0.9, (ref.status, got.status)
    np.testing.assert_allclose(np.asarray(got.U)[ok], np.asarray(ref.U)[ok],
                               atol=2e-3, rtol=2e-3)
    # Same barrier schedule => same iteration counts as the vmapped path
    # (up to one borderline step).
    assert abs(float(np.mean(np.asarray(got.iters)[ok]))
               - float(np.mean(np.asarray(ref.iters)[ok]))) <= 1.0


@pytest.mark.parametrize("model,integrator,mode", [
    pytest.param("mahi_arm", "euler", "rev", marks=pytest.mark.slow),
    ("two_link_arm", "euler", "rev"),  # reverse path
    pytest.param("mahi_arm", "euler", "auto", marks=pytest.mark.slow),
    pytest.param("mahi_arm", "rk4", "auto", marks=pytest.mark.slow),
])
def test_second_order_linearize_parity(model, integrator, mode):
    """Every SolverOptions.linearize_mode formulation of _linearize_lanes
    matches the vmapped jacfwd reference: the second-order reverse rows
    (Dynamics.nq + Euler), the unrolled fan, and the RK4 fallback."""
    dyn = make_dynamics(model)
    mp = ModelParameters(
        "lin_t", num_x=dyn.nx, num_u=dyn.nu, step_size=0.005,
        num_shooting_nodes=7, u_min=[-30.0] * dyn.nu, u_max=[30.0] * dyn.nu,
        integrator=integrator)
    prob = make_problem(mp, dyn)
    B, N = 4, 7
    rng = np.random.default_rng(3)
    X = jnp.asarray(rng.standard_normal((B, N + 1, dyn.nx)) * 0.3, jnp.float32)
    U = jnp.asarray(rng.standard_normal((B, N, dyn.nu)) * 2.0, jnp.float32)
    p = default_params(mp)
    pb = jax.tree.map(lambda a: jnp.broadcast_to(a, (B,) + a.shape), p)

    A_l, B_l, c_l = _linearize_lanes(prob, X, U, mode=mode)
    A_v, B_v, c_v = jax.vmap(
        lambda X_, U_, p_: prob.linearize_stages(X_, U_, p_))(X, U, pb)
    np.testing.assert_allclose(np.asarray(A_l), np.asarray(A_v),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(B_l), np.asarray(B_v),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(c_l), np.asarray(c_v),
                               rtol=1e-5, atol=1e-5)
