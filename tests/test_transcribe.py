"""Transcription-layer tests: layout parity with the reference NLP."""

import numpy as np
import jax
import jax.numpy as jnp

from mahi_mpc import ModelParameters
from mahi_mpc.models import make_double_pendulum
from mahi_mpc.transcribe.shooting import (
    LinPoint, default_params, make_problem)

jax.config.update("jax_enable_x64", True)


def _setup(is_linear=False, N=7):
    mp = ModelParameters("dp", num_x=4, num_u=2, step_size=0.002,
                         num_shooting_nodes=N, is_linear=is_linear)
    dyn = make_double_pendulum()
    prob = make_problem(mp, dyn)
    rng = np.random.default_rng(3)
    X = jnp.array(rng.normal(size=(N + 1, 4)))
    U = jnp.array(rng.normal(size=(N, 2)))
    p = default_params(mp, dtype=jnp.float64)
    p = p._replace(x_des=jnp.array(rng.normal(size=(N, 4))),
                   q=jnp.array([10.0, 1.0, 5.0, 5.0]),
                   r=jnp.array([5.0, 5.0]), rm=jnp.array([0.5, 0.25]),
                   u_prev=jnp.array(rng.normal(size=2)),
                   x0=X[0])
    if is_linear:
        A, B, xd0 = dyn.linearize(p.x0, p.u_prev)
        p = p._replace(lin=LinPoint(A, B, xd0, p.x0, p.u_prev))
    return mp, prob, X, U, p


def test_pack_unpack_roundtrip():
    _, prob, X, U, _ = _setup()
    v = prob.pack_v(X, U)
    assert v.shape == (prob.nv,)
    X2, U2 = prob.unpack_v(v)
    np.testing.assert_array_equal(np.asarray(X), np.asarray(X2))
    np.testing.assert_array_equal(np.asarray(U), np.asarray(U2))
    # interleaved order: [x_0, u_0, x_1, u_1, ..., x_N] (ModelGenerator.cpp:86-112)
    np.testing.assert_array_equal(np.asarray(v[:4]), np.asarray(X[0]))
    np.testing.assert_array_equal(np.asarray(v[4:6]), np.asarray(U[0]))
    np.testing.assert_array_equal(np.asarray(v[6:10]), np.asarray(X[1]))


def test_cost_matches_manual():
    _, prob, X, U, p = _setup()
    dt = prob.dt
    dyn = prob.dynamics
    J_manual = 0.0
    Q, R, Rm = np.diag(np.asarray(p.q)), np.diag(np.asarray(p.r)), np.diag(np.asarray(p.rm))
    u_last = np.asarray(p.u_prev)
    for k in range(prob.N):
        xk, uk = np.asarray(X[k]), np.asarray(U[k])
        x_next = xk + np.asarray(dyn(jnp.array(xk), jnp.array(uk))) * dt
        e = x_next - np.asarray(p.x_des[k])
        du = uk - u_last
        J_manual += e @ Q @ e + du @ R @ du + uk @ Rm @ uk
        u_last = uk
    assert abs(float(prob.cost(X, U, p)) - J_manual) < 1e-9 * max(1, abs(J_manual))


def test_defects_zero_on_rollout_and_costs_agree():
    _, prob, X, U, p = _setup()
    Xr = prob.rollout(p.x0, U, p)
    c = prob.defects(Xr, U, p)
    # scan (rollout) vs vmap (defects) evaluate the same step; XLA may
    # reassociate, so allow roundoff-level slack
    assert float(jnp.max(jnp.abs(c))) < 1e-8
    # on the constraint manifold the reference cost and the separable cost agree
    assert abs(float(prob.cost(Xr, U, p)) - float(prob.cost_separable(Xr, U, p))) < 1e-9


def test_ref_param_vector_layout():
    for is_linear in (False, True):
        mp, prob, X, U, p = _setup(is_linear=is_linear)
        flat = prob.pack_ref_params(p)
        assert flat.shape == (mp.num_params,), (is_linear, flat.shape, mp.num_params)
        p2 = prob.unpack_ref_params(flat, default_params(mp, dtype=jnp.float64))
        np.testing.assert_allclose(np.asarray(p2.x_des), np.asarray(p.x_des))
        np.testing.assert_allclose(np.asarray(p2.q), np.asarray(p.q))
        np.testing.assert_allclose(np.asarray(p2.u_prev), np.asarray(p.u_prev))
        if is_linear:
            np.testing.assert_allclose(np.asarray(p2.lin.A), np.asarray(p.lin.A))
            np.testing.assert_allclose(np.asarray(p2.lin.B), np.asarray(p.lin.B))


def test_bounds_layout():
    mp, prob, X, U, p = _setup()
    p = p._replace(u_min=jnp.array([-3.0, -2.0]), u_max=jnp.array([3.0, 2.0]))
    lo, hi = prob.bounds_v(p)
    assert lo.shape == (prob.nv,)
    # node-0 state pinched to the measurement (ModelControl.cpp:144-145)
    np.testing.assert_array_equal(np.asarray(lo[:4]), np.asarray(p.x0))
    np.testing.assert_array_equal(np.asarray(hi[:4]), np.asarray(p.x0))
    # control bounds stamped each node (ModelControl.cpp:148-154)
    np.testing.assert_array_equal(np.asarray(lo[4:6]), [-3.0, -2.0])
    np.testing.assert_array_equal(np.asarray(hi[4:6]), [3.0, 2.0])


def test_linearize_stages_matches_fd():
    _, prob, X, U, p = _setup()
    A, B, c = prob.linearize_stages(X, U, p)
    assert A.shape == (prob.N, 4, 4) and B.shape == (prob.N, 4, 2)
    np.testing.assert_allclose(np.asarray(c), np.asarray(prob.defects(X, U, p)),
                               atol=1e-12)
    k, eps = 2, 1e-6
    for i in range(4):
        dx = jnp.zeros(4).at[i].set(eps)
        fd = (prob.step(X[k] + dx, U[k], p) - prob.step(X[k] - dx, U[k], p)) / (2 * eps)
        np.testing.assert_allclose(np.asarray(A[k][:, i]), np.asarray(fd),
                                   rtol=1e-5, atol=1e-7)


def test_linear_mode_step_is_affine():
    mp, prob, X, U, p = _setup(is_linear=True)
    # step must be exactly affine in (x, u): zero second differences
    d = jnp.array([0.1, -0.2, 0.3, 0.05])
    s0 = prob.step(X[0], U[0], p)
    s1 = prob.step(X[0] + d, U[0], p)
    s2 = prob.step(X[0] + 2 * d, U[0], p)
    np.testing.assert_allclose(np.asarray(s2 - s1), np.asarray(s1 - s0),
                               rtol=1e-9, atol=1e-12)
