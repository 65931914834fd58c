"""Lanes-batched SQP: the throughput solve for scenario batches.

`jax.vmap(solve)` is correct but lays every dynamics intermediate out with
tiny trailing dims (a (B, N, 3, 3) quantity puts the 3x3 innermost), so
dynamics evaluation dominates a batched SQP iteration.  This module
re-expresses the same algorithm with the *batch x node (x tangent)* product
placed in one trailing "lanes" axis for every dynamics evaluation:

- models are shape-polymorphic with trailing batch (`Dynamics.supports_lanes`),
  so one call evaluates all B*N (or B*N*(nz+1) for the Jacobian tangents)
  dynamics instances as wide elementwise work;
- the QP build, Riccati sweep, and bookkeeping stay batch-first (measured
  cheap) via vmap;
- the outer loop is one `lax.while_loop` over the whole batch with
  per-instance convergence/linesearch masks — identical semantics to
  `jax.vmap(solve)` (tests pin the two against each other).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import numpy as np
import jax.numpy as jnp

from ..ops.precision import highest_precision
from ..params import SolverOptions
from ..transcribe.shooting import MPCParams, ShootingProblem
from .riccati import resolve_kkt_backend, solve_lqr
from .sqp import CONVERGED, DIVERGED, MAX_ITER, SolveResult
from .stage_qp import (barrier_value, build_stage_qp, fraction_to_boundary)

Array = jnp.ndarray


def _lanes_step(prob: ShootingProblem, xs: Array, us: Array) -> Array:
    """Discrete step F on lanes-layout states: xs (nx, M), us (nu, M)."""
    from ..models.integrators import make_step
    return make_step(prob.dynamics.f, prob.dt, prob.integrator)(xs, us)


# ---- LTV (successive-linearization) mode, reference C8 --------------------
# The frozen-linearization step F(x,u) = step of A(x-x0)+B(u-u0)+xd0 is
# affine with *per-instance* (A, B) constant across the horizon
# (``ModelControl.cpp:125-135``), so its discrete Jacobians are one jacfwd
# per instance (not per node) and the defects are batched einsums — simpler
# than the nonlinear lanes path, no dynamics graph at all.

def _ltv_step_one(prob: ShootingProblem, lp, x: Array, u: Array) -> Array:
    from ..models.integrators import make_step
    f = lambda x_, u_: prob.dynamics.linear_f(
        x_, u_, lp.A, lp.B, lp.x_dot0, lp.x0, lp.u0)
    return make_step(f, prob.dt, prob.integrator)(x, u)


def _ltv_discrete(prob: ShootingProblem, p: MPCParams):
    """Exact per-instance discrete affine step for LTV mode:
    ``F(x, u) = Ad x + Bd u + cd`` with Ad (B, nx, nx), Bd (B, nx, nu),
    cd (B, nx).

    An affine continuous-time ``f`` stays affine through every explicit
    integrator (Euler/midpoint/RK4 are compositions of evaluations and
    axpys), so the discrete step is *exactly* affine and its matrices
    depend only on the frozen linearization point ``p.lin`` — compute them
    once per solve, outside the SQP loop, and every defect/merit
    evaluation becomes two batched einsums instead of a nested-vmap of
    tiny scalar graphs — the form that makes LTV mode usable at scale
    (reference C8, ``ModelControl.cpp:125-135``)."""
    nx, nu = prob.nx, prob.nu

    def one(lp):
        joint = lambda w: _ltv_step_one(prob, lp, w[:nx], w[nx:])
        z = jnp.zeros(nx + nu, lp.x0.dtype)
        cd = joint(z)
        J = jax.jacfwd(joint)(z)
        return J[:, :nx], J[:, nx:], cd

    return jax.vmap(one)(p.lin)


def _defects_ltv(prob: ShootingProblem, X: Array, U: Array,
                 p: MPCParams, ltv=None) -> Array:
    """Continuity residuals under the frozen LTV step: (B, N, nx)."""
    Ad, Bd, cd = _ltv_discrete(prob, p) if ltv is None else ltv
    xn = (jnp.einsum("bij,bnj->bni", Ad, X[:, :-1])
          + jnp.einsum("bij,bnj->bni", Bd, U) + cd[:, None])
    return xn - X[:, 1:]


def _linearize_ltv(prob: ShootingProblem, X: Array, U: Array, p: MPCParams,
                   ltv=None):
    """Stage Jacobians for LTV mode: exact everywhere (the step is affine),
    computed once per instance and broadcast over the horizon."""
    B, Np1, nx = X.shape
    N = Np1 - 1
    nu = U.shape[-1]
    Ad, Bd, cd = _ltv_discrete(prob, p) if ltv is None else ltv
    A = jnp.broadcast_to(Ad[:, None], (B, N, nx, nx))
    Bm = jnp.broadcast_to(Bd[:, None], (B, N, nx, nu))
    return A, Bm, _defects_ltv(prob, X, U, p, ltv=(Ad, Bd, cd))


def _defects_lanes(prob: ShootingProblem, X: Array, U: Array) -> Array:
    """Continuity residuals for the whole batch: X (B, N+1, nx) ->
    c (B, N, nx), evaluating all B*N dynamics steps in lanes."""
    B, Np1, nx = X.shape
    N = Np1 - 1
    nu = U.shape[-1]
    xs = X[:, :-1].reshape(B * N, nx).T      # (nx, B*N)
    us = U.reshape(B * N, nu).T              # (nu, B*N)
    xn = _lanes_step(prob, xs, us)           # (nx, B*N)
    return xn.T.reshape(B, N, nx) - X[:, 1:]


def _linearize_lanes(prob: ShootingProblem, X: Array, U: Array,
                     mode: str = "auto"):
    """Stage Jacobians for the whole batch with node x batch in lanes:
    returns A (B, N, nx, nx), Bm (B, N, nx, nu), c (B, N, nx).

    Two paths (pinned against each other in
    tests/test_batched_lanes.py::test_second_order_linearize_parity):

    - **second-order fast path** (Euler step + ``Dynamics.nq`` set): the
      model is ``f = [qd, acc]``, so the step Jacobian is
      ``I + dt * [[0, I, 0], [Jacc]]`` with only the ``nq`` acceleration
      rows needing AD.  Those come from ``nq`` reverse-mode cotangent
      pulls (one shared forward pass) instead of ``nz = nx + nu`` forward
      tangents — for the 4-DOF arm that is 4 backward passes vs 12 JVPs
      through the trig/mass-matrix graph.
    - generic path: the (nz)-tangent JVP fan through the discrete step,
      for RK4 or models without the ``[q, qd]`` structure.

    Both paths take their AD directions in an **unrolled Python loop with
    constant unit (co)tangents**, never ``vmap`` over directions: vmapping
    makes every direction's tangent a dense batched operand, so XLA must
    push all directions through every op; with unrolled constants the
    zeros constant-fold and each direction's graph shrinks to the ops it
    actually touches (e.g. a u-direction tangent never enters the
    trig/mass-matrix chains).  ``SolverOptions.linearize_mode`` picks the
    path ("auto" = fan); neither has been timed on the GPU yet
    (``benchmarks/bench_lin_modes.py`` compares them).
    """
    B, Np1, nx = X.shape
    N = Np1 - 1
    nu = U.shape[-1]
    nz = nx + nu
    dtype = X.dtype
    W = jnp.concatenate([X[:, :-1].reshape(B * N, nx).T,
                         U.reshape(B * N, nu).T], axis=0)  # (nz, M)
    M = W.shape[-1]

    # Formulation policy lives in SolverOptions.linearize_mode (validated
    # here, so a typo cannot be silently baked into a jitted/AOT program).
    if mode not in ("auto", "rev", "fan"):
        raise ValueError(
            f"unknown linearize_mode {mode!r}; choose 'auto', 'rev' or "
            "'fan'")
    nq = prob.dynamics.nq
    rev_ok = (nq is not None and 2 * nq == nx and prob.integrator == "euler")
    if mode == "rev" and not rev_ok:
        raise ValueError(
            "linearize_mode='rev' needs a second-order model (Dynamics.nq "
            "set, nx == 2*nq) and the Euler integrator")
    if mode == "rev" and rev_ok:
        def fw(w):
            return prob.dynamics.f(w[:nx], w[nx:])        # (nx, M)

        f_val, pull = jax.vjp(fw, W)

        rows = []
        for i in range(nq, nx):                            # acc rows of Jf
            e = np.zeros((nx, 1), np.float32)
            e[i] = 1.0
            rows.append(pull(jnp.broadcast_to(
                jnp.asarray(e, dtype), (nx, M)))[0])
        Jacc = jnp.stack(rows)                             # (nq, nz, M)

        dt = jnp.asarray(prob.dt, dtype)
        # Step Jacobian J = [I_nx | 0] + dt * Jf, assembled row-block-wise:
        # position rows are exact (d q_next = dq + dt * d qd), acceleration
        # rows take the pulled Jacc.
        top = (jnp.eye(nx, nz, dtype=dtype)[:nq]
               + dt * jnp.eye(nx, nz, k=nq, dtype=dtype)[:nq])  # (nq, nz)
        top = jnp.broadcast_to(top[:, :, None], (nq, nz, M))
        bot = jnp.eye(nx, nz, dtype=dtype)[nq:, :, None] + dt * Jacc
        J = jnp.concatenate([top, bot], axis=0)            # (nx, nz, M)
        J = jnp.transpose(J, (2, 0, 1)).reshape(B, N, nx, nz)
        val = W[:nx] + dt * f_val                          # Euler step value
        c = val.T.reshape(B, N, nx) - X[:, 1:]
        return J[..., :nx], J[..., nx:], c

    def stepw(w):
        return _lanes_step(prob, w[:nx], w[nx:])

    val = stepw(W)                                         # (nx, M)

    cols = []
    for i in range(nz):                                    # unrolled JVP fan
        e = np.zeros((nz, 1), np.float32)
        e[i] = 1.0
        t = jnp.broadcast_to(jnp.asarray(e, dtype), W.shape)
        cols.append(jax.jvp(stepw, (W,), (t,))[1])         # (nx, M)

    J = jnp.stack(cols)                                    # (nz, nx, M)
    J = jnp.transpose(J, (2, 1, 0)).reshape(B, N, nx, nz)
    c = val.T.reshape(B, N, nx) - X[:, 1:]
    return J[..., :nx], J[..., nx:], c


def _cost_separable_batch(X: Array, U: Array, p: MPCParams) -> Array:
    """Reference cost in separable form, per instance: (B,)."""
    e = X[:, 1:] - p.x_des
    j_track = jnp.einsum("bni,bi->b", e * e, p.q)
    du = jnp.diff(U, axis=1, prepend=p.u_prev[:, None, :])
    j_rate = jnp.einsum("bni,bi->b", du * du, p.r)
    j_mag = jnp.einsum("bni,bi->b", U * U, p.rm)
    ef = X[:, -1] - p.xf_des
    return j_track + j_rate + j_mag + jnp.einsum("bi,bi->b", ef * ef, p.qf)


def _merit_smooth_batch(X: Array, U: Array, p: MPCParams, mu: Array) -> Array:
    """Cost + barrier (everything except the l1 defect penalty): (B,)."""
    J = _cost_separable_batch(X, U, p)
    bar_x = jax.vmap(jax.vmap(barrier_value, in_axes=(0, None, None, None)),
                     in_axes=(0, 0, 0, 0))(X[:, 1:], p.x_min, p.x_max, mu)
    bar_u = jax.vmap(jax.vmap(barrier_value, in_axes=(0, None, None, None)),
                     in_axes=(0, 0, 0, 0))(U, p.u_min, p.u_max, mu)
    return J + bar_x.sum(axis=1) + bar_u.sum(axis=1)


def _merit_batch(prob: ShootingProblem, X: Array, U: Array, p: MPCParams,
                 mu: Array, nu_pen: Array, ltv=None) -> Array:
    """l1 merit per instance (B,): separable cost + barrier + nu|c|_1,
    with the defects evaluated in lanes (LTV: batched affine einsums)."""
    c = (_defects_ltv(prob, X, U, p, ltv=ltv) if prob.is_linear
         else _defects_lanes(prob, X, U))
    return (_merit_smooth_batch(X, U, p, mu)
            + nu_pen * jnp.sum(jnp.abs(c), axis=(1, 2)))


class _LoopState(NamedTuple):
    X: Array
    U: Array
    mu: Array
    reg: Array
    nu_pen: Array
    it: Array
    done: Array
    status: Array
    kkt: Array
    feas: Array


@highest_precision
def solve_batch_lanes(prob: ShootingProblem, p: MPCParams,
                      X0: Optional[Array] = None, U0: Optional[Array] = None,
                      opts: SolverOptions = SolverOptions(),
                      mu0: Optional[Array] = None) -> SolveResult:
    """Batched solve with identical semantics to jax.vmap(solve) — every
    input pytree leaf carries a leading batch axis."""
    assert prob.is_linear or prob.dynamics.supports_lanes, (
        f"dynamics {prob.dynamics.name!r} is not lanes-polymorphic; "
        "use solve_batch (vmap) instead")
    nx, nu, N = prob.nx, prob.nu, prob.N
    B = p.x0.shape[0]
    dtype = p.x0.dtype

    if X0 is None:
        X0 = jnp.zeros((B, N + 1, nx), dtype)
    if U0 is None:
        U0 = jnp.zeros((B, N, nu), dtype)

    from .sqp import _strict_interior
    X0 = jnp.concatenate([
        p.x0[:, None],
        jax.vmap(lambda xs, lo, hi: jax.vmap(
            lambda x: _strict_interior(x, lo, hi))(xs))(
                X0[:, 1:], p.x_min, p.x_max)], axis=1)
    U0 = jax.vmap(lambda us, lo, hi: jax.vmap(
        lambda u: _strict_interior(u, lo, hi))(us))(U0, p.u_min, p.u_max)

    has_bounds = (jnp.any(jnp.isfinite(p.u_min), axis=1)
                  | jnp.any(jnp.isfinite(p.u_max), axis=1)
                  | jnp.any(jnp.isfinite(p.x_min), axis=1)
                  | jnp.any(jnp.isfinite(p.x_max), axis=1))   # (B,)
    from . import loop_common as lc
    floor = lc.mu_floor(opts)
    if mu0 is None:
        mu0 = jnp.asarray(opts.mu_init, dtype)
    mu_init = lc.mu_start(has_bounds, mu0, floor, opts.mu_min, dtype)  # (B,)
    tol = jnp.asarray(opts.tol, dtype)
    mu_min = jnp.asarray(floor, dtype)

    # LTV mode: the exact discrete affine step depends only on the frozen
    # linearization point, so hoist it out of the SQP loop entirely.
    ltv_mats = _ltv_discrete(prob, p) if prob.is_linear else None

    def body(s: _LoopState) -> _LoopState:
        lin = (_linearize_ltv(prob, s.X, s.U, p, ltv=ltv_mats)
               if prob.is_linear
               else _linearize_lanes(prob, s.X, s.U,
                                     mode=opts.linearize_mode))
        qp = jax.vmap(
            lambda X_, U_, p_, mu_, reg_, A_, B_, c_: build_stage_qp(
                prob, X_, U_, p_, mu_, reg_, lin=(A_, B_, c_),
                n_pin=opts.num_control_inputs_saved))(
            s.X, s.U, p, s.mu, s.reg, *lin)
        backend = resolve_kkt_backend(opts.kkt_backend)
        sol = jax.vmap(lambda q: solve_lqr(q, backend))(qp)
        dX = sol.dz[..., :nx]                 # (B, N+1, nx)
        dU = sol.du                            # (B, N, nu)

        step_norm = jnp.maximum(jnp.max(jnp.abs(dX), axis=(1, 2)),
                                jnp.max(jnp.abs(dU), axis=(1, 2)))  # (B,)
        feas = jnp.max(jnp.abs(qp.r), axis=(1, 2))                   # (B,)

        nu_pen = jnp.maximum(
            s.nu_pen, 2.0 * jnp.max(jnp.abs(sol.lam), axis=(1, 2)) + 1.0)

        a_u = jax.vmap(lambda us, dus, lo, hi: jnp.min(jax.vmap(
            lambda u, du: fraction_to_boundary(u, du, lo, hi))(us, dus)))(
            s.U, dU, p.u_min, p.u_max)
        a_x = jax.vmap(lambda xs, dxs, lo, hi: jnp.min(jax.vmap(
            lambda x, dx: fraction_to_boundary(x, dx, lo, hi))(xs, dxs)))(
            s.X[:, 1:], dX[:, 1:], p.x_min, p.x_max)
        alpha_max = jnp.minimum(a_u, a_x)                            # (B,)

        # m0's defects are exactly the linearization residuals already in
        # qp.r — reuse them instead of tracing another full dynamics pass
        # (one fewer f-graph copy in the compiled program).
        r_l1 = jnp.sum(jnp.abs(qp.r), axis=(1, 2))
        m0 = _merit_smooth_batch(s.X, s.U, p, s.mu) + nu_pen * r_l1
        ddir = (jnp.sum(qp.gz[:, 1:] * jnp.concatenate(
                    [dX[:, 1:-1], dU[:, :-1]], axis=2), axis=(1, 2))
                + jnp.sum(qp.gu * dU, axis=(1, 2))
                + jnp.einsum("bi,bi->b", qp.gf, jnp.concatenate(
                    [dX[:, -1], dU[:, -1]], axis=1))
                - nu_pen * r_l1)

        def ls_cond(c):
            a, it, ok = c
            return jnp.any(~ok) & (it < opts.linesearch_steps)

        eps_m = lc.armijo_eps(m0, dtype)

        def ls_body(c):
            a, it, ok = c
            m_new = _merit_batch(prob, s.X + a[:, None, None] * dX,
                                 s.U + a[:, None, None] * dU, p, s.mu,
                                 nu_pen, ltv=ltv_mats)
            pass_ = lc.armijo_pass(m_new, m0, a, ddir, eps_m)
            a_next = jnp.where(ok, a, jnp.where(pass_, a, 0.5 * a))
            return (a_next, it + 1, ok | pass_)

        alpha, _, any_pass = jax.lax.while_loop(
            ls_cond, ls_body,
            (alpha_max, jnp.asarray(0, jnp.int32),
             jnp.zeros(B, bool)))
        alpha = jnp.where(any_pass, alpha, 0.0)

        X_new = s.X + alpha[:, None, None] * dX
        U_new = s.U + alpha[:, None, None] * dU
        bad = (~jnp.isfinite(alpha)
               | ~jnp.all(jnp.isfinite(X_new), axis=(1, 2))
               | ~jnp.all(jnp.isfinite(U_new), axis=(1, 2)))
        X_new = jnp.where(bad[:, None, None], s.X, X_new)
        U_new = jnp.where(bad[:, None, None], s.U, U_new)
        no_move = bad | (alpha == 0.0)
        reg_new = lc.reg_update(s.reg, no_move)
        mu_new = lc.mu_update(s.mu, step_norm, feas, tol, mu_min,
                              opts.kappa_mu)
        converged, diverged = lc.convergence(step_norm, feas, s.mu, reg_new,
                                             tol, mu_min)
        status = jnp.where(converged, CONVERGED,
                           jnp.where(diverged, DIVERGED, s.status))
        done = converged | diverged

        # Freeze instances that are done OR out of iterations — exactly the
        # masking jax.vmap applies to a batched while_loop carry.
        keep = s.done | (s.it >= opts.max_iter)
        selX = lambda new, old: jnp.where(keep[:, None, None], old, new)
        sel = lambda new, old: jnp.where(keep, old, new)
        return _LoopState(
            X=selX(X_new, s.X), U=selX(U_new, s.U), mu=sel(mu_new, s.mu),
            reg=sel(reg_new, s.reg), nu_pen=sel(nu_pen, s.nu_pen),
            it=s.it + jnp.where(keep, 0, 1),
            done=jnp.where(keep, s.done, s.done | done),
            status=sel(status, s.status),
            kkt=sel(step_norm, s.kkt), feas=sel(feas, s.feas))

    def cond(s: _LoopState) -> Array:
        return jnp.any((~s.done) & (s.it < opts.max_iter))

    init = _LoopState(
        X=X0, U=U0, mu=mu_init,
        reg=jnp.full((B,), 1e-8, dtype),
        nu_pen=jnp.ones((B,), dtype),
        it=jnp.zeros((B,), jnp.int32),
        done=jnp.zeros((B,), bool),
        status=jnp.full((B,), MAX_ITER, jnp.int32),
        kkt=jnp.full((B,), jnp.inf, dtype),
        feas=jnp.full((B,), jnp.inf, dtype))

    final = jax.lax.while_loop(cond, body, init)
    obj = _cost_batch_reference(prob, final.X, final.U, p, ltv=ltv_mats)
    return SolveResult(X=final.X, U=final.U, iters=final.it,
                       status=final.status, kkt=final.kkt, feas=final.feas,
                       obj=obj)


def _cost_batch_reference(prob, X, U, p, ltv=None):
    """Reference-form objective per instance (tracking on F(x_k,u_k)).
    ``ltv``: the hoisted discrete affine step for LTV mode — passing it
    avoids re-tracing ``_ltv_discrete`` (a vmapped jacfwd) a second time
    per compiled solve."""
    B, Np1, nx = X.shape
    N = Np1 - 1
    nu = U.shape[-1]
    if prob.is_linear:
        xn = _defects_ltv(prob, X, U, p, ltv=ltv) + X[:, 1:]
    else:
        xs = X[:, :-1].reshape(B * N, nx).T
        us = U.reshape(B * N, nu).T
        xn = _lanes_step(prob, xs, us).T.reshape(B, N, nx)
    e = xn - p.x_des
    j = jnp.einsum("bni,bi->b", e * e, p.q)
    du = jnp.diff(U, axis=1, prepend=p.u_prev[:, None, :])
    j += jnp.einsum("bni,bi->b", du * du, p.r)
    j += jnp.einsum("bni,bi->b", U * U, p.rm)
    ef = X[:, -1] - p.xf_des
    return j + jnp.einsum("bi,bi->b", ef * ef, p.qf)
