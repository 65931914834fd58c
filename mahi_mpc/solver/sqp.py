"""Batched structured SQP / interior-point driver.

The replacement for the reference's IPOPT solve
(``ModelControl.cpp:159``; settings tol 1e-5 / max_iter 200,
``ModelControl.cpp:52-59``): a Gauss-Newton SQP over the multiple-shooting
NLP, box bounds handled by a monotone log-barrier (Fiacco-McCormick, the same
family IPOPT implements), each barrier-Newton step solved exactly by the
Riccati backend, globalized by an l1-merit backtracking line search with
fraction-to-boundary stepsizes.

Everything is fixed-shape and jit-compatible: the outer loop is a
`lax.while_loop` with per-instance convergence masks, the line search
evaluates a fixed fan of candidate steps, and failure is carried as a status
code per instance (SURVEY.md §5 failure detection: per-instance SQP status
flags, never an exception mid-batch).  Batch over instances with
`jax.vmap(solve, ...)` (`solve_batch`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.precision import highest_precision
from ..params import SolverOptions
from ..transcribe.shooting import MPCParams, ShootingProblem
from .riccati import solve_lqr
from .stage_qp import build_stage_qp, fraction_to_boundary, merit

Array = jnp.ndarray

# Status codes (SURVEY.md §5: per-instance status carried in the batch).
CONVERGED = 0
MAX_ITER = 1
DIVERGED = 2


class SolveResult(NamedTuple):
    X: Array        # (N+1, nx)
    U: Array        # (N, nu)
    iters: Array    # int32, SQP iterations taken
    status: Array   # int32: 0 converged / 1 max_iter / 2 diverged
    kkt: Array      # final Newton-step inf-norm (stationarity proxy)
    feas: Array     # final defect inf-norm
    obj: Array      # reference-form objective at the solution


jax.export.register_namedtuple_serialization(
    SolveResult, serialized_name="mahi_mpc.SolveResult")


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


def _strict_interior(v: Array, lo: Array, hi: Array, delta: float = 1e-3) -> Array:
    """Clip into the strict interior of a (possibly infinite) box so barrier
    terms are well-defined at the initial iterate."""
    width = jnp.where(jnp.isfinite(lo) & jnp.isfinite(hi), hi - lo, jnp.inf)
    d = jnp.minimum(delta, 0.25 * width)
    lo_c = jnp.where(jnp.isfinite(lo), lo + d, -jnp.inf)
    hi_c = jnp.where(jnp.isfinite(hi), hi - d, jnp.inf)
    return jnp.clip(v, lo_c, hi_c)


@highest_precision
def solve(prob: ShootingProblem, p: MPCParams,
          X0: Optional[Array] = None, U0: Optional[Array] = None,
          opts: SolverOptions = SolverOptions(),
          mu0: Optional[Array] = None) -> SolveResult:
    """Solve one receding-horizon NLP instance.  Warm-start with (X0, U0)
    (reference C7: previous optimum seeds the next solve,
    ``ModelControl.cpp:161``); zero-init otherwise (``ModelControl.cpp:29-45``).

    mu0: optional runtime barrier start (a traced scalar — same compiled
    program).  Warm receding-horizon re-solves pass a small value (e.g.
    10*tol) to skip the barrier descent from ``opts.mu_init``, cutting
    iterations by ~3-5x; cold solves should leave it None.
    """
    nx, nu, N = prob.nx, prob.nu, prob.N
    dtype = p.x0.dtype
    if X0 is None:
        X0 = jnp.zeros((N + 1, nx), dtype)
    if U0 is None:
        U0 = jnp.zeros((N, nu), dtype)

    # Node 0 is pinned to the measurement; interior-clip the rest.
    X0 = jnp.concatenate([
        p.x0[None],
        jax.vmap(lambda x: _strict_interior(x, p.x_min, p.x_max))(X0[1:])])
    U0 = jax.vmap(lambda u: _strict_interior(u, p.u_min, p.u_max))(U0)

    from . import loop_common as lc
    has_bounds = (jnp.any(jnp.isfinite(p.u_min)) | jnp.any(jnp.isfinite(p.u_max))
                  | jnp.any(jnp.isfinite(p.x_min)) | jnp.any(jnp.isfinite(p.x_max)))
    if mu0 is None:
        mu0 = jnp.asarray(opts.mu_init, dtype)
    floor = lc.mu_floor(opts)
    mu0 = lc.mu_start(has_bounds, mu0, floor, opts.mu_min, dtype)
    tol = jnp.asarray(opts.tol, dtype)
    mu_min = jnp.asarray(floor, dtype)

    def body(s: _LoopState) -> _LoopState:
        qp = build_stage_qp(prob, s.X, s.U, p, s.mu, s.reg,
                            n_pin=opts.num_control_inputs_saved)
        sol = solve_lqr(qp, opts.kkt_backend)
        dX = sol.dz[:, :nx]
        dU = sol.du

        step_norm = jnp.maximum(jnp.max(jnp.abs(dX)), jnp.max(jnp.abs(dU)))
        feas = jnp.max(jnp.abs(qp.r))

        # l1 penalty weight from multiplier estimates (monotone nondecreasing).
        nu_pen = jnp.maximum(s.nu_pen, 2.0 * jnp.max(jnp.abs(sol.lam)) + 1.0)

        # Fraction-to-boundary cap, then a fan of backtracking candidates.
        a_u = jax.vmap(lambda u, du: fraction_to_boundary(u, du, p.u_min, p.u_max))(s.U, dU)
        a_x = jax.vmap(lambda x, dx: fraction_to_boundary(x, dx, p.x_min, p.x_max))(
            s.X[1:], dX[1:])
        alpha_max = jnp.minimum(jnp.min(a_u), jnp.min(a_x))

        m0 = merit(prob, s.X, s.U, p, s.mu, nu_pen)
        # Directional derivative of the merit along the step.
        ddir = (jnp.sum(qp.gz[1:] * jnp.concatenate(
                    [dX[1:-1], dU[:-1]], axis=1))
                + jnp.sum(qp.gu * dU) + qp.gf @ jnp.concatenate(
                    [dX[-1], dU[-1]])
                - nu_pen * jnp.sum(jnp.abs(qp.r)))

        def try_alpha(a):
            return merit(prob, s.X + a * dX, s.U + a * dU, p, s.mu, nu_pen)

        # Adaptive backtracking: evaluate the full (fraction-to-boundary
        # capped) step first and halve only on Armijo failure.  A merit
        # evaluation costs a full horizon of dynamics evals — in the warm
        # receding-horizon steady state the first candidate nearly always
        # passes, so this does 1 evaluation where a fixed fan does
        # `linesearch_steps` (the profiled 542 ms -> ~35 ms at batch 1024).
        def ls_cond(c):
            a, m, it, ok = c
            return (~ok) & (it < opts.linesearch_steps)

        eps_m = lc.armijo_eps(m0, dtype)

        def ls_body(c):
            a, m, it, ok = c
            m_new = try_alpha(a)
            pass_ = lc.armijo_pass(m_new, m0, a, ddir, eps_m)
            a_next = jnp.where(pass_, a, 0.5 * a)
            return (a_next, jnp.where(pass_, m_new, m), it + 1, pass_)

        alpha, _, _, any_pass = jax.lax.while_loop(
            ls_cond, ls_body,
            (alpha_max, jnp.asarray(jnp.inf, dtype),
             jnp.asarray(0, jnp.int32), jnp.asarray(False)))
        alpha = jnp.where(any_pass, alpha, 0.0)

        X_new = s.X + alpha * dX
        U_new = s.U + alpha * dU
        bad = ~jnp.isfinite(alpha) | (~jnp.all(jnp.isfinite(X_new))) | (
            ~jnp.all(jnp.isfinite(U_new)))
        X_new = jnp.where(bad, s.X, X_new)
        U_new = jnp.where(bad, s.U, U_new)
        no_move = bad | (alpha == 0.0)
        reg_new = lc.reg_update(s.reg, no_move)
        mu_new = lc.mu_update(s.mu, step_norm, feas, tol, mu_min,
                              opts.kappa_mu)
        converged, diverged = lc.convergence(step_norm, feas, s.mu, reg_new,
                                             tol, mu_min)
        status = jnp.where(converged, CONVERGED,
                           jnp.where(diverged, DIVERGED, s.status))
        done = converged | diverged

        # Freeze finished instances (same masking as the batched drivers;
        # under jax.vmap the while_loop batching rule also selects on cond,
        # so this is the belt to that suspenders).
        keep = s.done | (s.it >= opts.max_iter)
        sel = lambda new, old: jnp.where(keep, old, new)
        return _LoopState(
            X=sel(X_new, s.X), U=sel(U_new, s.U), mu=sel(mu_new, s.mu),
            reg=sel(reg_new, s.reg), nu_pen=sel(nu_pen, s.nu_pen),
            it=s.it + jnp.where(keep, 0, 1),
            done=s.done | done, status=sel(status, s.status),
            kkt=sel(step_norm, s.kkt), feas=sel(feas, s.feas))

    def cond(s: _LoopState) -> Array:
        return (~s.done) & (s.it < opts.max_iter)

    init = _LoopState(
        X=X0, U=U0, mu=mu0, reg=jnp.asarray(1e-8, dtype),
        nu_pen=jnp.asarray(1.0, dtype), it=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False), status=jnp.asarray(MAX_ITER, jnp.int32),
        kkt=jnp.asarray(jnp.inf, dtype), feas=jnp.asarray(jnp.inf, dtype))

    final = jax.lax.while_loop(cond, body, init)
    return SolveResult(
        X=final.X, U=final.U, iters=final.it, status=final.status,
        kkt=final.kkt, feas=final.feas, obj=prob.cost(final.X, final.U, p))


def solve_batch(prob: ShootingProblem, p_batch: MPCParams,
                X0: Optional[Array] = None, U0: Optional[Array] = None,
                opts: SolverOptions = SolverOptions(),
                mu0: Optional[Array] = None) -> SolveResult:
    """vmap the whole solve over a leading scenario-batch axis of the params
    (and optional warm starts) — the reference has one instance per process
    (SURVEY.md §2.b); here thousands share one program."""
    in_axes = (0, 0 if X0 is not None else None, 0 if U0 is not None else None)
    fn = lambda pp, xx, uu: solve(prob, pp, xx, uu, opts, mu0=mu0)
    return jax.vmap(fn, in_axes=in_axes)(p_batch, X0, U0)
