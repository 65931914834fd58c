"""Latency-shaped fixed-iteration SQP for the single-instance hot path.

The general solver (sqp.py) is throughput-shaped: a `lax.while_loop` over
SQP iterations, each containing a `lax.while_loop` backtracking line search.
Nested data-dependent loops are the right shape for batches (instances
finish early and freeze), but the worst shape for one-solve latency: every
loop iteration is a sequential device round of unknown depth whose predicate
the host reads, and the compiler cannot overlap or pipeline across the
trip-count uncertainty.

This variant is the latency shape (the reference's 1 kHz budget, ``thread_model_control_example.cpp:70-71,108``):

- exactly ``n_iter`` SQP iterations, Python-unrolled at trace time (no
  outer while_loop — straight-line XLA program);
- the backtracking line search replaced by a *parallel fan* of candidate
  steps: merits of ``alpha_max * (1, 1/2, 1/4, 1/16)`` evaluated together
  (one batched dynamics pass), largest Armijo-passing candidate wins.  In
  the warm receding-horizon regime the full step nearly always passes, so
  this matches the adaptive search's accept while removing its sequential
  rounds;
- same QP build, Riccati solve, barrier schedule, and safeguards as
  ``solve`` — a warm-started ``solve_fixed`` at ``n_iter=3`` reproduces the
  steady-state warm solve (tests pin it against ``solve``).

Use for ``ModelControl``-style warm re-solves where the iterate is near the
optimum; cold starts should use ``solve`` (it iterates to tolerance).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..ops.precision import highest_precision
from ..params import SolverOptions
from ..transcribe.shooting import MPCParams, ShootingProblem
from .riccati import resolve_kkt_backend, solve_lqr
from .sqp import (CONVERGED, MAX_ITER, SolveResult, _strict_interior)
from .stage_qp import build_stage_qp, fraction_to_boundary, merit

Array = jnp.ndarray

LS_FAN = (1.0, 0.5, 0.25, 0.0625)


@highest_precision
def solve_fixed(prob: ShootingProblem, p: MPCParams,
                X0: Optional[Array] = None, U0: Optional[Array] = None,
                opts: SolverOptions = SolverOptions(),
                mu0: Optional[Array] = None,
                n_iter: int = 3) -> SolveResult:
    """Exactly ``n_iter`` SQP iterations, no data-dependent control flow.

    Same contract as ``solve`` (warm start via X0/U0, barrier start via
    mu0) minus iteration adaptivity: status is CONVERGED when the final
    Newton step and defects pass ``opts.tol``, MAX_ITER otherwise — a
    warm-started consumer treats MAX_ITER as "still usable, converging".
    """
    nx, nu, N = prob.nx, prob.nu, prob.N
    dtype = p.x0.dtype
    backend = resolve_kkt_backend(opts.kkt_backend)
    if X0 is None:
        X0 = jnp.zeros((N + 1, nx), dtype)
    if U0 is None:
        U0 = jnp.zeros((N, nu), dtype)

    X = jnp.concatenate([
        p.x0[None],
        jax.vmap(lambda x: _strict_interior(x, p.x_min, p.x_max))(X0[1:])])
    U = jax.vmap(lambda u: _strict_interior(u, p.u_min, p.u_max))(U0)

    from . import loop_common as lc
    has_bounds = (jnp.any(jnp.isfinite(p.u_min)) | jnp.any(jnp.isfinite(p.u_max))
                  | jnp.any(jnp.isfinite(p.x_min)) | jnp.any(jnp.isfinite(p.x_max)))
    floor = lc.mu_floor(opts)
    if mu0 is None:
        mu0 = jnp.asarray(opts.warm_mu_factor * opts.tol, dtype)
    mu = lc.mu_start(has_bounds, mu0, floor, opts.mu_min, dtype)
    tol = jnp.asarray(opts.tol, dtype)
    mu_min = jnp.asarray(floor, dtype)
    reg = jnp.asarray(1e-8, dtype)
    nu_pen = jnp.asarray(1.0, dtype)
    fan = jnp.asarray(LS_FAN, dtype)

    step_norm = jnp.asarray(jnp.inf, dtype)
    feas = jnp.asarray(jnp.inf, dtype)

    for _ in range(n_iter):
        qp = build_stage_qp(prob, X, U, p, mu, reg,
                            n_pin=opts.num_control_inputs_saved)
        if backend == "riccati":
            # Fully unrolled scans: no While ops anywhere in the program.
            from .riccati import solve_lqr_scan
            sol = solve_lqr_scan(qp, unroll=True)
        else:
            sol = solve_lqr(qp, backend)
        dX = sol.dz[:, :nx]
        dU = sol.du

        step_norm = jnp.maximum(jnp.max(jnp.abs(dX)), jnp.max(jnp.abs(dU)))
        feas = jnp.max(jnp.abs(qp.r))
        nu_pen = jnp.maximum(nu_pen, 2.0 * jnp.max(jnp.abs(sol.lam)) + 1.0)

        a_u = jax.vmap(lambda u, du: fraction_to_boundary(
            u, du, p.u_min, p.u_max))(U, dU)
        a_x = jax.vmap(lambda x, dx: fraction_to_boundary(
            x, dx, p.x_min, p.x_max))(X[1:], dX[1:])
        alpha_max = jnp.minimum(jnp.min(a_u), jnp.min(a_x))

        m0 = merit(prob, X, U, p, mu, nu_pen)
        ddir = (jnp.sum(qp.gz[1:] * jnp.concatenate(
                    [dX[1:-1], dU[:-1]], axis=1))
                + jnp.sum(qp.gu * dU) + qp.gf @ jnp.concatenate(
                    [dX[-1], dU[-1]])
                - nu_pen * jnp.sum(jnp.abs(qp.r)))
        eps_m = lc.armijo_eps(m0, dtype)

        alphas = alpha_max * fan                                  # (K,)
        merits = jax.vmap(
            lambda a: merit(prob, X + a * dX, U + a * dU, p, mu, nu_pen))(
            alphas)                                               # (K,)
        passing = lc.armijo_pass(merits, m0, alphas, ddir, eps_m)
        # Largest passing candidate (fan is descending); 0 if none pass.
        first = jnp.argmax(passing)                               # first True
        alpha = jnp.where(jnp.any(passing), alphas[first], 0.0)

        X_new = X + alpha * dX
        U_new = U + alpha * dU
        bad = (~jnp.isfinite(alpha) | (~jnp.all(jnp.isfinite(X_new)))
               | (~jnp.all(jnp.isfinite(U_new))))
        X = jnp.where(bad, X, X_new)
        U = jnp.where(bad, U, U_new)
        no_move = bad | (alpha == 0.0)
        reg = lc.reg_update(reg, no_move)
        mu = lc.mu_update(mu, step_norm, feas, tol, mu_min, opts.kappa_mu)

    converged = (step_norm < tol) & (feas < tol)
    status = jnp.where(converged, CONVERGED, MAX_ITER)
    return SolveResult(
        X=X, U=U, iters=jnp.asarray(n_iter, jnp.int32),
        status=status.astype(jnp.int32), kkt=step_norm, feas=feas,
        obj=prob.cost(X, U, p))
