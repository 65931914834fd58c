"""Stagewise QP construction for the structured SQP.

Each SQP iteration linearizes the multiple-shooting NLP (SURVEY.md §7.3) into
an equality-constrained LQR problem over the *augmented* state

    z_k = [x_k ; u_{k-1}],   k = 0..N,   with u_{-1} = u_prev,

which absorbs the input-rate coupling ``(u_k - u_{k-1})' R (u_k - u_{k-1})``
(reference cost, ``ModelGenerator.cpp:217-218``) into a stagewise cost — the
stage-banded KKT matrix that IPOPT hands to MUMPS (``ModelControl.cpp:56``)
becomes a block-tridiagonal system solved by Riccati recursion instead.

Box bounds (``ModelParameters.hpp:22-25``, runtime-stamped in
``ModelControl.cpp:144-154``) enter as primal log-barrier terms with masked
contributions where a bound is infinite, so the unbounded case reduces to pure
equality-constrained Gauss-Newton (cost is exactly quadratic in the separable
form, so Gauss-Newton == exact Newton here, up to constraint curvature).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..transcribe.shooting import MPCParams, ShootingProblem

Array = jnp.ndarray


class StageQP(NamedTuple):
    """Quantities of one LQR subproblem (leading axis = horizon N unless
    noted).  Cost convention: J(dw) = g' dw + 1/2 dw' H dw."""

    Az: Array   # (N, nz, nz) augmented dynamics dz_{k+1} = Az dz + Bz du + r
    Bz: Array   # (N, nz, nu)
    r: Array    # (N, nz)   defects [c_k ; 0]
    Hzz: Array  # (N, nz, nz)
    Hzu: Array  # (N, nz, nu)
    Huu: Array  # (N, nu, nu)
    gz: Array   # (N, nz)
    gu: Array   # (N, nu)
    Hf: Array   # (nz, nz) terminal
    gf: Array   # (nz,)


def barrier_terms(v: Array, lo: Array, hi: Array, mu: Array
                  ) -> Tuple[Array, Array]:
    """Gradient and Hessian-diagonal of -mu*[log(v-lo)+log(hi-v)], with each
    side masked out where its bound is infinite."""
    lo_fin = jnp.isfinite(lo)
    hi_fin = jnp.isfinite(hi)
    slo = jnp.where(lo_fin, v - lo, 1.0)
    shi = jnp.where(hi_fin, hi - v, 1.0)
    g = jnp.where(lo_fin, -mu / slo, 0.0) + jnp.where(hi_fin, mu / shi, 0.0)
    h = jnp.where(lo_fin, mu / (slo * slo), 0.0) + jnp.where(hi_fin, mu / (shi * shi), 0.0)
    return g, h


def barrier_value(v: Array, lo: Array, hi: Array, mu: Array) -> Array:
    lo_fin = jnp.isfinite(lo)
    hi_fin = jnp.isfinite(hi)
    slo = jnp.where(lo_fin, jnp.maximum(v - lo, 1e-30), 1.0)
    shi = jnp.where(hi_fin, jnp.maximum(hi - v, 1e-30), 1.0)
    return -jnp.sum(mu * (jnp.where(lo_fin, jnp.log(slo), 0.0)
                          + jnp.where(hi_fin, jnp.log(shi), 0.0)))


def build_stage_qp(prob: ShootingProblem, X: Array, U: Array, p: MPCParams,
                   mu: Array, reg: Array, lin=None, n_pin: int = 0) -> StageQP:
    """Linearize + quadraticize at the iterate (X, U).

    mu: barrier parameter (scalar); reg: Levenberg regularization added to
    Huu (scalar).  lin: optional precomputed (A, B, c) stage linearization
    (the lanes-batched solver computes it once for the whole batch with the
    node/tangent product as one trailing axis — solver/batched.py).

    n_pin: freeze the first ``n_pin`` controls at their current iterate
    values (working version of the reference's ``m_num_control_inputs_saved``
    head-control pinning, a no-op there — ``ModelControl.cpp:165-171``,
    ``hpp:79``).  Implemented purely in the QP: pinned stages get Bz = 0,
    Hzu = 0, gu = 0, Huu = I, which makes every KKT backend return
    du_k = 0 exactly, with the state prediction still flowing through the
    frozen u_k via the defect linearization.
    """
    nx, nu, N = prob.nx, prob.nu, prob.N
    nz = nx + nu
    dtype = X.dtype

    A, B, c = (prob.linearize_stages(X, U, p) if lin is None
               else lin)  # (N,nx,nx), (N,nx,nu), (N,nx)

    # Augmented dynamics dz_{k+1} = [A dx + B du + c ; du].
    Az = jnp.zeros((N, nz, nz), dtype).at[:, :nx, :nx].set(A)
    Bz = (jnp.zeros((N, nz, nu), dtype)
          .at[:, :nx, :].set(B)
          .at[:, nx:, :].set(jnp.eye(nu, dtype=dtype)))
    r = jnp.concatenate([c, jnp.zeros((N, nu), dtype)], axis=1)

    twoQ = 2.0 * p.q       # (nx,) diagonal of the tracking Hessian
    twoR = 2.0 * p.r
    twoRm = 2.0 * p.rm

    # Tracking cost sits on x_k for k>=1 (separable form; see
    # ShootingProblem.cost_separable).  Stage k holds the x_k term.
    e = X[:-1] - jnp.concatenate([X[:1], p.x_des[:-1]], axis=0)  # e_0 unused
    track_on = jnp.arange(N, dtype=dtype) >= 1.0                 # k=0: x_0 fixed
    du = U - jnp.concatenate([p.u_prev[None], U[:-1]], axis=0)

    # Barrier contributions.
    gx_b, hx_b = jax.vmap(lambda x: barrier_terms(x, p.x_min, p.x_max, mu))(X[:-1])
    gu_b, hu_b = jax.vmap(lambda u: barrier_terms(u, p.u_min, p.u_max, mu))(U)
    # No barrier on node 0 (pinned to the measurement, ModelControl.cpp:144-145).
    gx_b = gx_b * track_on[:, None]
    hx_b = hx_b * track_on[:, None]

    gz = jnp.concatenate(
        [track_on[:, None] * (twoQ * e) + gx_b, -(twoR * du)], axis=1)
    gu = twoR * du + twoRm * U + gu_b

    Hzz = jnp.zeros((N, nz, nz), dtype)
    diag_idx = jnp.arange(nx)
    Hzz = Hzz.at[:, diag_idx, diag_idx].set(track_on[:, None] * twoQ + hx_b)
    udiag = jnp.arange(nu)
    Hzz = Hzz.at[:, nx + udiag, nx + udiag].set(jnp.broadcast_to(twoR, (N, nu)))
    Hzu = jnp.zeros((N, nz, nu), dtype).at[:, nx + udiag, udiag].set(
        jnp.broadcast_to(-twoR, (N, nu)))
    Huu = (jnp.zeros((N, nu, nu), dtype)
           .at[:, udiag, udiag].set(twoR + twoRm + hu_b + reg))

    # Terminal: tracking on x_N, the extension terminal cost qf, and the
    # terminal barrier.
    eN = X[-1] - p.x_des[-1]
    eF = X[-1] - p.xf_des
    twoQf = 2.0 * p.qf
    gN_b, hN_b = barrier_terms(X[-1], p.x_min, p.x_max, mu)
    Hf = jnp.zeros((nz, nz), dtype).at[diag_idx, diag_idx].set(
        twoQ + twoQf + hN_b)
    gf = jnp.concatenate([twoQ * eN + twoQf * eF + gN_b,
                          jnp.zeros(nu, dtype)])

    if not (isinstance(n_pin, int) and n_pin == 0):
        pin = jnp.arange(N) < n_pin
        eye_u = jnp.eye(nu, dtype=dtype)
        Bz = jnp.where(pin[:, None, None], 0.0, Bz)
        Hzu = jnp.where(pin[:, None, None], 0.0, Hzu)
        gu = jnp.where(pin[:, None], 0.0, gu)
        Huu = jnp.where(pin[:, None, None], eye_u, Huu)

    return StageQP(Az, Bz, r, Hzz, Hzu, Huu, gz, gu, Hf, gf)


def merit(prob: ShootingProblem, X: Array, U: Array, p: MPCParams,
          mu: Array, nu_pen: Array) -> Array:
    """l1 merit function on the barrier subproblem:
    separable cost + barrier - nu * ||defects||_1."""
    J = prob.cost_separable(X, U, p)
    bar = (jax.vmap(lambda x: barrier_value(x, p.x_min, p.x_max, mu))(X[1:]).sum()
           + jax.vmap(lambda u: barrier_value(u, p.u_min, p.u_max, mu))(U).sum())
    c = prob.defects(X, U, p)
    return J + bar + nu_pen * jnp.sum(jnp.abs(c))


def fraction_to_boundary(v: Array, dv: Array, lo: Array, hi: Array,
                         tau: float = 0.995) -> Array:
    """Largest step alpha <= 1 keeping v + alpha*dv a fraction tau inside the
    (possibly infinite) box."""
    lo_fin = jnp.isfinite(lo) & (dv < 0)
    hi_fin = jnp.isfinite(hi) & (dv > 0)
    a_lo = jnp.where(lo_fin, -tau * (v - lo) / jnp.where(dv < 0, dv, -1.0), 1.0)
    a_hi = jnp.where(hi_fin, tau * (hi - v) / jnp.where(dv > 0, dv, 1.0), 1.0)
    return jnp.minimum(jnp.min(a_lo), jnp.min(a_hi))
