"""Riccati (block-tridiagonal KKT) solve of one LQR subproblem.

This is the structured replacement for IPOPT's sparse MUMPS/MA27
factorization (``ModelControl.cpp:56``): the multiple-shooting KKT matrix is
stage-banded, and a backward Riccati sweep + forward rollout solves it exactly
in O(N (nz+nu)^3), expressed as `jax.lax.scan` so XLA compiles one fused
sequential kernel.  Batched over instances with `jax.vmap` (scenario batch,
SURVEY.md §2.b).

The dense backend (`solve_lqr_dense`) forms the full KKT system and solves it
with a direct dense factorization — the oracle used by tests to pin the scan
down to roundoff.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..ops.linalg import chol_small, cho_solve_small
from ..ops.precision import highest_precision
from .stage_qp import StageQP

Array = jnp.ndarray


class LQRSolution(NamedTuple):
    dz: Array      # (N+1, nz) state deltas (dz_0 = 0: node 0 is pinned)
    du: Array      # (N, nu) control deltas
    lam: Array     # (N+1, nz) multiplier estimates (value-function gradients)


@highest_precision
def solve_lqr_scan(qp: StageQP, unroll: bool = False) -> LQRSolution:
    """Backward Riccati recursion + forward substitution as lax.scan.

    ``unroll=True`` fully unrolls the scans at trace time (no While ops in
    the lowered program) — the latency shape used by ``solve_fixed`` for the
    single-instance 1 kHz hot path; the default keeps the program compact
    for batched throughput."""
    un = qp.Az.shape[0] if unroll else 1

    def backward(carry, stage):
        P, pvec = carry
        Az, Bz, r, Hzz, Hzu, Huu, gz, gu = stage
        Pr_p = pvec + P @ r
        AtP = Az.T @ P
        Qzz = Hzz + AtP @ Az
        Qzu = Hzu + AtP @ Bz
        Quu = Huu + Bz.T @ P @ Bz
        qz = gz + Az.T @ Pr_p
        qu = gu + Bz.T @ Pr_p
        # Solve the (nu x nu) SPD system via unrolled Cholesky (pure
        # elementwise graph — fuses into the scan body, no LAPACK custom
        # call; see ops/linalg.py).
        L = chol_small(Quu)
        K = -cho_solve_small(L, Qzu.T)   # (nu, nz)
        kff = -cho_solve_small(L, qu)    # (nu,)
        P_new = Qzz + Qzu @ K
        P_new = 0.5 * (P_new + P_new.T)
        p_new = qz + Qzu @ kff
        return (P_new, p_new), (K, kff)

    stages = (qp.Az, qp.Bz, qp.r, qp.Hzz, qp.Hzu, qp.Huu, qp.gz, qp.gu)
    (P0, p0), (Ks, kffs) = jax.lax.scan(
        backward, (qp.Hf, qp.gf), stages, reverse=True, unroll=un)

    nz = qp.Hf.shape[0]
    dz0 = jnp.zeros(nz, qp.gf.dtype)

    def forward(dz, stage):
        K, kff, Az, Bz, r = stage
        du = K @ dz + kff
        dz_next = Az @ dz + Bz @ du + r
        return dz_next, (dz, du)

    _, (dzs, dus) = jax.lax.scan(
        forward, dz0, (Ks, kffs, qp.Az, qp.Bz, qp.r), unroll=un)
    dz_last = qp.Az[-1] @ dzs[-1] + qp.Bz[-1] @ dus[-1] + qp.r[-1]
    dz_all = jnp.concatenate([dzs, dz_last[None]], axis=0)

    lam = _multipliers(qp, dz_all, dus, unroll=unroll)
    return LQRSolution(dz=dz_all, du=dus, lam=lam)


def _multipliers(qp: StageQP, dz: Array, du: Array,
                 unroll: bool = False) -> Array:
    """Adjoint recursion for the continuity duals (used for KKT-residual
    reporting and the l1 merit penalty): lam_N = Hf dz_N + gf and, for
    1 <= k < N, lam_k = Hzz_k dz_k + Hzu_k du_k + gz_k + Az_k' lam_{k+1}.
    lam_0 is set to 0 (node 0 is pinned, no incoming continuity edge)."""
    lamN = qp.Hf @ dz[-1] + qp.gf

    def body(lam_next, stage):
        Az, Hzz, Hzu, gz, dzk, duk = stage
        lam_k = Hzz @ dzk + Hzu @ duk + gz + Az.T @ lam_next
        return lam_k, lam_k

    stages = (qp.Az[1:], qp.Hzz[1:], qp.Hzu[1:], qp.gz[1:], dz[1:-1], du[1:])
    _, lams = jax.lax.scan(body, lamN, stages, reverse=True,
                           unroll=(dz.shape[0] - 1 if unroll else 1))
    return jnp.concatenate(
        [jnp.zeros_like(dz[:1]), lams, lamN[None]], axis=0)


@highest_precision
def solve_lqr_dense(qp: StageQP) -> LQRSolution:
    """Oracle: assemble the full KKT system over w = [du_0..du_{N-1},
    dz_1..dz_N] with equality constraints dz_{k+1} = Az dz_k + Bz du_k + r and
    solve it densely."""
    N, nz, nu = qp.Az.shape[0], qp.Az.shape[1], qp.Bz.shape[2]
    nw = N * nu + N * nz     # unknowns (dz_0 = 0 eliminated)
    nc = N * nz              # constraints
    dtype = qp.gf.dtype

    def uix(k):
        return k * nu

    def zix(k):  # dz_k for k>=1
        return N * nu + (k - 1) * nz

    H = jnp.zeros((nw, nw), dtype)
    g = jnp.zeros(nw, dtype)
    # Stage costs: k=0 has dz_0 = 0 -> only Huu/gu.
    H = H.at[uix(0):uix(0) + nu, uix(0):uix(0) + nu].add(qp.Huu[0])
    g = g.at[uix(0):uix(0) + nu].add(qp.gu[0])
    for k in range(1, N):
        zi, ui = zix(k), uix(k)
        H = H.at[zi:zi + nz, zi:zi + nz].add(qp.Hzz[k])
        H = H.at[zi:zi + nz, ui:ui + nu].add(qp.Hzu[k])
        H = H.at[ui:ui + nu, zi:zi + nz].add(qp.Hzu[k].T)
        H = H.at[ui:ui + nu, ui:ui + nu].add(qp.Huu[k])
        g = g.at[zi:zi + nz].add(qp.gz[k])
        g = g.at[ui:ui + nu].add(qp.gu[k])
    zi = zix(N)
    H = H.at[zi:zi + nz, zi:zi + nz].add(qp.Hf)
    g = g.at[zi:zi + nz].add(qp.gf)

    C = jnp.zeros((nc, nw), dtype)
    d = jnp.zeros(nc, dtype)
    for k in range(N):
        row = k * nz
        C = C.at[row:row + nz, uix(k):uix(k) + nu].set(qp.Bz[k])
        if k >= 1:
            C = C.at[row:row + nz, zix(k):zix(k) + nz].set(qp.Az[k])
        C = C.at[row:row + nz, zix(k + 1):zix(k + 1) + nz].set(-jnp.eye(nz, dtype=dtype))
        d = d.at[row:row + nz].set(-qp.r[k])

    KKT = jnp.block([[H, C.T], [C, jnp.zeros((nc, nc), dtype)]])
    rhs = jnp.concatenate([-g, d])
    sol = jnp.linalg.solve(KKT, rhs)

    du = sol[: N * nu].reshape(N, nu)
    dz = jnp.concatenate(
        [jnp.zeros((1, nz), dtype), sol[N * nu:nw].reshape(N, nz)], axis=0)
    lam = jnp.concatenate(
        [jnp.zeros((1, nz), dtype), sol[nw:].reshape(N, nz)], axis=0)
    return LQRSolution(dz=dz, du=du, lam=lam)


_BACKENDS = {}


KKT_BACKENDS = ("riccati", "dense", "pariccati", "time_shard")


def resolve_kkt_backend(backend: str) -> str:
    """Resolve ``SolverOptions.kkt_backend``: ``'auto'`` is the sequential
    scan on every device; explicit values are ``KKT_BACKENDS``."""
    if backend == "auto":
        return "riccati"
    if backend not in KKT_BACKENDS and backend not in _BACKENDS:
        raise ValueError(
            f"unknown KKT backend {backend!r}; choose 'auto' or one of "
            f"{KKT_BACKENDS}")
    return backend


def solve_lqr(qp: StageQP, backend: str = "riccati") -> LQRSolution:
    backend = resolve_kkt_backend(backend)
    if backend == "riccati":
        return solve_lqr_scan(qp)
    if backend == "dense":
        return solve_lqr_dense(qp)
    if backend in _BACKENDS:
        return _BACKENDS[backend](qp)
    raise ValueError(f"KKT backend {backend!r} is not registered")


def register_backend(name: str, fn) -> None:
    """Register an additional LQR backend (parallel scan, time sharding)."""
    _BACKENDS[name] = fn
