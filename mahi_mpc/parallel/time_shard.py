"""Horizon (sequence-parallel) sharding of the Riccati KKT solve.

The reference's "sequence" is the shooting horizon, built as a sequential
symbolic loop and solved as one sparse NLP (``ModelGenerator.cpp:191-222``);
SURVEY.md §5 maps it to context parallelism: the block-tridiagonal KKT solve
is an associative scan over stages (solver/pariccati.py), so it shards over a
``time`` mesh axis the way ring/blockwise attention shards sequence.

This module wires that through ``shard_map``: each time-shard runs a *local*
associative scan over its slice of the horizon, shards exchange one
boundary element each via ``all_gather`` over the ``time`` axis (T elements,
T = #shards — the ICI neighbor exchange of SURVEY §5), a static O(T) fold
composes the cross-shard Redheffer/affine products, and the local results are
corrected in place.  Depth: O(log(N/T)) local + O(T) boundary, bytes over
ICI: one (nz, nz) element per shard per direction.

For the N≤64 horizons of the benchmark configs a single chip wants the plain
scan (measurements in docs/PARALLELISM.md); this path exists for very long
horizons (N in the thousands) and as the SP/CP parity component.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops.linalg import chol_small, cho_solve_small, solve_small
from ..ops.precision import highest_precision
from ..solver.pariccati import _Element, _combine
from ..solver.riccati import LQRSolution, register_backend
from ..solver.stage_qp import StageQP

Array = jnp.ndarray


def _star_identity(nz: int, dtype) -> _Element:
    I = jnp.eye(nz, dtype=dtype)
    z = jnp.zeros((nz, nz), dtype)
    v = jnp.zeros((nz,), dtype)
    return _Element(A=I, B=z, C=z, D=I, e=v, f=v)


def _fwd_combine(m1, m2):
    """Compose affine maps, m1 earlier: x -> F2 (F1 x + g1) + g2."""
    F1, g1 = m1
    F2, g2 = m2
    return (jnp.einsum("...ij,...jl->...il", F2, F1),
            jnp.einsum("...ij,...j->...i", F2, g1) + g2)


@highest_precision
def solve_lqr_time_sharded(qp: StageQP, mesh: Mesh,
                           axis_name: str = "time") -> LQRSolution:
    """LQR solve with the horizon sharded over ``mesh``'s ``axis_name`` axis.

    Same results as ``solve_lqr_scan`` (tests pin equality at T=2,4 on the
    CPU mesh).  Requires N divisible by the axis size.
    """
    N, nz, nu = qp.Az.shape[0], qp.Az.shape[1], qp.Bz.shape[2]
    T = mesh.shape[axis_name]
    assert N % T == 0, f"horizon N={N} not divisible by time shards T={T}"
    dtype = qp.gf.dtype

    stage_spec = P(axis_name)          # leading stage axis sharded
    rep_spec = P()                     # Hf, gf replicated
    in_specs = StageQP(Az=stage_spec, Bz=stage_spec, r=stage_spec,
                       Hzz=stage_spec, Hzu=stage_spec, Huu=stage_spec,
                       gz=stage_spec, gu=stage_spec,
                       Hf=rep_spec, gf=rep_spec)
    out_specs = (stage_spec, stage_spec, stage_spec)

    def local(qp_l: StageQP):
        n = qp_l.Az.shape[0]                            # local stages N/T
        i = jax.lax.axis_index(axis_name)
        I = jnp.eye(nz, dtype=dtype)

        # --- per-stage elimination of du (identical to pariccati.py) ---
        L = jax.vmap(chol_small)(qp_l.Huu)
        Rinv_Mt = jax.vmap(cho_solve_small)(L, jnp.swapaxes(qp_l.Hzu, 1, 2))
        Rinv_Bt = jax.vmap(cho_solve_small)(L, jnp.swapaxes(qp_l.Bz, 1, 2))
        Rinv_ru = jax.vmap(cho_solve_small)(L, qp_l.gu)
        At = qp_l.Az - jnp.einsum("kij,kjl->kil", qp_l.Bz, Rinv_Mt)
        Ct = jnp.einsum("kij,kjl->kil", qp_l.Bz, Rinv_Bt)
        Qt = qp_l.Hzz - jnp.einsum("kij,kjl->kil", qp_l.Hzu, Rinv_Mt)
        ct = qp_l.r - jnp.einsum("kij,kj->ki", qp_l.Bz, Rinv_ru)
        qt = qp_l.gz - jnp.einsum("kij,kj->ki", qp_l.Hzu, Rinv_ru)
        elems = _Element(A=At, B=-Ct, C=Qt, D=jnp.swapaxes(At, 1, 2),
                         e=ct, f=qt)

        # --- local suffix scan: suffix[k] = e_k * ... * e_{n-1} (local) ---
        suffix = jax.lax.associative_scan(
            lambda a, b: _combine(b, a), elems, reverse=True)
        agg = jax.tree.map(lambda a: a[0], suffix)      # whole-shard product

        # --- boundary exchange: every shard sees every shard's aggregate ---
        aggs = jax.lax.all_gather(agg, axis_name)       # (T, ...)

        # R_j = agg_{j+1} * ... * agg_{T-1} * term  (static O(T) fold).
        term = _Element(A=jnp.zeros((nz, nz), dtype),
                        B=jnp.zeros((nz, nz), dtype), C=qp_l.Hf,
                        D=jnp.zeros((nz, nz), dtype),
                        e=jnp.zeros((nz,), dtype), f=qp_l.gf)
        Rs = [None] * T
        Rs[T - 1] = term
        for j in range(T - 2, -1, -1):
            Rs[j] = _combine(jax.tree.map(lambda a: a[j + 1], aggs), Rs[j + 1])
        R_stack = jax.tree.map(lambda *xs: jnp.stack(xs, 0), *Rs)
        R_i = jax.tree.map(lambda a: a[i], R_stack)

        # --- full suffix for local stages: S_k z + s_k = lam_k ---
        full = jax.vmap(_combine, in_axes=(0, None))(suffix, R_i)
        # S_{k+1}/s_{k+1} per local stage (last one comes from R_i itself).
        S_next = jnp.concatenate([full.C[1:], R_i.C[None]], axis=0)
        s_next = jnp.concatenate([full.f[1:], R_i.f[None]], axis=0)

        # --- forward affine maps dz_{k+1} = F_k dz_k + g_k ---
        M_fwd = I[None] + jnp.einsum("kij,kjl->kil", Ct, S_next)
        F = jax.vmap(solve_small)(M_fwd, At)
        g = jax.vmap(solve_small)(
            M_fwd, ct - jnp.einsum("kij,kj->ki", Ct, s_next))

        Fc, gc = jax.lax.associative_scan(_fwd_combine, (F, g))
        agg_f = (Fc[-1], gc[-1])
        aggs_f = jax.lax.all_gather(agg_f, axis_name)   # (T, ...)

        # P_j = composition of shards 0..j-1 applied to dz_0 = 0.
        Ps = [None] * T
        Ps[0] = (I, jnp.zeros((nz,), dtype))
        for j in range(1, T):
            Ps[j] = _fwd_combine(Ps[j - 1],
                                 jax.tree.map(lambda a: a[j - 1], aggs_f))
        P_stack = jax.tree.map(lambda *xs: jnp.stack(xs, 0), *Ps)
        dz_start = jax.tree.map(lambda a: a[i], P_stack)[1]   # (nz,)

        dz_next = jnp.einsum("kij,j->ki", Fc, dz_start) + gc  # dz_{k+1}
        dz_here = jnp.concatenate(
            [dz_start[None],
             dz_next[:-1]], axis=0)                            # dz_k

        lam_next = jnp.einsum("kij,kj->ki", S_next, dz_next) + s_next
        du = -(jnp.einsum("kij,kj->ki", Rinv_Mt, dz_here)
               + jnp.einsum("kij,kj->ki", Rinv_Bt, lam_next)
               + Rinv_ru)
        return dz_next, du, lam_next

    fn = shard_map(local, mesh=mesh, in_specs=(in_specs,),
                   out_specs=out_specs)
    dz_next, du, lam_next = fn(qp)
    zero = jnp.zeros((1, nz), dtype)
    dz = jnp.concatenate([zero, dz_next], axis=0)
    lam = jnp.concatenate([zero, lam_next], axis=0)   # lam_0 = 0 (pinned node)
    return LQRSolution(dz=dz, du=du, lam=lam)


def enable_time_shard_backend(mesh: Mesh, axis_name: str = "time",
                              name: str = "time_shard") -> str:
    """Make horizon sharding reachable from the public solver options:
    registers a ``solve_lqr`` backend that closes
    over ``mesh``, so ``SolverOptions(kkt_backend='time_shard')`` routes
    every KKT solve of ``solve`` / ``solve_batch`` through
    ``solve_lqr_time_sharded``.  Returns the backend name to put in
    ``SolverOptions.kkt_backend``.

    Use when the horizon N is long enough that the O(log(N/T)) local scan +
    O(T) boundary fold beats the O(N) sequential scan per chip — see
    ``docs/PARALLELISM.md`` for measured win/loss.
    """
    register_backend(
        name, lambda qp: solve_lqr_time_sharded(qp, mesh, axis_name))
    return name
