"""Parallel-in-time Riccati: the LQR solve as associative scans.

The sequential backward Riccati recursion (riccati.py) has O(N) depth — fine
for N=25, but the answer to long horizons (SURVEY.md §5: "the
horizon axis is the sequence"; the context-parallelism analog) is to express
the KKT solve as two `jax.lax.associative_scan`s with O(log N) depth,
shardable over a `time` mesh axis.

Derivation: eliminating du_k from the stage KKT conditions leaves the
two-point ("scattering") relation per stage

    dz_{k+1} = Ã dz_k - C̃ λ_{k+1} + ĉ
    λ_k      = Q̃ dz_k + Ã' λ_{k+1} + q̃

with Ã = A - B R⁻¹ M', C̃ = B R⁻¹ B', Q̃ = Q - M R⁻¹ M',
ĉ = c - B R⁻¹ r_u, q̃ = q - M R⁻¹ r_u  (R = Huu, M = Hzu, Q = Hzz,
q = gz, r_u = gu, c = defect).  Such relations compose by the Redheffer
star product, which is associative, so suffix products against the terminal
element (λ_N = Hf dz_N + gf) yield every cost-to-go gradient
λ_k = S_k dz_k + s_k in one reverse associative scan; the forward rollout
dz_{k+1} = F_k dz_k + g_k is a second (affine-map) associative scan.

This is the same family as the parallel LQT of Särkkä & García-Fernández
(temporal parallelization of Riccati recursions), chosen here in scattering
form because it reuses the stage quantities the SQP already builds.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.linalg import chol_small, cho_solve_small, solve_small
from ..ops.precision import highest_precision
from .riccati import LQRSolution, register_backend
from .stage_qp import StageQP

Array = jnp.ndarray


class _Element(NamedTuple):
    """One scattering element: z_out = A z + B lam' + e; lam = C z + D lam' + f."""
    A: Array
    B: Array
    C: Array
    D: Array
    e: Array
    f: Array


def _mm(a, b):
    return jnp.einsum("...ij,...jk->...ik", a, b)


def _mv(a, b):
    return jnp.einsum("...ij,...j->...i", a, b)


def _combine(e1: _Element, e2: _Element) -> _Element:
    """Redheffer star product e1 ⋆ e2 (e1 is the earlier stage).  Associative."""
    n = e1.A.shape[-1]
    I = jnp.eye(n, dtype=e1.A.dtype)
    # G = (I - C2 B1)^{-1}; in the LQR instance C2 is PSD and B1 = -C̃ is
    # NSD, so I - C2 B1 = I + C2 C̃ is nonsingular.
    M = I - _mm(e2.C, e1.B)
    G_C2A1 = solve_small(M, _mm(e2.C, e1.A))
    G_D2 = solve_small(M, e2.D)
    G_mix = solve_small(M, _mv(e2.C, e1.e) + e2.f)
    A12 = _mm(e2.A, e1.A + _mm(e1.B, G_C2A1))
    B12 = _mm(e2.A, _mm(e1.B, G_D2)) + e2.B
    C12 = e1.C + _mm(e1.D, G_C2A1)
    D12 = _mm(e1.D, G_D2)
    e12 = _mv(e2.A, e1.e + _mv(e1.B, G_mix)) + e2.e
    f12 = e1.f + _mv(e1.D, G_mix)
    return _Element(A12, B12, C12, D12, e12, f12)


@highest_precision
def solve_lqr_parallel(qp: StageQP) -> LQRSolution:
    """O(log N)-depth LQR solve; same interface/results as solve_lqr_scan."""
    N, nz, nu = qp.Az.shape[0], qp.Az.shape[1], qp.Bz.shape[2]
    dtype = qp.gf.dtype
    I = jnp.eye(nz, dtype=dtype)

    # Per-stage elimination of du (vectorized over stages).
    L = jax.vmap(chol_small)(qp.Huu)                       # (N, nu, nu)
    Rinv_Mt = jax.vmap(cho_solve_small)(L, jnp.swapaxes(qp.Hzu, 1, 2))
    Rinv_Bt = jax.vmap(cho_solve_small)(L, jnp.swapaxes(qp.Bz, 1, 2))
    Rinv_ru = jax.vmap(cho_solve_small)(L, qp.gu)          # (N, nu)

    At = qp.Az - jnp.einsum("kij,kjl->kil", qp.Bz, Rinv_Mt)   # Ã
    Ct = jnp.einsum("kij,kjl->kil", qp.Bz, Rinv_Bt)           # C̃ (PSD)
    Qt = qp.Hzz - jnp.einsum("kij,kjl->kil", qp.Hzu, Rinv_Mt)  # Q̃
    ct = qp.r - jnp.einsum("kij,kj->ki", qp.Bz, Rinv_ru)       # ĉ
    qt = qp.gz - jnp.einsum("kij,kj->ki", qp.Hzu, Rinv_ru)     # q̃

    elems = _Element(A=At, B=-Ct, C=Qt, D=jnp.swapaxes(At, 1, 2),
                     e=ct, f=qt)
    # Terminal element: lam_N = Hf z_N + gf.
    zero = jnp.zeros((1, nz, nz), dtype)
    term = _Element(A=zero, B=zero, C=qp.Hf[None], D=zero,
                    e=jnp.zeros((1, nz), dtype), f=qp.gf[None])
    elems = jax.tree.map(lambda a, b: jnp.concatenate([a, b], axis=0),
                         elems, term)

    # Suffix products: suffix[k] = e_k ⋆ e_{k+1} ⋆ ... ⋆ e_N ⇒
    # lam_k = S_k z_k + s_k with S = C_suffix, s = f_suffix.
    # (reverse=True hands the combine its operands as (later, earlier) —
    # flip them so ⋆ composes in stage order.)
    suffix = jax.lax.associative_scan(
        lambda a, b: _combine(b, a), elems, reverse=True)
    S = suffix.C          # (N+1, nz, nz)
    s = suffix.f          # (N+1, nz)

    # Forward affine rollout dz_{k+1} = F_k dz_k + g_k, dz_0 = 0.
    M_fwd = I[None] + jnp.einsum("kij,kjl->kil", Ct, S[1:])
    F = jax.vmap(solve_small)(M_fwd, At)
    g = jax.vmap(solve_small)(
        M_fwd, ct - jnp.einsum("kij,kj->ki", Ct, s[1:]))

    def fwd_combine(m1, m2):  # m1 earlier
        F1, g1 = m1
        F2, g2 = m2
        return (jnp.einsum("...ij,...jl->...il", F2, F1),
                jnp.einsum("...ij,...j->...i", F2, g1) + g2)

    Fc, gc = jax.lax.associative_scan(fwd_combine, (F, g))
    dz = jnp.concatenate([jnp.zeros((1, nz), dtype), gc], axis=0)  # dz_0 = 0

    lam = jnp.einsum("kij,kj->ki", S, dz) + s
    du = -(jnp.einsum("kij,kj->ki", Rinv_Mt, dz[:-1])
           + jnp.einsum("kij,kj->ki", Rinv_Bt, lam[1:])
           + Rinv_ru)
    lam = lam.at[0].set(0.0)  # node 0 pinned: no incoming continuity dual
    return LQRSolution(dz=dz, du=du, lam=lam)


register_backend("pariccati", solve_lqr_parallel)
