"""Riccati-scan vs dense-KKT equivalence: the first link in the oracle chain
(SURVEY.md §7.3 — scan version checked against a trusted direct solve)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mahi_mpc.solver.riccati import solve_lqr_dense, solve_lqr_scan
from mahi_mpc.solver.stage_qp import StageQP

jax.config.update("jax_enable_x64", True)


def random_qp(N=12, nz=6, nu=2, seed=0, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    def pd(n, scale=1.0):
        M = rng.normal(size=(n, n)) * scale
        return M @ M.T + n * np.eye(n) * 0.5
    Az = jnp.array(rng.normal(size=(N, nz, nz)) * 0.4)
    Bz = jnp.array(rng.normal(size=(N, nz, nu)))
    r = jnp.array(rng.normal(size=(N, nz)))
    Hzz = jnp.array(np.stack([pd(nz) for _ in range(N)]))
    Huu = jnp.array(np.stack([pd(nu) for _ in range(N)]))
    Hzu = jnp.array(rng.normal(size=(N, nz, nu)) * 0.3)
    gz = jnp.array(rng.normal(size=(N, nz)))
    gu = jnp.array(rng.normal(size=(N, nu)))
    Hf = jnp.array(pd(nz))
    gf = jnp.array(rng.normal(size=nz))
    return StageQP(Az.astype(dtype), Bz.astype(dtype), r.astype(dtype),
                   Hzz.astype(dtype), Hzu.astype(dtype), Huu.astype(dtype),
                   gz.astype(dtype), gu.astype(dtype), Hf.astype(dtype),
                   gf.astype(dtype))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scan_matches_dense(seed):
    qp = random_qp(seed=seed)
    a = solve_lqr_scan(qp)
    b = solve_lqr_dense(qp)
    np.testing.assert_allclose(np.asarray(a.du), np.asarray(b.du),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(a.dz), np.asarray(b.dz),
                               rtol=1e-8, atol=1e-8)
    # duals agree at interior + terminal nodes
    np.testing.assert_allclose(np.asarray(a.lam[1:]), np.asarray(b.lam[1:]),
                               rtol=1e-7, atol=1e-7)


def test_solution_satisfies_kkt():
    qp = random_qp(seed=3)
    sol = solve_lqr_scan(qp)
    N, nz, nu = qp.Az.shape[0], qp.Az.shape[1], qp.Bz.shape[2]
    dz, du, lam = np.asarray(sol.dz), np.asarray(sol.du), np.asarray(sol.lam)
    Az, Bz = np.asarray(qp.Az), np.asarray(qp.Bz)
    # dynamics feasibility
    for k in range(N):
        lhs = Az[k] @ dz[k] + Bz[k] @ du[k] + np.asarray(qp.r[k])
        np.testing.assert_allclose(lhs, dz[k + 1], rtol=1e-8, atol=1e-8)
    # stationarity wrt du_k:  Hzu' dz + Huu du + gu + Bz' lam_{k+1} = 0
    for k in range(N):
        st = (np.asarray(qp.Hzu[k]).T @ dz[k] + np.asarray(qp.Huu[k]) @ du[k]
              + np.asarray(qp.gu[k]) + Bz[k].T @ lam[k + 1])
        np.testing.assert_allclose(st, 0, atol=1e-7)
    # stationarity wrt dz_k (interior):  Hzz dz + Hzu du + gz + Az' lam_{k+1} = lam_k
    for k in range(1, N):
        st = (np.asarray(qp.Hzz[k]) @ dz[k] + np.asarray(qp.Hzu[k]) @ du[k]
              + np.asarray(qp.gz[k]) + Az[k].T @ lam[k + 1])
        np.testing.assert_allclose(st, lam[k], rtol=1e-7, atol=1e-7)
    # terminal:  Hf dz_N + gf = lam_N
    np.testing.assert_allclose(np.asarray(qp.Hf) @ dz[N] + np.asarray(qp.gf),
                               lam[N], rtol=1e-8, atol=1e-8)


def test_vmapped_batch():
    qps = [random_qp(seed=s) for s in range(4)]
    batch = jax.tree.map(lambda *xs: jnp.stack(xs), *qps)
    sols = jax.vmap(solve_lqr_scan)(batch)
    for i, qp in enumerate(qps):
        ref = solve_lqr_scan(qp)
        np.testing.assert_allclose(np.asarray(sols.du[i]), np.asarray(ref.du),
                                   rtol=1e-9, atol=1e-9)


def test_parallel_scan_matches_dense():
    """O(log N) associative-scan backend vs the dense KKT oracle."""
    from mahi_mpc.solver.pariccati import solve_lqr_parallel
    par_jit = jax.jit(solve_lqr_parallel)  # eager op-by-op is ~80s on CPU
    for seed in [0, 1, 2]:
        qp = random_qp(N=16, seed=seed)
        a = par_jit(qp)
        b = solve_lqr_dense(qp)
        np.testing.assert_allclose(np.asarray(a.du), np.asarray(b.du),
                                   rtol=1e-7, atol=1e-7)
        np.testing.assert_allclose(np.asarray(a.dz), np.asarray(b.dz),
                                   rtol=1e-7, atol=1e-7)
        np.testing.assert_allclose(np.asarray(a.lam[1:]), np.asarray(b.lam[1:]),
                                   rtol=1e-6, atol=1e-6)


def test_parallel_scan_long_horizon():
    from mahi_mpc.solver.pariccati import solve_lqr_parallel
    qp = random_qp(N=128, seed=3)
    a = jax.jit(solve_lqr_parallel)(qp)
    b = solve_lqr_scan(qp)
    np.testing.assert_allclose(np.asarray(a.du), np.asarray(b.du),
                               rtol=1e-6, atol=1e-6)
