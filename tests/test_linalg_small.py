"""Unit tests for the unrolled small-matrix linear algebra (ops/linalg.py),
pinned against numpy/LAPACK."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mahi_mpc.ops import (chol_small, cho_solve_small, solve_small,
                              spd_solve_small)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 12])
def test_chol_small_matches_numpy(n):
    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    L = np.asarray(chol_small(jnp.asarray(A, jnp.float64)))
    np.testing.assert_allclose(L, np.linalg.cholesky(A), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("n", [1, 3, 6])
def test_spd_solve_vec_and_mat(n):
    rng = np.random.default_rng(n + 10)
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    b = rng.standard_normal(n)
    B = rng.standard_normal((n, 2))
    x = np.asarray(spd_solve_small(jnp.asarray(A, jnp.float64), jnp.asarray(b)))
    X = np.asarray(spd_solve_small(jnp.asarray(A, jnp.float64), jnp.asarray(B)))
    np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(X, np.linalg.solve(A, B), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("n", [2, 4, 7])
def test_solve_small_general_with_pivoting(n):
    rng = np.random.default_rng(n + 20)
    # needs pivoting: zero on the leading diagonal entry
    A = rng.standard_normal((n, n))
    A[0, 0] = 0.0
    b = rng.standard_normal(n)
    x = np.asarray(solve_small(jnp.asarray(A, jnp.float64), jnp.asarray(b)))
    np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=1e-8, atol=1e-8)


def test_batched_via_vmap():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((32, 4, 4))
    A = A @ np.transpose(A, (0, 2, 1)) + 4 * np.eye(4)
    b = rng.standard_normal((32, 4))
    X = np.asarray(jax.vmap(spd_solve_small)(
        jnp.asarray(A, jnp.float64), jnp.asarray(b)))
    expected = np.linalg.solve(A, b[..., None])[..., 0]
    np.testing.assert_allclose(X, expected, rtol=1e-8, atol=1e-8)


def test_jit_and_grad_flow_through():
    A = jnp.eye(3, dtype=jnp.float64) * 2.0
    b = jnp.ones(3, jnp.float64)
    f = jax.jit(lambda A, b: jnp.sum(spd_solve_small(A, b)))
    g = jax.grad(f)(A, b)
    assert np.all(np.isfinite(np.asarray(g)))
