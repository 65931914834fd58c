"""Small-matrix linear algebra as pure JAX elementwise graphs.

The MPC hot path factorizes tiny SPD blocks (``Quu``: nu×nu ≤ ~8; mass
matrices: n ≤ ~4; Riccati value Hessians: nz ≤ ~12).  LAPACK custom calls
(``jnp.linalg.cholesky`` / ``solve``) are the wrong tool here three times
over: a library call cannot fuse into the surrounding scan body; for AOT
export the CPU LAPACK FFI targets are only registered in the *exporting*
process, so a deserialized artifact segfaults in a fresh process; and for
matrices this small an unrolled Cholesky-Crout is cheaper than the call
overhead.  These routines unroll at trace time (n is static) into plain
mul/add/rsqrt ops the compiler can fuse and batch freely — the pattern the
reference delegates to MUMPS/MA27 pivoting (``ModelControl.cpp:56``), which
block-Riccati structure makes unnecessary.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jnp.ndarray


def chol_small(A: Array, jitter: float = 0.0) -> Array:
    """Cholesky factor L (lower) of a small SPD matrix, unrolled Crout.

    A: (n, n) with n static and modest (≤ ~16).  Batched via vmap.
    """
    n = A.shape[-1]
    rows = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[..., j, j] + jitter
        for k in range(j):
            s = s - rows[j][k] * rows[j][k]
        d = jnp.sqrt(s)
        rows[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - rows[i][k] * rows[j][k]
            rows[i][j] = s * inv_d
    cols = []
    zero = jnp.zeros_like(A[..., 0, 0])
    for i in range(n):
        cols.append(jnp.stack(
            [rows[i][j] if j <= i else zero for j in range(n)], axis=-1))
    return jnp.stack(cols, axis=-2)


def tri_solve_lower(L: Array, b: Array) -> Array:
    """Solve L y = b with L lower-triangular, unrolled forward substitution.
    b: (..., n) or (..., n, k)."""
    n = L.shape[-1]
    vec = b.ndim == L.ndim - 1
    if vec:
        b = b[..., None]
    ys = []
    for i in range(n):
        s = b[..., i, :]
        for j in range(i):
            s = s - L[..., i, j][..., None] * ys[j]
        ys.append(s / L[..., i, i][..., None])
    y = jnp.stack(ys, axis=-2)
    return y[..., 0] if vec else y


def tri_solve_upper_t(L: Array, y: Array) -> Array:
    """Solve L^T x = y (back substitution on the transpose of lower L)."""
    n = L.shape[-1]
    vec = y.ndim == L.ndim - 1
    if vec:
        y = y[..., None]
    xs: list = [None] * n
    for i in reversed(range(n)):
        s = y[..., i, :]
        for j in range(i + 1, n):
            s = s - L[..., j, i][..., None] * xs[j]
        xs[i] = s / L[..., i, i][..., None]
    x = jnp.stack(xs, axis=-2)
    return x[..., 0] if vec else x


def cho_solve_small(L: Array, b: Array) -> Array:
    """Solve (L L^T) x = b given the factor from `chol_small`."""
    return tri_solve_upper_t(L, tri_solve_lower(L, b))


def spd_solve_small(A: Array, b: Array, jitter: float = 0.0) -> Array:
    """Solve A x = b for small SPD A without LAPACK."""
    return cho_solve_small(chol_small(A, jitter), b)


def solve_small(A: Array, b: Array) -> Array:
    """General small square solve via unrolled LU with partial pivoting.

    For matrices that are not SPD.  n static ≤ ~16; batched via vmap.
    Pivoting uses `jnp.where` selects (no data-dependent control flow).
    """
    n = A.shape[-1]
    vec = b.ndim == A.ndim - 1
    if vec:
        b = b[..., None]
    # Augment and eliminate.
    M = jnp.concatenate([A, b], axis=-1)
    for k in range(n):
        col = jnp.abs(M[..., k:, k])  # candidate pivots (n-k,)
        pidx = jnp.argmax(col, axis=-1)
        # swap row k with row k+pidx via one-hot select
        rows = M[..., k:, :]
        onehot = jax.nn.one_hot(pidx, n - k, dtype=M.dtype)
        pivot_row = jnp.einsum("...i,...ij->...j", onehot, rows)
        # replace the pivot row's old position with row k
        row_k = M[..., k, :]
        repl = rows + onehot[..., None] * (row_k[..., None, :] - rows)
        M = M.at[..., k:, :].set(repl)
        M = M.at[..., k, :].set(pivot_row)
        # eliminate below
        piv = M[..., k, k]
        factors = M[..., k + 1:, k] / piv[..., None]
        M = M.at[..., k + 1:, :].add(
            -factors[..., None] * M[..., k, :][..., None, :])
    # back substitution
    xs: list = [None] * n
    for i in reversed(range(n)):
        s = M[..., i, n:]
        for j in range(i + 1, n):
            s = s - M[..., i, j][..., None] * xs[j]
        xs[i] = s / M[..., i, i][..., None]
    x = jnp.stack(xs, axis=-2)
    return x[..., 0] if vec else x


def chol_lanes(A: Array, jitter: float = 0.0) -> Array:
    """Cholesky of a small SPD matrix in *lanes* layout: A has shape
    (n, n, ...lanes) — component indices lead, batch trails.  Every
    intermediate is a (...lanes,) array with the batch contiguous,
    regardless of n.  Mirrors `chol_small`."""
    n = A.shape[0]
    rows = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[j, j] + jitter
        for k in range(j):
            s = s - rows[j][k] * rows[j][k]
        d = jnp.sqrt(s)
        rows[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = A[i, j]
            for k in range(j):
                s = s - rows[i][k] * rows[j][k]
            rows[i][j] = s * inv_d
    zero = jnp.zeros_like(A[0, 0])
    return jnp.stack([jnp.stack(
        [rows[i][j] if j <= i else zero for j in range(n)], axis=0)
        for i in range(n)], axis=0)


def cho_solve_lanes(L: Array, b: Array) -> Array:
    """Solve (L L') x = b in lanes layout: L (n, n, ...), b (n, ...)."""
    n = L.shape[0]
    ys = []
    for i in range(n):
        s = b[i]
        for j in range(i):
            s = s - L[i, j] * ys[j]
        ys.append(s / L[i, i])
    xs: list = [None] * n
    for i in reversed(range(n)):
        s = ys[i]
        for j in range(i + 1, n):
            s = s - L[j, i] * xs[j]
        xs[i] = s / L[i, i]
    return jnp.stack(xs, axis=0)


def spd_solve_lanes(A: Array, b: Array, jitter: float = 0.0) -> Array:
    """Solve A x = b, SPD A in lanes layout (n, n, ...), b (n, ...)."""
    return cho_solve_lanes(chol_lanes(A, jitter), b)


def register_lapack_ffi_targets() -> None:
    """Safety net for artifacts that *do* contain LAPACK custom calls
    (user-supplied dynamics using jnp.linalg): on the CPU backend the FFI
    targets are registered lazily at lowering time, so a fresh process
    executing a deserialized artifact would segfault.  Lowering one tiny
    factorization of each family for the CPU registers them all; it only
    lowers, so it is harmless whatever the default backend is."""
    import jax.numpy as _jnp
    spec = jax.ShapeDtypeStruct((2, 2), _jnp.float32)
    vspec = jax.ShapeDtypeStruct((2,), _jnp.float32)
    for fn, args in ((_jnp.linalg.cholesky, (spec,)),
                     (_jnp.linalg.solve, (spec, vspec)),
                     (_jnp.linalg.eigh, (spec,)),
                     (_jnp.linalg.qr, (spec,)),
                     (_jnp.linalg.svd, (spec,))):
        jax.jit(fn).trace(*args).lower(lowering_platforms=("cpu",))
