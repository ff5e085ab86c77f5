"""Small-matrix linear algebra without LAPACK custom calls.

The LU-family primitives (jnp.linalg.inv/solve, lu_factor) are unavailable
on some JAX CPU builds (missing custom-call targets) and are overkill
anyway.  FEM geometry only ever needs 2x2/3x3 inverses (element Jacobians)
and (dim+1)-sized node blocks (block-Jacobi), so closed-form cofactor
formulas win on both portability and speed: pure VPU arithmetic, no
batching limits, trivially differentiable.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def det_small(A: jnp.ndarray) -> jnp.ndarray:
    """Determinant for (..., n, n), n in {1, 2, 3} — closed form."""
    n = A.shape[-1]
    if n == 1:
        return A[..., 0, 0]
    if n == 2:
        return A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    if n == 3:
        return (
            A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0])
        )
    raise ValueError(f"det_small supports n<=3, got {n}")


def _inv2(A):
    d = det_small(A)
    inv = jnp.stack(
        [
            jnp.stack([A[..., 1, 1], -A[..., 0, 1]], axis=-1),
            jnp.stack([-A[..., 1, 0], A[..., 0, 0]], axis=-1),
        ],
        axis=-2,
    )
    return inv / d[..., None, None]


def _inv3(A):
    d = det_small(A)

    def cof(i0, i1, j0, j1):
        return A[..., i0, j0] * A[..., i1, j1] - A[..., i0, j1] * A[..., i1, j0]

    # adjugate (transpose of cofactor matrix)
    adj = jnp.stack(
        [
            jnp.stack([cof(1, 2, 1, 2), -cof(0, 2, 1, 2), cof(0, 1, 1, 2)], axis=-1),
            jnp.stack([-cof(1, 2, 0, 2), cof(0, 2, 0, 2), -cof(0, 1, 0, 2)], axis=-1),
            jnp.stack([cof(1, 2, 0, 1), -cof(0, 2, 0, 1), cof(0, 1, 0, 1)], axis=-1),
        ],
        axis=-2,
    )
    return adj / d[..., None, None]


def _inv_gauss_jordan(A):
    """Batched Gauss-Jordan with partial pivoting for small n (static loop)."""
    n = A.shape[-1]
    dtype = A.dtype
    eye = jnp.broadcast_to(jnp.eye(n, dtype=dtype), A.shape)
    M = jnp.concatenate([A, eye], axis=-1)  # (..., n, 2n)

    def step(k, M):
        # pivot: largest |M[.., i, k]| for i >= k
        col = jnp.abs(M[..., :, k])
        ii = jnp.arange(n)
        col = jnp.where(ii >= k, col, -jnp.inf)
        piv = jnp.argmax(col, axis=-1)  # (...,)
        # swap rows k and piv
        rows = jnp.arange(n)
        perm = jnp.where(rows[None] == k, piv[..., None],
                         jnp.where(rows[None] == piv[..., None], k, rows[None]))
        M = jnp.take_along_axis(M, perm[..., None].astype(jnp.int32)
                                .repeat(2 * n, axis=-1), axis=-2)
        pivot_row = M[..., k, :] / M[..., k, k][..., None]
        M = M - M[..., :, k][..., None] * pivot_row[..., None, :]
        M = M.at[..., k, :].set(pivot_row)
        return M

    M = jax.lax.fori_loop(0, n, step, M)
    return M[..., :, n:]


def inv_small(A: jnp.ndarray) -> jnp.ndarray:
    """Inverse for (..., n, n); closed form for n<=3, Gauss-Jordan beyond."""
    n = A.shape[-1]
    if n == 1:
        return 1.0 / A
    if n == 2:
        return _inv2(A)
    if n == 3:
        return _inv3(A)
    return _inv_gauss_jordan(A)


def solve_dense_qr(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Dense solve via QR (portable: no LU custom call)."""
    Q, R = jnp.linalg.qr(A)
    return jax.scipy.linalg.solve_triangular(R, Q.T @ b, lower=False)
