"""Krylov solver unit tests (TFQMR vs direct/FGMRES).

TFQMR is the reference's actual Newton Krylov
(NavierStokes/NavierStokesChannelFlow.py:198-202, ksp_type tfqmr + ASM).
"""

import jax.numpy as jnp
import numpy as np

from stabilized_navier_stokes_flow_fenicsx.solve.krylov import (
    bicgstab, fgmres, tfqmr)


def _conv_diff(n, peclet=20.0):
    """1D convection-diffusion tridiagonal: nonsymmetric, well-posed."""
    h = 1.0 / (n + 1)
    A = np.zeros((n, n))
    for i in range(n):
        A[i, i] = 2.0 / h**2
        if i > 0:
            A[i, i - 1] = -1.0 / h**2 - peclet / (2 * h)
        if i < n - 1:
            A[i, i + 1] = -1.0 / h**2 + peclet / (2 * h)
    return A


def test_tfqmr_nonsymmetric_matches_direct():
    rng = np.random.default_rng(7)
    A = _conv_diff(60)
    b = rng.standard_normal(60)
    x_ref = np.linalg.solve(A, b)
    Aj = jnp.asarray(A)
    op = lambda v: Aj @ v
    res = tfqmr(op, jnp.asarray(b), rtol=1e-12, max_it=4000)
    assert bool(res.converged)
    # converged reports the quasi-residual bound; the true residual may
    # sit a small factor above it at deep tolerances
    assert float(res.resnorm) < 10 * 1e-12 * np.linalg.norm(b)
    assert np.max(np.abs(np.asarray(res.x) - x_ref)) < 1e-7 * np.max(
        np.abs(x_ref))


def test_tfqmr_preconditioned_fewer_matvecs():
    rng = np.random.default_rng(3)
    A = _conv_diff(120)
    b = rng.standard_normal(120)
    Aj = jnp.asarray(A)
    op = lambda v: Aj @ v
    dinv = jnp.asarray(1.0 / np.diag(A))
    M = lambda v: dinv * v
    plain = tfqmr(op, jnp.asarray(b), rtol=1e-10, max_it=8000)
    prec = tfqmr(op, jnp.asarray(b), M=M, rtol=1e-10, max_it=8000)
    assert bool(plain.converged) and bool(prec.converged)
    x_ref = np.linalg.solve(A, b)
    assert np.max(np.abs(np.asarray(prec.x) - x_ref)) < 1e-6
    # Jacobi must not be slower than unpreconditioned on this matrix
    assert int(prec.iters) <= int(plain.iters)


def test_tfqmr_agrees_with_fgmres_and_bicgstab():
    rng = np.random.default_rng(11)
    n = 80
    A = _conv_diff(n, peclet=35.0)
    b = rng.standard_normal(n)
    Aj = jnp.asarray(A)
    op = lambda v: Aj @ v
    dinv = jnp.asarray(1.0 / np.diag(A))
    M = lambda v: dinv * v
    xs = [
        tfqmr(op, jnp.asarray(b), M=M, rtol=1e-11, max_it=8000),
        bicgstab(op, jnp.asarray(b), M=M, rtol=1e-11, max_it=8000),
        fgmres(op, jnp.asarray(b), M=M, rtol=1e-11),
    ]
    for r in xs:
        assert bool(r.converged)
    x0 = np.asarray(xs[0].x)
    for r in xs[1:]:
        assert np.max(np.abs(np.asarray(r.x) - x0)) < 1e-6


def test_tfqmr_zero_rhs():
    Aj = jnp.asarray(_conv_diff(16))
    res = tfqmr(lambda v: Aj @ v, jnp.zeros(16), rtol=1e-10, max_it=100)
    assert bool(res.converged)
    assert float(jnp.linalg.norm(res.x)) == 0.0
