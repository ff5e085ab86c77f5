"""Device-resident Krylov solvers.

Replacement for PETSc KSP (SURVEY.md 2.2): the reference solves
with tfqmr+ASM (NavierStokes/NavierStokesChannelFlow.py:198-202), bcgs
(StokesFlow/StokesChannelFlow.py:166), fgmres+asm
(Validation_Flow/DFG_3D_Validation.py:167-172) and preonly+LU
(image2inlet.py:272).  The discrete solution of a converged Krylov solve is
solver-independent, so parity needs matching *tolerances*, not matching
algorithms; we keep FGMRES (robust for the stabilized saddle-point system),
BiCGStab (cheap), CG (SPD inlet Poisson), MINRES (Taylor-Hood saddle
point) — and TFQMR itself (the reference's Newton KSP), for exact
algorithmic parity where wanted.

All loops are ``lax.while_loop``s — one XLA program per solve, zero host
round-trips.  Operators are closures x -> A x (matrix-free or block-CSR).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class KrylovResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray          # iterations performed
    resnorm: jnp.ndarray        # final (preconditioned for fgmres) residual norm
    converged: jnp.ndarray      # bool


def _ident(x):
    return x


def cg(A, b, x0=None, M=None, rtol=1e-10, atol=0.0, max_it=10000) -> KrylovResult:
    """Preconditioned conjugate gradients (SPD systems)."""
    M = M or _ident
    x0 = jnp.zeros_like(b) if x0 is None else x0
    r0 = b - A(x0)
    z0 = M(r0)
    bnorm = jnp.linalg.norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)

    def cond(s):
        x, r, z, p, rz, it = s
        return (jnp.linalg.norm(r) > tol) & (it < max_it)

    def body(s):
        x, r, z, p, rz, it = s
        Ap = A(p)
        alpha = rz / jnp.vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        rz_new = jnp.vdot(r, z)
        p = z + (rz_new / rz) * p
        return (x, r, z, p, rz_new, it + 1)

    state = (x0, r0, z0, z0, jnp.vdot(r0, z0), jnp.array(0, jnp.int32))
    x, r, *_, it = jax.lax.while_loop(cond, body, state)
    rn = jnp.linalg.norm(r)
    return KrylovResult(x, it, rn, rn <= tol)


def bicgstab(A, b, x0=None, M=None, rtol=1e-10, atol=0.0, max_it=10000
             ) -> KrylovResult:
    """Right-preconditioned BiCGStab."""
    M = M or _ident
    x0 = jnp.zeros_like(b) if x0 is None else x0
    r0 = b - A(x0)
    bnorm = jnp.linalg.norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)
    rhat = r0

    def cond(s):
        x, r, p, v, rho, alpha, omega, it, brk = s
        return (jnp.linalg.norm(r) > tol) & (it < max_it) & (~brk)

    def body(s):
        x, r, p, v, rho, alpha, omega, it, brk = s
        rho_new = jnp.vdot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = A(phat)
        denom = jnp.vdot(rhat, v)
        alpha = rho_new / denom
        s_vec = r - alpha * v
        shat = M(s_vec)
        t = A(shat)
        tt = jnp.vdot(t, t)
        omega = jnp.where(tt > 0, jnp.vdot(t, s_vec) / tt, 0.0)
        x = x + alpha * phat + omega * shat
        r = s_vec - omega * t
        brk = (jnp.abs(rho_new) < 1e-300) | (jnp.abs(omega) < 1e-300)
        return (x, r, p, v, rho_new, alpha, omega, it + 1, brk)

    one = jnp.ones((), b.dtype)
    state = (x0, r0, jnp.zeros_like(b), jnp.zeros_like(b),
             one, one, one, jnp.array(0, jnp.int32), jnp.array(False))
    x, r, *_, it, _brk = jax.lax.while_loop(cond, body, state)
    rn = jnp.linalg.norm(r)
    return KrylovResult(x, it, rn, rn <= tol)


def tfqmr(A, b, x0=None, M=None, rtol=1e-10, atol=0.0, max_it=10000
          ) -> KrylovResult:
    """Right-preconditioned transpose-free QMR (Freund 1993).

    The reference's actual Newton Krylov: PETSc ``ksp_type tfqmr`` + ASM
    (NavierStokes/NavierStokesChannelFlow.py:198-202).  Structured as a
    ``lax.while_loop`` over HALF-steps so each body carries exactly one
    operator apply and one preconditioner apply (same per-matvec cost as
    BiCGStab, and no ``lax.cond`` duplication of the A/M graphs — the
    executable-size rule of docs/ARCHITECTURE.md).  ``max_it`` counts
    matvecs (half-steps), matching PETSc's accounting.

    Convergence uses the standard quasi-residual bound
    ``|r_j| <= tau_j * sqrt(j+1)`` — the same estimate PETSc's KSPTFQMR
    convergence test monitors — and ``converged`` reports that bound.
    The returned ``resnorm`` is the TRUE residual norm ``|b - A x|``
    computed once after the loop; in finite precision it can sit a small
    factor above the bound at deep tolerances.
    """
    M = M or _ident
    x0 = jnp.zeros_like(b) if x0 is None else x0
    r0 = b - A(x0)
    bnorm = jnp.linalg.norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)
    rstar = r0
    Mu0 = M(r0)
    Bu0 = A(Mu0)
    tiny = 1e-30

    def cond(s):
        (x, w, u, Mu, Bu, v, d, tau, theta, eta, rho, alpha, it, brk) = s
        # quasi-residual bound tau * sqrt(it+1)
        bound = tau * jnp.sqrt(jnp.asarray(it + 1, tau.dtype))
        return (bound > tol) & (it < max_it) & (~brk)

    def body(s):
        (x, w, u, Mu, Bu, v, d, tau, theta, eta, rho, alpha, it, brk) = s
        even = (it % 2) == 0
        sigma = jnp.vdot(rstar, v)
        alpha = jnp.where(even, rho / sigma, alpha)
        w = w - alpha * Bu
        d = Mu + (theta * theta * eta / alpha) * d
        theta_n = jnp.linalg.norm(w) / tau
        c = 1.0 / jnp.sqrt(1.0 + theta_n * theta_n)
        tau_n = tau * theta_n * c
        eta_n = c * c * alpha
        x = x + eta_n * d
        # next search direction: even half uses u - alpha v; odd half
        # restarts from w with the new rho
        rho_new = jnp.vdot(rstar, w)
        beta = rho_new / rho
        u_next = jnp.where(even, u - alpha * v, w + beta * u)
        Mu_next = M(u_next)
        Bu_next = A(Mu_next)
        v_next = jnp.where(even, v, Bu_next + beta * (Bu + beta * v))
        rho_n = jnp.where(even, rho, rho_new)
        brk = (jnp.abs(sigma) < tiny) | (jnp.abs(rho_n) < tiny)
        return (x, w, u_next, Mu_next, Bu_next, v_next, d, tau_n,
                theta_n, eta_n, rho_n, alpha, it + 1, brk)

    zero = jnp.zeros((), b.dtype)
    state = (x0, r0, r0, Mu0, Bu0, Bu0, jnp.zeros_like(b),
             jnp.linalg.norm(r0), zero, zero, jnp.vdot(r0, r0),
             jnp.ones((), b.dtype), jnp.array(0, jnp.int32),
             jnp.array(False))
    out = jax.lax.while_loop(cond, body, state)
    x, tau, it = out[0], out[7], out[12]
    bound = tau * jnp.sqrt(jnp.asarray(it + 1, tau.dtype))
    rn = jnp.linalg.norm(b - A(x))
    return KrylovResult(x, it, rn, bound <= tol)


def fgmres(
    A: Callable,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    M: Optional[Callable] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    restart: int = 50,
    max_restarts: int = 40,
) -> KrylovResult:
    """Flexible GMRES(m) with right preconditioning.

    Arnoldi with modified Gram-Schmidt; the Z basis stores preconditioned
    vectors (flexible), so M may itself be an inner iteration.
    """
    M = M or _ident
    x0 = jnp.zeros_like(b) if x0 is None else x0
    n = b.shape[0]
    m = restart
    dtype = b.dtype
    bnorm = jnp.linalg.norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)

    def arnoldi_cycle(x):
        r = b - A(x)
        beta = jnp.linalg.norm(r)
        steps = jnp.array(0, jnp.int32)

        V = jnp.zeros((m + 1, n), dtype)
        Z = jnp.zeros((m, n), dtype)
        H = jnp.zeros((m + 1, m), dtype)
        # Givens rotation accumulators
        cs = jnp.zeros(m, dtype)
        sn = jnp.zeros(m, dtype)
        g = jnp.zeros(m + 1, dtype).at[0].set(beta)
        V = V.at[0].set(jnp.where(beta > 0, r / beta, r))

        def body(j, carry):
            V, Z, H, cs, sn, g, done, steps = carry
            z = M(V[j])
            w = A(z)

            # modified Gram-Schmidt against all m+1 basis vectors, masked
            def mgs(i, carry2):
                w, H = carry2
                keep = i <= j
                hij = jnp.where(keep, jnp.vdot(V[i], w), 0.0)
                w = w - hij * V[i]
                H = H.at[i, j].set(hij)
                return (w, H)

            w, H = jax.lax.fori_loop(0, m + 1, mgs, (w, H))
            hj1 = jnp.linalg.norm(w)
            H = H.at[j + 1, j].set(hj1)
            V = V.at[j + 1].set(jnp.where(hj1 > 0, w / hj1, w))
            Z = Z.at[j].set(z)

            # apply previous Givens rotations to column j
            def rot(i, Hcol):
                keep = i < j
                h_i = jnp.where(keep, cs[i] * Hcol[i] + sn[i] * Hcol[i + 1], Hcol[i])
                h_i1 = jnp.where(keep, -sn[i] * Hcol[i] + cs[i] * Hcol[i + 1], Hcol[i + 1])
                return Hcol.at[i].set(h_i).at[i + 1].set(h_i1)

            Hcol = jax.lax.fori_loop(0, m, rot, H[:, j])
            denom = jnp.sqrt(Hcol[j] ** 2 + Hcol[j + 1] ** 2)
            c = jnp.where(denom > 0, Hcol[j] / denom, 1.0)
            s = jnp.where(denom > 0, Hcol[j + 1] / denom, 0.0)
            Hcol = Hcol.at[j].set(c * Hcol[j] + s * Hcol[j + 1]).at[j + 1].set(0.0)
            H = H.at[:, j].set(Hcol)
            cs = cs.at[j].set(c)
            sn = sn.at[j].set(s)
            g = g.at[j + 1].set(-s * g[j]).at[j].set(c * g[j])
            done = jnp.abs(g[j + 1]) <= tol
            return (V, Z, H, cs, sn, g, done, steps + 1)

        # run all m steps (static); masking keeps the math exact and XLA
        # fuses it into one compiled loop.  Early-exit handled by `done`
        # only to pick the solution size.
        def body_wrap(j, carry):
            return jax.lax.cond(
                carry[6], lambda c: c, lambda c: body(j, c), carry)

        carry = (V, Z, H, cs, sn, g, jnp.array(False), steps)
        V, Z, H, cs, sn, g, done, steps = jax.lax.fori_loop(
            0, m, body_wrap, carry)

        # back-substitution on the triangularized H (masked for early exit:
        # columns never formed have H[j,j]=0 -> treat y_j = 0)
        col_ids = jnp.arange(m)

        def back(i, y):
            j = m - 1 - i
            hj = H[j, j]
            upper = jnp.where(col_ids > j, H[j, :], 0.0)
            num = g[j] - jnp.dot(upper, y)
            yj = jnp.where(jnp.abs(hj) > 0, num / hj, 0.0)
            return y.at[j].set(yj)

        y = jax.lax.fori_loop(0, m, back, jnp.zeros(m, dtype))
        x_new = x + Z.T @ y
        return x_new, steps

    def cond(s):
        x, cycles, its, rn = s
        return (rn > tol) & (cycles < max_restarts)

    def body(s):
        x, cycles, its, rn = s
        x, steps = arnoldi_cycle(x)
        # exact residual recompute per cycle (the Givens estimate drifts
        # under a strong nonlinear/low-precision PC)
        rn = jnp.linalg.norm(b - A(x))
        return (x, cycles + 1, its + steps, rn)

    rn0 = jnp.linalg.norm(b - A(x0))
    x, cycles, its, rn = jax.lax.while_loop(
        cond, body, (x0, jnp.array(0, jnp.int32), jnp.array(0, jnp.int32),
                     rn0))
    return KrylovResult(x, its, rn, rn <= tol)


def minres(
    A: Callable,
    b: jnp.ndarray,
    x0: Optional[jnp.ndarray] = None,
    M: Optional[Callable] = None,
    rtol: float = 1e-8,
    atol: float = 0.0,
    max_it: int = 10000,
) -> KrylovResult:
    """Preconditioned MINRES (Paige-Saunders) for symmetric indefinite A.

    M must be symmetric positive definite (e.g. the block-diagonal
    diag(diag(A_uu), M_p) preconditioner for the Taylor-Hood saddle
    point).  Replaces the reference's MUMPS direct solve for the
    unstabilized P2-P1 system (reference StokesFlow/DuctStokesFlow.py:
    213-216) with a device-resident iteration.
    """
    M = M or _ident
    x0 = jnp.zeros_like(b) if x0 is None else x0
    r1 = b - A(x0)
    y = M(r1)
    beta1 = jnp.sqrt(jnp.vdot(r1, y))
    tol = jnp.maximum(rtol * beta1, atol)
    eps_t = jnp.asarray(jnp.finfo(b.dtype).tiny, b.dtype)

    def cond(s):
        (x, r1, r2, y, oldb, beta, dbar, epsln, phibar, cs, sn,
         w, w2, it) = s
        return (phibar > tol) & (it < max_it)

    def body(s):
        (x, r1, r2, y, oldb, beta, dbar, epsln, phibar, cs, sn,
         w, w2, it) = s
        v = y / jnp.maximum(beta, eps_t)
        y2 = A(v)
        y2 = jnp.where(it >= 1, y2 - (beta / jnp.maximum(oldb, eps_t)) * r1,
                       y2)
        alfa = jnp.vdot(v, y2)
        y2 = y2 - (alfa / jnp.maximum(beta, eps_t)) * r2
        r1n, r2n = r2, y2
        yn = M(r2n)
        oldbn = beta
        betan = jnp.sqrt(jnp.maximum(jnp.vdot(r2n, yn), 0.0))
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln_n = sn * betan
        dbar_n = -cs * betan
        gamma = jnp.maximum(jnp.sqrt(gbar**2 + betan**2), eps_t)
        cs_n = gbar / gamma
        sn_n = betan / gamma
        phi = cs_n * phibar
        phibar_n = sn_n * phibar
        w1 = w2
        w2n = w
        wn = (v - oldeps * w1 - delta * w2n) / gamma
        xn = x + phi * wn
        return (xn, r1n, r2n, yn, oldbn, betan, dbar_n, epsln_n,
                phibar_n, cs_n, sn_n, wn, w2n, it + 1)

    zero = jnp.zeros_like(b)
    one = jnp.ones((), b.dtype)
    state = (x0, r1, r1, y, jnp.zeros((), b.dtype), beta1,
             jnp.zeros((), b.dtype), jnp.zeros((), b.dtype), beta1,
             -one, jnp.zeros((), b.dtype), zero, zero,
             jnp.array(0, jnp.int32))
    out = jax.lax.while_loop(cond, body, state)
    x, phibar, it = out[0], out[8], out[13]
    return KrylovResult(x, it, phibar, phibar <= tol)
