"""Iterative-refinement Newton: reference-grade 1e-8 tolerances from f32.

The plain f32 Newton (solve/newton.py) floors at ~1e-6 relative residual —
the f32 assembly cannot *measure* the residual any finer.  This driver
continues from the f32 solution with the residual evaluated in two-f32
double-float (assemble/df_assembly.py) and the iterate carried as an
unevaluated hi+lo pair; the Jacobian and the inner FGMRES solve stay f32
(classical mixed-precision iterative refinement: the correction equation
only needs a few digits, the residual needs all of them).  Convergence is
linear at rate ~ cond(J)*eps_f32 per step, reaching the reference SNES's
rtol=atol=1e-8 (reference NavierStokes/NavierStokesChannelFlow.py:281-283)
in a handful of cheap steps.

The whole refinement loop is one ``lax.while_loop`` — zero host
round-trips, like the base Newton.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..utils.dfloat import DF, df_add, df_norm
from .krylov import fgmres


class RefineResult(NamedTuple):
    x_hi: jnp.ndarray
    x_lo: jnp.ndarray
    iters: jnp.ndarray
    resnorm: jnp.ndarray        # compensated ||F||
    converged: jnp.ndarray
    # per-iteration [||F|| after step, KSP iters, KSP resnorm], padded -1
    history: jnp.ndarray

    @property
    def x(self):
        """Best f32 representation of the refined solution."""
        return self.x_hi + self.x_lo


def refine_newton(
    residual_df: Callable,         # DF x -> DF F(x)  (BC rows substituted)
    jac_values: Callable,          # f32 x -> block-CSR values of dF/dx
    make_operator: Callable,
    make_pc: Callable,
    x0: jnp.ndarray,               # f32 Newton solution (starting point)
    n0: jnp.ndarray,               # ||F|| at the *original* Newton start
    rtol: float = 1e-8,
    atol: float = 1e-8,
    max_it: int = 10,
    ksp_rtol: float = 1e-2,
    ksp_restart: int = 50,
    ksp_max_restarts: int = 8,
    x0_lo: jnp.ndarray = None,
) -> RefineResult:
    """Push ||F|| below max(rtol*n0, atol) with df residuals.

    SNES semantics: n0 is the residual norm at the start of the overall
    nonlinear solve, so rtol means the same thing it means to PETSc.
    x0_lo: low word of a df iterate to resume from (stepped dispatch).
    """
    x = DF(x0, jnp.zeros_like(x0) if x0_lo is None else x0_lo)
    F = residual_df(x)
    fnorm = df_norm(F)
    tol = jnp.maximum(rtol * n0, atol)
    # max(max_it, 1): lax.while_loop traces the body even with trip
    # count 0, and hist.at[it].set on a zero-length array fails (same
    # guard as solve/newton.py hist0 — max_it=0 probe dispatches)
    hist0 = jnp.full((max(max_it, 1), 3), -1.0, x0.dtype)

    def cond(s):
        x, F, fnorm, it, stalled, hist = s
        return (fnorm > tol) & (it < max_it) & (~stalled)

    def body(s):
        x, F, fnorm, it, _, hist = s
        vals = jac_values(x.hi)
        A = make_operator(vals)
        M = make_pc(vals)
        rhs = -(F.hi + F.lo)       # F is tiny; one f32 word holds it fully
        sol = fgmres(A, rhs, M=M, rtol=ksp_rtol,
                     restart=ksp_restart, max_restarts=ksp_max_restarts)
        x_new = df_add(x, DF(sol.x, jnp.zeros_like(sol.x)))
        F_new = residual_df(x_new)
        fnew = df_norm(F_new)
        # no line search: refinement starts inside Newton's basin.  If a
        # step fails to reduce ||F|| (Jacobian too inaccurate / f32 floor
        # of the *solution representation* reached), keep the better
        # iterate and stop.
        better = fnew < fnorm
        x_keep = DF(jnp.where(better, x_new.hi, x.hi),
                    jnp.where(better, x_new.lo, x.lo))
        F_keep = DF(jnp.where(better, F_new.hi, F.hi),
                    jnp.where(better, F_new.lo, F.lo))
        f_keep = jnp.where(better, fnew, fnorm)
        hist = hist.at[it].set(jnp.stack(
            [fnew, sol.iters.astype(x0.dtype), sol.resnorm]))
        return (x_keep, F_keep, f_keep, it + 1, ~better, hist)

    state = (x, F, fnorm, jnp.array(0, jnp.int32), jnp.array(False), hist0)
    x, F, fnorm, it, stalled, hist = jax.lax.while_loop(cond, body, state)
    return RefineResult(x.hi, x.lo, it, fnorm, fnorm <= tol, hist)
