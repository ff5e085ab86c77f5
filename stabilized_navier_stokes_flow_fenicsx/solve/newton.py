"""Newton driver — the SNES equivalent.

Replacement for PETSc SNES (SURVEY.md 2.2): the reference sets
rtol=atol=1e-8, max_it=30 with a tfqmr inner KSP (reference
NavierStokes/NavierStokesChannelFlow.py:268-312).  Here the whole Newton
iteration, including re-assembly of the Jacobian block-CSR values and the
inner FGMRES solve, is one jitted ``lax.while_loop`` — the device runs
the entire nonlinear solve without talking to the host.

A backtracking line search on ||F|| stands in for SNES's default 'bt'
line search (damping is what lets Re 40-70 converge from the Stokes guess).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .krylov import fgmres, tfqmr


class NewtonResult(NamedTuple):
    x: jnp.ndarray
    iters: jnp.ndarray
    resnorm: jnp.ndarray
    converged: jnp.ndarray
    # per-iteration history (length max_it, padded with -1):
    #   [|F| after step, line-search lambda, KSP iters, KSP final resnorm]
    history: jnp.ndarray
    # True when the line search failed outright and the full step did not
    # reduce ||F|| — SNES would report a line-search divergence here
    # (reference SNES semantics, NavierStokesChannelFlow.py:281-283);
    # `converged` is False in that case.
    stalled: bool = False


def newton_solve(
    residual: Callable,            # x -> F(x)  (BC rows already substituted)
    jac_values: Callable,          # x -> block-CSR values of dF/dx
    make_operator: Callable,       # (values) -> (A(x) closure)
    make_pc: Callable,             # (values) -> (M(x) closure)
    x0: jnp.ndarray,
    rtol: float = 1e-8,
    atol: float = 1e-8,
    max_it: int = 30,
    ksp_rtol: float = 1e-8,
    ksp_restart: int = 50,
    ksp_max_restarts: int = 40,
    max_backtracks: int = 8,
    monitor: bool = False,
    ksp: str = "fgmres",
) -> NewtonResult:
    """Damped Newton with Krylov inner solves, fully jit-compatible.

    ksp="fgmres" (default) or "tfqmr" — the latter is the reference's
    actual SNES KSP (NavierStokesChannelFlow.py:198-202); TFQMR gets the
    same total matvec budget as FGMRES (restart * max_restarts)."""

    f0 = residual(x0)
    n0 = jnp.linalg.norm(f0)
    tol = jnp.maximum(rtol * n0, atol)
    # max(max_it, 1): a max_it=0 call (used to read ||F(x0)|| as resnorm)
    # still traces body, whose hist.at[it] update needs a non-empty array
    hist0 = jnp.full((max(max_it, 1), 4), -1.0, x0.dtype)

    def cond(s):
        x, F, fnorm, it, stalled, hist = s
        return (fnorm > tol) & (it < max_it) & (~stalled)

    def body(s):
        # the residual VECTOR rides in the loop state: the line search
        # already evaluates F at the accepted iterate, so re-assembling
        # it at the top of the next iteration (~0.3 s at bench scale)
        # would be pure waste — stepped max_it=1 dispatches hit that
        # once per dispatch
        x, F, fnorm, it, _, hist = s
        vals = jac_values(x)
        A = make_operator(vals)
        M = make_pc(vals)
        if ksp == "tfqmr":
            sol = tfqmr(A, -F, M=M, rtol=ksp_rtol,
                        max_it=ksp_restart * ksp_max_restarts)
        else:
            sol = fgmres(A, -F, M=M, rtol=ksp_rtol,
                         restart=ksp_restart, max_restarts=ksp_max_restarts)
        dx = sol.x

        # backtracking line search on ||F|| — while_loop so the common
        # full-step-accepted case costs ONE residual evaluation, not
        # max_backtracks of them (residuals are ~0.3 s at bench scale).
        # The FIRST trial (lam=1) is saved in the carry: when nothing
        # helps, the "take the full step anyway" fallback reuses it —
        # both a free fallback and one fewer residual graph in the
        # executable
        def ls_cond(carry):
            lam, best_F, best_norm, F1, n1, accepted, k = carry
            return (~accepted) & (k < max_backtracks)

        def ls_body(carry):
            lam, best_F, best_norm, F1, n1, accepted, k = carry
            Ft = residual(x + lam * dx)
            trial = jnp.linalg.norm(Ft)
            first = k == 0
            F1 = jnp.where(first, Ft, F1)
            n1 = jnp.where(first, trial, n1)
            good = trial < (1.0 - 1e-4 * lam) * fnorm
            best_F = jnp.where(good, Ft, best_F)
            best_norm = jnp.where(good, trial, best_norm)
            lam_out = jnp.where(good, lam, lam * 0.5)
            return (lam_out, best_F, best_norm, F1, n1, good, k + 1)

        lam0 = jnp.ones((), x.dtype)
        lam, F_new, new_norm, F1, n1, accepted, _ = jax.lax.while_loop(
            ls_cond, ls_body,
            (lam0, F, fnorm, F, fnorm, jnp.array(False),
             jnp.array(0, jnp.int32)))
        # if nothing helped, take the full step anyway (SNES would diverge;
        # we flag the stall instead and report converged=False); F at the
        # full step was the line search's first trial
        lam = jnp.where(accepted, lam, 1.0)
        x_new = x + lam * dx
        F_new = jnp.where(accepted, F_new, F1)
        new_norm = jnp.where(accepted, new_norm, n1)
        stalled = (~accepted) & (new_norm >= fnorm)
        hist = hist.at[it].set(jnp.stack([
            new_norm, lam, sol.iters.astype(x.dtype), sol.resnorm]))
        # on stall KEEP the pre-step iterate (SNES line-search-divergence
        # semantics: the last good iterate is the result) — consumers
        # that ignore `stalled` no longer get a silently degraded x;
        # hist still records the rejected step's ||F||
        x_new = jnp.where(stalled, x, x_new)
        F_new = jnp.where(stalled, F, F_new)
        new_norm = jnp.where(stalled, fnorm, new_norm)
        return (x_new, F_new, new_norm, it + 1, stalled, hist)

    state = (x0, f0, n0, jnp.array(0, jnp.int32), jnp.array(False), hist0)
    x, _F, fnorm, it, stalled, hist = jax.lax.while_loop(cond, body, state)
    return NewtonResult(x, it, fnorm, fnorm <= tol, hist, stalled)
