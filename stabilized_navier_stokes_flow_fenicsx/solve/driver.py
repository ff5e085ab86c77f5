"""Jitted end-to-end solve drivers over block-CSR assembled systems.

These are the equivalents of ``fem.petsc.LinearProblem`` and the SNES driver
(reference NavierStokes/NavierStokesChannelFlow.py:197-218, 268-312), as
single jit-compiled programs: assembly, preconditioner setup, Krylov/Newton
iteration all fuse into one XLA executable; the host only sees the final
state.  All mesh data flows through as arguments (never closure constants).
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

from ..assemble.assembly import (
    AsmArrays, bcsr_matvec, matrix_values_of, residual_of)
from ..assemble.df_assembly import DFArrays, df_residual_of
from ..assemble.layered import (
    LayeredArrays, layered_diag_blocks, layered_matvec,
    make_layered_op, matrix_values_layered, residual_layered)
from ..utils.dfloat import DF, df_add, df_mul
from .krylov import KrylovResult, cg, fgmres
from .newton import NewtonResult, newton_solve
from .precond import block_jacobi, plane_gs_grouped, plane_gs_layered
from .refine import RefineResult, refine_newton


def parse_mg_pc(pc: str):
    """Parse an mg PC name into (smoother, cheby_degree, cycle, dtype).

    Grammar: ``mg[_<smoother>][<cheby_degree>][w][_bf16]`` — e.g.
    mg_cheby_bf16, mg_cheby6_bf16 (degree-6 Chebyshev), mg_chebyw_bf16
    (W-cycle).  The degree/cycle suffixes exist so the stepped drivers
    (whose pc argument is a static string) can reach make_mg_pc's
    cycle_type/cheby_degree knobs.  Returns None for non-mg names.
    """
    import re

    if not pc.startswith("mg"):
        return None
    m = re.fullmatch(
        r"mg(?:_(jacobi|cheby|grouped|lined|linej|line|zebra))?"
        r"(\d*)(w?)(_bf16)?", pc)
    if m is None:
        return None
    # no-digit default degree 6: with the tail-max interval estimate
    # (solve/mg.py), degree 4's T_4(sigma) normalization is too small
    # for the NS Jacobian's complex spectrum (CPU-measured divergence
    # even at benign states at 1.05M) — write mg_cheby4 explicitly to
    # get the old degree.
    return (m.group(1) or "plane_gs",
            int(m.group(2)) if m.group(2) else 6,
            "w" if m.group(3) else "v",
            jnp.bfloat16 if m.group(4) else None)


def _layered_pc(pc, arrays, n2d, n_planes, mask, mg=None):
    """PC factory for the layered operator: values -> closure.

    'plane_gs' / 'plane_gs_bf16' -> per-plane Gauss-Seidel sweeps (4x
    fewer Krylov iterations than block-Jacobi at ~2 SpMV-equivalents per
    apply).  'plane_gs_grouped' relaxes 8 planes jointly: half the
    iterations again but ~3x the work per apply — wins only when scan
    latency dominates (small cross-sections).  'mg*' names (grammar in
    ``parse_mg_pc``) -> aggregation multigrid V-cycle (solve/mg.py);
    requires the ``mg`` hierarchy argument.
    """
    _mg_pat = parse_mg_pc(pc)
    if _mg_pat:
        from .mg import make_mg_pc

        assert mg is not None, "pc='mg' needs a build_mg_hierarchy result"
        sm, degree, cyc, dt = _mg_pat

        # diagnostic/tuning escape hatches (read at TRACE time — set
        # before the first dispatch of a given program; distinct values
        # produce distinct HLO so the persistent cache stays correct):
        import os as _os

        # defaults MUST track make_mg_pc's (cheby_alpha=3, safety=1.4):
        # alpha 4 amplifies at the 1.05M hard state even with the
        # tail-max interval (CPU-measured rho 1.9) — the (1 + 1/alpha)
        # safe-range extension above the interval top is load-bearing
        alpha = float(_os.environ.get("SNS_CHEBY_ALPHA", "3.0"))
        safety = float(_os.environ.get("SNS_CHEBY_SAFETY", "1.4"))

        def make(values):
            return make_mg_pc(
                mg, values, arrays.cols, arrays.row_ids, arrays.diag_pos,
                mask, n2d, n_planes, pc_dtype=dt, smoother=sm,
                cycle_type=cyc, cheby_degree=degree, cheby_alpha=alpha,
                cheby_safety=safety)
    elif pc in ("zebra", "zebra_bf16"):
        from .precond import plane_zebra_layered

        dt = jnp.bfloat16 if pc.endswith("bf16") else None

        def make(values):
            return plane_zebra_layered(
                values, arrays.cols, arrays.row_ids, arrays.diag_pos,
                mask, n2d, n_planes, pc_dtype=dt)
    elif pc in ("line_cr", "line_cr_bf16"):
        from .precond import line_cr_layered

        dt = jnp.bfloat16 if pc.endswith("bf16") else None

        def make(values):
            return line_cr_layered(
                values, arrays.diag_pos, mask, n2d, n_planes, pc_dtype=dt)
    elif pc in ("plane_gs", "plane_gs_bf16"):
        dt = jnp.bfloat16 if pc.endswith("bf16") else None

        def make(values):
            return plane_gs_layered(
                values, arrays.cols, arrays.row_ids, arrays.diag_pos,
                mask, n2d, n_planes, pc_dtype=dt)
    elif pc == "plane_gs_grouped":
        def make(values):
            return plane_gs_grouped(
                values, arrays.cols, arrays.row_ids, arrays.diag_pos,
                mask, n2d, n_planes, group=8)
    else:
        def make(values):
            return block_jacobi(
                layered_diag_blocks(arrays, n2d, values), mask)
    return make


def _bc_op(arrays, n_rows, values, mask):
    def op(x):
        return mask * bcsr_matvec(arrays, n_rows, values, mask * x) \
            + (1.0 - mask) * x
    return op


@partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6))
def solve_linear_bcsr(
    kernel: Callable,
    ndofs: int,
    nnzb: int,
    bs: int,
    n_rows: int,
    rtol: float,
    restart: int,
    arrays: AsmArrays,
    mask: jnp.ndarray,
    g: jnp.ndarray,
) -> KrylovResult:
    """Assemble the affine form and solve with FGMRES + node-block Jacobi."""
    zero = jnp.zeros(ndofs, mask.dtype)
    values = matrix_values_of(kernel, nnzb, bs, arrays, zero)
    b = -residual_of(kernel, ndofs, arrays, zero)
    b_bc = mask * (b - bcsr_matvec(arrays, n_rows, values, g)) + g
    A = _bc_op(arrays, n_rows, values, mask)
    M = block_jacobi(values[arrays.diag_pos], mask)
    return fgmres(A, b_bc, M=M, rtol=rtol, restart=restart, max_restarts=80)


@partial(jax.jit, static_argnums=(0, 1, 2))
def solve_spd_cg(
    kernel: Callable,
    ndofs: int,
    rtol: float,
    arrays: AsmArrays,
    mask: jnp.ndarray,
    g: jnp.ndarray,
) -> KrylovResult:
    """Assemble an SPD affine form (Poisson) and solve with Jacobi-CG.

    Matrix-free: A x comes from the linearity of the residual kernel,
    A x = r(x) - r(0), so no sparsity pattern is needed at all.
    """
    zero = jnp.zeros(ndofs, mask.dtype)
    r0 = residual_of(kernel, ndofs, arrays, zero)
    b = -r0

    def A_raw(x):
        return residual_of(kernel, ndofs, arrays, x) - r0

    def A(x):
        # symmetric projection: P A P + (I - P) — CG needs SPD
        return mask * A_raw(mask * x) + (1.0 - mask) * x

    b_bc = mask * (b - A_raw(g)) + g
    # Jacobi diagonal via probing the residual with basis... too costly;
    # use unpreconditioned CG (inlet Poisson systems are tiny and well
    # conditioned after the h^2 scaling).
    return cg(A, b_bc, rtol=rtol, max_it=ndofs * 4)


@partial(jax.jit, static_argnums=(1, 2, 3, 7, 8, 9, 10))
def solve_linear_layered(
    kernel: Callable,
    n2d: int,
    n_planes: int,
    bs: int,
    arrays: LayeredArrays,
    mask: jnp.ndarray,
    g: jnp.ndarray,
    E: int,
    rtol: float,
    restart: int,
    pc: str = "plane_gs",
    mg=None,
) -> KrylovResult:
    """Affine form on the layered operator: FGMRES + node-block Jacobi."""
    ndofs = n2d * n_planes * bs
    zero = jnp.zeros(ndofs, mask.dtype)
    values = matrix_values_layered(kernel, E, n_planes, bs, arrays, zero)
    b = -residual_layered(kernel, n2d, n_planes, bs, arrays, zero)
    b_bc = mask * (b - layered_matvec(arrays, n2d, n_planes, values, g)) + g
    A = make_layered_op(arrays, n2d, n_planes, values, mask)
    M = _layered_pc(pc, arrays, n2d, n_planes, mask, mg)(values)
    return fgmres(A, b_bc, M=M, rtol=rtol, restart=restart, max_restarts=80)


@partial(jax.jit, static_argnums=(1, 2, 3, 8))
def residual_norm_layered(
    kernel: Callable,
    n2d: int,
    n_planes: int,
    bs: int,
    arrays: LayeredArrays,
    mask: jnp.ndarray,
    g: jnp.ndarray,
    w: jnp.ndarray,
    E: int,
) -> jnp.ndarray:
    """||F(w)|| with BC rows substituted — a SMALL standalone program.

    Exists so callers (the stepped drivers, bench.py) can read the
    initial Newton residual without compiling a full max_it=0
    Newton+FGMRES+V-cycle program; this assembly-only program is much
    smaller.
    """
    r = residual_layered(kernel, n2d, n_planes, bs, arrays, w)
    return jnp.linalg.norm(mask * r + (1.0 - mask) * (w - g))


@partial(jax.jit, static_argnums=(1, 2, 3) + tuple(range(8, 16)) + (17,))
def solve_newton_layered(
    kernel: Callable,
    n2d: int,
    n_planes: int,
    bs: int,
    arrays: LayeredArrays,
    mask: jnp.ndarray,
    g: jnp.ndarray,
    w0: jnp.ndarray,
    E: int,
    rtol: float = 1e-8,
    atol: float = 1e-8,
    max_it: int = 30,
    ksp_rtol: float = 1e-8,
    ksp_restart: int = 50,
    ksp_max_restarts: int = 40,
    pc: str = "plane_gs",
    mg=None,
    ksp: str = "fgmres",
) -> NewtonResult:
    """Newton on the layered (plane-structured) operator — the fast path
    for extruded channel meshes (see assemble/layered.py)."""
    def residual(w):
        r = residual_layered(kernel, n2d, n_planes, bs, arrays, w)
        return mask * r + (1.0 - mask) * (w - g)

    def jac_values(w):
        return matrix_values_layered(kernel, E, n_planes, bs, arrays, w)

    def make_op(values):
        return make_layered_op(arrays, n2d, n_planes, values, mask)

    make_pc = _layered_pc(pc, arrays, n2d, n_planes, mask, mg)

    return newton_solve(
        residual, jac_values, make_op, make_pc, w0,
        rtol=rtol, atol=atol, max_it=max_it, ksp_rtol=ksp_rtol,
        ksp_restart=ksp_restart, ksp_max_restarts=ksp_max_restarts,
        ksp=ksp)


@partial(jax.jit, static_argnums=(1, 2, 3, 4) + tuple(range(9, 16)))
def solve_newton_bcsr(
    kernel: Callable,
    ndofs: int,
    nnzb: int,
    bs: int,
    n_rows: int,
    arrays: AsmArrays,
    mask: jnp.ndarray,
    g: jnp.ndarray,
    w0: jnp.ndarray,
    rtol: float = 1e-8,
    atol: float = 1e-8,
    max_it: int = 30,
    ksp_rtol: float = 1e-8,
    ksp_restart: int = 50,
    ksp_max_restarts: int = 40,
    monitor: bool = False,
) -> NewtonResult:
    """Newton on a nonlinear form with BC rows substituted (SNES semantics)."""

    def residual(w):
        r = residual_of(kernel, ndofs, arrays, w)
        return mask * r + (1.0 - mask) * (w - g)

    def jac_values(w):
        return matrix_values_of(kernel, nnzb, bs, arrays, w)

    def make_op(values):
        return _bc_op(arrays, n_rows, values, mask)

    def make_pc(values):
        return block_jacobi(values[arrays.diag_pos], mask)

    return newton_solve(
        residual, jac_values, make_op, make_pc, w0,
        rtol=rtol, atol=atol, max_it=max_it, ksp_rtol=ksp_rtol,
        ksp_restart=ksp_restart, ksp_max_restarts=ksp_max_restarts,
        monitor=monitor)


def _df_bc_residual(kernel_df, ndofs, dfa, mask, g_df):
    """DF x -> DF F(x) with Dirichlet rows substituted (w - g)."""
    inv_mask = 1.0 - mask
    zeros = jnp.zeros_like(mask)

    def residual_df(w: DF) -> DF:
        r = df_residual_of(kernel_df, ndofs, dfa, w)
        wm = df_add(w, -g_df)
        return df_add(df_mul(r, DF(mask, zeros)),
                      df_mul(wm, DF(inv_mask, zeros)))

    return residual_df


@partial(jax.jit, static_argnums=(2, 3, 4, 5) + tuple(range(13, 20)))
def refine_newton_layered(
    kernel: Callable,
    kernel_df: Callable,
    n2d: int,
    n_planes: int,
    bs: int,
    E: int,
    arrays: LayeredArrays,
    dfa: DFArrays,
    mask: jnp.ndarray,
    g_hi: jnp.ndarray,
    g_lo: jnp.ndarray,
    x0: jnp.ndarray,
    n0: jnp.ndarray,
    rtol: float = 1e-8,
    atol: float = 1e-8,
    max_it: int = 10,
    ksp_rtol: float = 1e-2,
    ksp_restart: int = 50,
    ksp_max_restarts: int = 8,
    pc: str = "plane_gs",
    mg=None,
    x0_lo=None,
) -> RefineResult:
    """Iterative refinement on the layered fast path: df residual, f32
    Jacobian + FGMRES (see solve/refine.py)."""
    ndofs = n2d * n_planes * bs
    residual_df = _df_bc_residual(
        kernel_df, ndofs, dfa, mask, DF(g_hi, g_lo))

    def jac_values(w):
        return matrix_values_layered(kernel, E, n_planes, bs, arrays, w)

    def make_op(values):
        return make_layered_op(arrays, n2d, n_planes, values, mask)

    make_pc = _layered_pc(pc, arrays, n2d, n_planes, mask, mg)
    return refine_newton(
        residual_df, jac_values, make_op, make_pc, x0, n0,
        rtol=rtol, atol=atol, max_it=max_it, ksp_rtol=ksp_rtol,
        ksp_restart=ksp_restart, ksp_max_restarts=ksp_max_restarts,
        x0_lo=x0_lo)


@partial(jax.jit, static_argnums=(2, 3, 4, 5) + tuple(range(13, 19)))
def refine_newton_bcsr(
    kernel: Callable,
    kernel_df: Callable,
    ndofs: int,
    nnzb: int,
    bs: int,
    n_rows: int,
    arrays: AsmArrays,
    dfa: DFArrays,
    mask: jnp.ndarray,
    g_hi: jnp.ndarray,
    g_lo: jnp.ndarray,
    x0: jnp.ndarray,
    n0: jnp.ndarray,
    rtol: float = 1e-8,
    atol: float = 1e-8,
    max_it: int = 10,
    ksp_rtol: float = 1e-2,
    ksp_restart: int = 50,
    ksp_max_restarts: int = 8,
) -> RefineResult:
    """Iterative refinement on the generic block-CSR path."""
    residual_df = _df_bc_residual(
        kernel_df, ndofs, dfa, mask, DF(g_hi, g_lo))

    def jac_values(w):
        return matrix_values_of(kernel, nnzb, bs, arrays, w)

    def make_op(values):
        return _bc_op(arrays, n_rows, values, mask)

    def make_pc(values):
        return block_jacobi(values[arrays.diag_pos], mask)

    return refine_newton(
        residual_df, jac_values, make_op, make_pc, x0, n0,
        rtol=rtol, atol=atol, max_it=max_it, ksp_rtol=ksp_rtol,
        ksp_restart=ksp_restart, ksp_max_restarts=ksp_max_restarts)


def solve_newton_layered_stepped(
    kernel, n2d, n_planes, bs, arrays, mask, g, w0, E,
    rtol=1e-8, atol=1e-8, max_it=30, ksp_rtol=1e-8,
    ksp_restart=50, ksp_max_restarts=40, pc="plane_gs", mg=None,
    ksp="fgmres",
):
    """Host-stepped Newton: one max_it=1 device program per iteration.

    One small program per Newton step instead of the one-jit Newton
    (newton loop x FGMRES loop x V-cycle); costs one host sync per
    Newton step.  SNES tolerance semantics are
    preserved: tol = max(rtol*||F(w0)||, atol) fixed from the true
    initial residual."""
    import numpy as np

    # ||F(w0)|| from the SMALL assembly-only program: a max_it=0 Newton
    # probe would compile the full Newton+FGMRES+V-cycle executable even
    # though its loop never runs.
    r0 = float(residual_norm_layered(
        kernel, n2d, n_planes, bs, arrays, mask, g, w0, E))
    tol = max(rtol * r0, atol)
    w, rn, hist, stalled = w0, r0, [], False
    its = 0
    while its < max_it and rn > tol:
        # the convergence check lives in THIS host loop, so the device
        # program always takes rtol=atol=0.0: tol is a jit-STATIC of
        # solve_newton_layered, and threading the per-solve tol through
        # it compiled a fresh 1-step program for every Re rung of every
        # image (measured: the 42 s "coarse NS" phase of a warm
        # production Re was mostly these recompiles).  With 0.0 every
        # rung/Re/image shares one executable per (mesh shape, pc).
        out = solve_newton_layered(
            kernel, n2d, n_planes, bs, arrays, mask, g, w, E,
            0.0, 0.0, 1, ksp_rtol, ksp_restart, ksp_max_restarts, pc, mg,
            ksp)
        new_rn = float(out.resnorm)
        hist.append(np.asarray(out.history)[0])
        its += 1
        stalled = bool(out.stalled)
        if new_rn >= rn:          # f32 floor/stall: keep the BETTER
            stalled = True        # iterate (newton_solve itself now
            break                 # keeps the pre-step x on stall, so
                                  # this is belt + suspenders)
        w = out.x
        rn = new_rn
        if stalled:
            break
    hist_arr = jnp.asarray(np.stack(hist)) if hist else \
        jnp.full((1, 4), -1.0, mask.dtype)
    return NewtonResult(w, jnp.asarray(its), jnp.asarray(rn),
                        jnp.asarray(rn <= tol), hist_arr, stalled)


def refine_newton_layered_stepped(
    kernel, kernel_df, n2d, n_planes, bs, E, arrays, dfa, mask,
    g_hi, g_lo, x0, n0,
    rtol=1e-8, atol=1e-8, max_it=10, ksp_rtol=1e-2,
    ksp_restart=50, ksp_max_restarts=8, pc="plane_gs", mg=None,
):
    """Host-stepped double-float refinement (see
    solve_newton_layered_stepped for why)."""
    import numpy as np

    x_hi = x0
    x_lo = jnp.zeros_like(x0)
    tol = max(rtol * float(n0), atol)
    hist, rn, its = [], float("inf"), 0
    converged = False
    while its < max_it:
        out = refine_newton_layered(
            kernel, kernel_df, n2d, n_planes, bs, E, arrays, dfa,
            mask, g_hi, g_lo, x_hi, n0, rtol, atol, 1, ksp_rtol,
            ksp_restart, ksp_max_restarts, pc, mg, x_lo)
        x_hi, x_lo = out.x_hi, out.x_lo
        rn = float(out.resnorm)
        hist.append(np.asarray(out.history)[0])
        its += 1
        if rn <= tol:
            converged = True
            break
        if int(out.iters) == 0 or bool(out.resnorm != out.resnorm):
            break                 # internal loop refused to move / NaN
        # the internal body stops itself when a step fails to reduce
        # ||F||; detect that via the history row's fnew >= resnorm
        if np.asarray(out.history)[0, 0] >= 0 and \
                float(np.asarray(out.history)[0, 0]) > rn:
            break
    hist_arr = jnp.asarray(np.stack(hist)) if hist else \
        jnp.full((1, 3), -1.0, mask.dtype)
    return RefineResult(x_hi, x_lo, jnp.asarray(its), jnp.asarray(rn),
                        jnp.asarray(converged), hist_arr)
