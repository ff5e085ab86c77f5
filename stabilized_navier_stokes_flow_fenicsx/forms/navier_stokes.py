"""Stabilized Navier-Stokes element kernels.

Two stabilizations, matching the reference:

1. G-metric SUPS + LSIC (reference
   NavierStokes/NavierStokesChannelFlow.py:220-266):

     G = (dxi/dx)^T (dxi/dx),  C_I = 36
     tau_SUPS = 1 / sqrt(u.Gu + C_I nu^2 G:G)
     res_M    = dot(u, grad(u)) + grad(p)        [P1: div(2 nu sym grad u)=0]
     a  = (u.nabla_grad u).v + nu grad(u):grad(v) - p div(v) + q div(u)
        + tau_SUPS res_M . (dot(u, grad(v)) + grad(q))
        + nu_LSIC div(v) div(u),   nu_LSIC = 1/(tr(G) tau_SUPS)

   NOTE the UFL quirk preserved for parity: the reference's res_M and the
   SUPG test function use ``dot(u, grad(.))`` which in UFL contracts the
   *component* index — i.e. (grad u)^T u, not the advective (u.grad)u used
   in the Galerkin term (nabla_grad).  ``transposed_stab=False`` switches
   to the textbook SUPS residual.

2. UGN/Tezduyar tau (reference
   LidDrivenFlow/LidDrivenNavierStokesFlow.py:119-143):

     tau_SUPG = (tau_1^-2 + tau_3^-2)^(-1/2),  tau_1 = h/(2|u|) guarded at
     |u|<=1e-8, tau_3 = h^2/(4 nu);  Re_UGN = |u| h/(2 nu),
     z = min(Re_UGN/3, 1), tau_LSIC = (h/2) |u| z
     res = (u.nabla_grad)u + grad(p)             [P1 viscous term drops]
     a  = Galerkin + tau_SUPG (u.nabla_grad v).res + tau_SUPG grad(q).res
        + tau_LSIC div(v) div(u)

Jacobians: each kernel carries an *analytic tangent* as ``kernel.jac``
(replacing UFL ``derivative`` + FFCx JIT, NavierStokesChannelFlow.py:253-254).
The derivation is quadrature-point linearization: with the per-qp state

    s_q = (u_i, du_i/dx_j, p, dp/dx_j)          (m = 2 dim + dim^2 + 1)

the residual is r = detJ sum_q w_q E_q^T f(s_q) where E_q : w -> s_q is the
linear interpolation operator and f the per-point flux (Galerkin + SUPS +
LSIC integrand paired against the same value/gradient test structure).  So

    J_e = detJ sum_q w_q E_q^T (df/ds) E_q

— batched (m x m) matmuls on the MXU instead of an ndl-tangent jacfwd
through the whole kernel (measured ~3-4x cheaper at 10^5 cells).  df/ds is
taken with jacfwd of the tiny f (m inputs, ~50 flops), which is exact and
keeps both stabilization variants derivation-error-free; assemble/ falls
back to jacfwd of the full kernel when ``kernel.jac`` is absent, and
tests/test_kernels_fd.py pins analytic == jacfwd in f64.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax
import jax.numpy as jnp

from ..assemble.assembly import affine_geometry, cell_diameter
from ..fem.elements import element, quadrature
from ..utils.kernelbase import ElementKernel


def _assemble_blocks(J_uu, J_up, J_pu, J_pp, nv, dim, bs):
    """Pack per-block Jacobians into the interleaved (ndl, ndl) layout
    matching the node-blocked dof ordering w.reshape(nv, bs)."""
    row_u = jnp.concatenate([J_uu, J_up[:, :, :, None]], axis=-1)
    row_p = jnp.concatenate(
        [J_pu[:, None, :, :], J_pp[:, None, :, None]], axis=-1)
    J = jnp.concatenate([row_u, row_p], axis=1)   # (nv, bs, nv, bs)
    return J.reshape(nv * bs, nv * bs)


def make_ns_sups_kernel(
    cell: str,
    nu: float,
    C_I: float = 36.0,
    transposed_stab: bool = True,
    qdeg: int = 2,
) -> Callable:
    """G-metric SUPS/LSIC residual kernel on equal-order P1-P1.

    Returns an ElementKernel pytree: (nu, C_I) are traced leaves, so the
    jitted drivers compile ONE program per mesh and reuse it across the
    Re sweep / continuation ladder (utils/kernelbase.py).  On 3D cells
    the SoA variants (forms/soa.py) ride along for the structured
    assembly fast path."""
    soa = None
    if cell == "tetrahedron":
        from .soa import make_sups_soa

        soa = make_sups_soa(cell, transposed_stab, qdeg)
    return ElementKernel(*_sups_fns(cell, transposed_stab, qdeg),
                         (nu, C_I), soa=soa)


@functools.lru_cache(maxsize=None)
def _sups_fns(cell: str, transposed_stab: bool, qdeg: int):
    elem = element(cell, 1)
    qr = quadrature(cell, qdeg)
    phi_np, dphi_np = elem.tabulate(qr.points)
    dim = elem.dim
    nv = elem.ndof
    bs = dim + 1

    def kernel(params, coords, w):
        dtype = w.dtype
        nu, C_I = (jnp.asarray(p).astype(dtype) for p in params)
        phi = jnp.asarray(phi_np, dtype)
        dphi = jnp.asarray(dphi_np, dtype)
        wq = jnp.asarray(qr.weights, dtype)
        coords = coords.astype(dtype)

        _, invJ, detJ = affine_geometry(coords, dim)
        # G_ij = sum_k (dxi_k/dx_i)(dxi_k/dx_j); invJ[k, i] = dxi_k/dx_i
        G = jnp.einsum("ki,kj->ij", invJ, invJ)
        trG = jnp.trace(G)
        GdG = jnp.sum(G * G)

        wb = w.reshape(nv, bs)
        u_n = wb[:, :dim]
        p_n = wb[:, dim]

        g = jnp.einsum("qak,ki->qai", dphi, invJ)      # (nq, nv, dim)
        u_q = jnp.einsum("qa,ai->qi", phi, u_n)        # (nq, dim)
        grad_u = jnp.einsum("qaj,ai->qij", g, u_n)     # du_i/dx_j
        grad_p = jnp.einsum("qai,a->qi", g, p_n)
        div_u = jnp.einsum("qii->q", grad_u)
        p_q = jnp.einsum("qa,a->q", phi, p_n)

        uGu = jnp.einsum("qi,ij,qj->q", u_q, G, u_q)
        tau = 1.0 / jnp.sqrt(uGu + C_I * nu * nu * GdG)
        nu_lsic = 1.0 / (trG * tau)

        adv = jnp.einsum("qij,qj->qi", grad_u, u_q)    # (u.grad)u
        if transposed_stab:
            res_m = jnp.einsum("qij,qi->qj", grad_u, u_q) + grad_p
        else:
            res_m = adv + grad_p

        # Galerkin momentum
        r_u = jnp.einsum("q,qi,qa->ai", wq, adv, phi)
        r_u += nu * jnp.einsum("q,qij,qaj->ai", wq, grad_u, g)
        r_u -= jnp.einsum("q,q,qai->ai", wq, p_q, g)
        # Galerkin continuity
        r_p = jnp.einsum("q,q,qa->a", wq, div_u, phi)

        # SUPS: tau res_M . (dot(u, grad v) + grad q)
        res_dot_g = jnp.einsum("qj,qaj->qa", res_m, g)     # res_M . grad(phi_a)
        if transposed_stab:
            # test part dot(u, grad(v)) for v = phi_a e_i -> u_i (res.grad phi_a)
            r_u += jnp.einsum("q,q,qi,qa->ai", wq, tau, u_q, res_dot_g)
        else:
            # textbook: tau res_i (u . grad phi_a)
            u_dot_g = jnp.einsum("qj,qaj->qa", u_q, g)
            r_u += jnp.einsum("q,q,qi,qa->ai", wq, tau, res_m, u_dot_g)
        r_p += jnp.einsum("q,qa->a", wq * tau, res_dot_g)

        # LSIC: nu_lsic div(v) div(u)   (nu_lsic varies per qp through tau)
        r_u += jnp.einsum("q,q,qai->ai", wq * nu_lsic, div_u, g)

        r = jnp.concatenate([r_u, r_p[:, None]], axis=1).reshape(-1)
        return r * detJ

    def jac_kernel(params, coords, w):
        """Hand-derived element tangent dr/dw (== jacfwd(kernel) to
        roundoff, pinned by tests/test_kernels_fd.py).  Derivation: with
        per-qp state (u, Gu = du_i/dx_j, p, gp) and tau' = dtau/du =
        -tau^3 Gm u, nu_lsic' = tau Gm u / tr(Gm), differentiate each
        residual term; ~3x cheaper than the 16-tangent jacfwd because no
        per-tangent intermediates are materialized."""
        dtype = w.dtype
        nu, C_I = (jnp.asarray(p).astype(dtype) for p in params)
        phi = jnp.asarray(phi_np, dtype)
        dphi = jnp.asarray(dphi_np, dtype)
        wq = jnp.asarray(qr.weights, dtype)
        coords = coords.astype(dtype)

        _, invJ, detJ = affine_geometry(coords, dim)
        Gm = jnp.einsum("ki,kj->ij", invJ, invJ)
        trG = jnp.trace(Gm)
        GdG = jnp.sum(Gm * Gm)
        g = jnp.einsum("qak,ki->qai", dphi, invJ)
        eye = jnp.eye(dim, dtype=dtype)

        wb = w.reshape(nv, bs)
        u_n = wb[:, :dim]
        p_n = wb[:, dim]
        u = jnp.einsum("qa,ai->qi", phi, u_n)          # (nq, dim)
        Gu = jnp.einsum("qaj,ai->qij", g, u_n)         # du_i/dx_j
        gp = jnp.einsum("qai,a->qi", g, p_n)
        div = jnp.einsum("qii->q", Gu)

        Gmu = jnp.einsum("ij,qj->qi", Gm, u)
        uGu = jnp.einsum("qi,qi->q", u, Gmu)
        tau = 1.0 / jnp.sqrt(uGu + C_I * nu * nu * GdG)
        nu_l = 1.0 / (trG * tau)
        t = -(tau**3)[:, None] * Gmu                   # dtau/du_k
        n_ = (tau[:, None] * Gmu) / trG                # dnu_lsic/du_k

        if transposed_stab:
            res = jnp.einsum("qij,qi->qj", Gu, u) + gp
        else:
            res = jnp.einsum("qij,qj->qi", Gu, u) + gp

        gg = jnp.einsum("qak,qbk->qab", g, g)
        U = jnp.einsum("qk,qak->qa", u, g)             # u . grad(phi_a)
        R = jnp.einsum("qk,qak->qa", res, g)           # res . grad(phi_a)

        # delta_ij-carrying terms: Galerkin advection part 2 + viscous +
        # the tau res delta term of the SUPS derivative
        D_ab = jnp.einsum("q,qa,qb->ab", wq, phi, U)
        D_ab += nu * jnp.einsum("q,qab->ab", wq, gg)
        J_uu = jnp.einsum("q,qa,qb,qij->aibj", wq, phi, phi, Gu)
        # LSIC: d(nu_l div g_ai)/du_bj
        J_uu += jnp.einsum("q,q,qai,qb,qj->aibj", wq, div, g, phi, n_)
        J_uu += jnp.einsum("q,q,qai,qbj->aibj", wq, nu_l, g, g)
        if transposed_stab:
            W = jnp.einsum("qjk,qak->qaj", Gu, g)      # (Gu g_a)_j
            D_ab += jnp.einsum("q,q,qa,qb->ab", wq, tau, R, phi)
            J_uu += jnp.einsum("q,qi,qa,qb,qj->aibj", wq, u, R, phi, t)
            J_uu += jnp.einsum("q,q,qi,qj,qab->aibj", wq, tau, u, u, gg)
            J_uu += jnp.einsum("q,q,qi,qb,qaj->aibj", wq, tau, u, phi, W)
            J_up = jnp.einsum("q,q,qi,qab->aib", wq, tau, u, gg)
            J_pu = (jnp.einsum("q,qa,qb,qj->abj", wq, R, phi, t)
                    + jnp.einsum("q,q,qj,qab->abj", wq, tau, u, gg)
                    + jnp.einsum("q,q,qb,qaj->abj", wq, tau, phi, W))
        else:
            Wt = jnp.einsum("qkj,qak->qaj", Gu, g)     # (Gu^T g_a)_j
            Ub = jnp.einsum("qk,qbk->qb", u, g)        # u . grad(phi_b)
            J_uu += jnp.einsum("q,qi,qa,qb,qj->aibj", wq, res, U, phi, t)
            J_uu += jnp.einsum("q,q,qa,qb,ij->aibj", wq, tau, U, Ub, eye)
            J_uu += jnp.einsum("q,q,qij,qa,qb->aibj", wq, tau, Gu, U, phi)
            J_uu += jnp.einsum("q,q,qi,qaj,qb->aibj", wq, tau, res, g, phi)
            J_up = jnp.einsum("q,q,qbi,qa->aib", wq, tau, g, U)
            J_pu = (jnp.einsum("q,qa,qb,qj->abj", wq, R, phi, t)
                    + jnp.einsum("q,q,qb,qaj->abj", wq, tau, Ub, g)
                    + jnp.einsum("q,q,qb,qaj->abj", wq, tau, phi, Wt))
        J_uu += jnp.einsum("ab,ij->aibj", D_ab, eye)
        J_up -= jnp.einsum("q,qb,qai->aib", wq, phi, g)
        J_pu += jnp.einsum("q,qa,qbj->abj", wq, phi, g)
        J_pp = jnp.einsum("q,q,qab->ab", wq, tau, gg)
        return detJ * _assemble_blocks(J_uu, J_up, J_pu, J_pp, nv, dim, bs)

    return kernel, jac_kernel


def make_ns_ugn_kernel(
    cell: str,
    nu: float,
    qdeg: int = 2,
) -> Callable:
    """UGN/Tezduyar-tau stabilized NS kernel (lid-driven variant).

    Returns an ElementKernel pytree with nu as a traced leaf (see
    make_ns_sups_kernel)."""
    soa = None
    if cell == "tetrahedron":
        from .soa import make_ugn_soa

        soa = make_ugn_soa(cell, qdeg)
    return ElementKernel(*_ugn_fns(cell, qdeg), (nu,), soa=soa)


@functools.lru_cache(maxsize=None)
def _ugn_fns(cell: str, qdeg: int):
    elem = element(cell, 1)
    qr = quadrature(cell, qdeg)
    phi_np, dphi_np = elem.tabulate(qr.points)
    dim = elem.dim
    nv = elem.ndof
    bs = dim + 1

    def kernel(params, coords, w):
        dtype = w.dtype
        (nu,) = (jnp.asarray(p).astype(dtype) for p in params)
        phi = jnp.asarray(phi_np, dtype)
        dphi = jnp.asarray(dphi_np, dtype)
        wq = jnp.asarray(qr.weights, dtype)
        coords = coords.astype(dtype)

        _, invJ, detJ = affine_geometry(coords, dim)
        h = cell_diameter(coords)

        wb = w.reshape(nv, bs)
        u_n = wb[:, :dim]
        p_n = wb[:, dim]

        g = jnp.einsum("qak,ki->qai", dphi, invJ)
        u_q = jnp.einsum("qa,ai->qi", phi, u_n)
        grad_u = jnp.einsum("qaj,ai->qij", g, u_n)
        grad_p = jnp.einsum("qai,a->qi", g, p_n)
        div_u = jnp.einsum("qii->q", grad_u)
        p_q = jnp.einsum("qa,a->q", phi, p_n)

        u_sq = jnp.sum(u_q * u_q, axis=1)
        # |u| with a derivative-safe floor (kernel is differentiated by
        # jacfwd; bare sqrt has a NaN gradient at u = 0 which happens on
        # all-wall cells of coarse meshes).  finfo.tiny keeps the guard
        # representable in f32.
        u_norm = jnp.sqrt(u_sq + jnp.finfo(dtype).tiny)
        # tau_1 = h/(2|u|) with the reference's guard at |u| <= 1e-8
        inv_tau1_sq = jnp.where(u_norm <= 1e-8, 0.0, 4.0 * u_sq / (h * h))
        tau3 = h * h / (4.0 * nu)
        tau_supg = 1.0 / jnp.sqrt(inv_tau1_sq + 1.0 / tau3**2)
        re_ugn = u_norm * h / (2.0 * nu)
        z = jnp.minimum(re_ugn / 3.0, 1.0)
        tau_lsic = 0.5 * h * u_norm * z

        adv = jnp.einsum("qij,qj->qi", grad_u, u_q)
        res = adv + grad_p                       # P1: viscous term vanishes

        r_u = jnp.einsum("q,qi,qa->ai", wq, adv, phi)
        r_u += nu * jnp.einsum("q,qij,qaj->ai", wq, grad_u, g)
        r_u -= jnp.einsum("q,q,qai->ai", wq, p_q, g)
        r_p = jnp.einsum("q,q,qa->a", wq, div_u, phi)

        u_dot_g = jnp.einsum("qj,qaj->qa", u_q, g)       # u . grad(phi_a)
        r_u += jnp.einsum("q,qi,qa->ai", wq * tau_supg, res, u_dot_g)
        res_dot_g = jnp.einsum("qi,qai->qa", res, g)
        r_p += jnp.einsum("q,qa->a", wq * tau_supg, res_dot_g)
        r_u += jnp.einsum("q,q,qai->ai", wq * tau_lsic, div_u, g)

        r = jnp.concatenate([r_u, r_p[:, None]], axis=1).reshape(-1)
        return r * detJ

    def jac_kernel(params, coords, w):
        """Hand-derived UGN tangent (== jacfwd(kernel) to roundoff;
        tests/test_kernels_fd.py).  tau' chains through the |u| guard and
        the z = min(Re_UGN/3, 1) branch exactly as autodiff would."""
        dtype = w.dtype
        (nu,) = (jnp.asarray(p).astype(dtype) for p in params)
        phi = jnp.asarray(phi_np, dtype)
        dphi = jnp.asarray(dphi_np, dtype)
        wq = jnp.asarray(qr.weights, dtype)
        coords = coords.astype(dtype)

        _, invJ, detJ = affine_geometry(coords, dim)
        h = cell_diameter(coords)
        g = jnp.einsum("qak,ki->qai", dphi, invJ)
        eye = jnp.eye(dim, dtype=dtype)
        tau3 = h * h / (4.0 * nu)

        wb = w.reshape(nv, bs)
        u_n = wb[:, :dim]
        p_n = wb[:, dim]
        u = jnp.einsum("qa,ai->qi", phi, u_n)
        Gu = jnp.einsum("qaj,ai->qij", g, u_n)
        gp = jnp.einsum("qai,a->qi", g, p_n)
        div = jnp.einsum("qii->q", Gu)

        u_sq = jnp.sum(u * u, axis=1)
        u_norm = jnp.sqrt(u_sq + jnp.finfo(dtype).tiny)
        guard = u_norm <= 1e-8
        inv_tau1_sq = jnp.where(guard, 0.0, 4.0 * u_sq / (h * h))
        tau_s = 1.0 / jnp.sqrt(inv_tau1_sq + 1.0 / tau3**2)
        re_ugn = u_norm * h / (2.0 * nu)
        z = jnp.minimum(re_ugn / 3.0, 1.0)
        tau_l = 0.5 * h * u_norm * z
        # dtau_supg/du_k and dtau_lsic/du_k
        ts = jnp.where(guard, 0.0,
                       -4.0 * tau_s**3 / (h * h))[:, None] * u
        dz = jnp.where(re_ugn / 3.0 < 1.0, h / (6.0 * nu * u_norm), 0.0)
        tl = (0.5 * h * (z / u_norm + u_norm * dz))[:, None] * u

        res = jnp.einsum("qij,qj->qi", Gu, u) + gp
        gg = jnp.einsum("qak,qbk->qab", g, g)
        U = jnp.einsum("qk,qak->qa", u, g)
        R = jnp.einsum("qk,qak->qa", res, g)
        Wt = jnp.einsum("qkj,qak->qaj", Gu, g)

        D_ab = jnp.einsum("q,qa,qb->ab", wq, phi, U)
        D_ab += nu * jnp.einsum("q,qab->ab", wq, gg)
        J_uu = jnp.einsum("q,qa,qb,qij->aibj", wq, phi, phi, Gu)
        J_uu += jnp.einsum("q,q,qai,qb,qj->aibj", wq, div, g, phi, tl)
        J_uu += jnp.einsum("q,q,qai,qbj->aibj", wq, tau_l, g, g)
        J_uu += jnp.einsum("q,qi,qa,qb,qj->aibj", wq, res, U, phi, ts)
        J_uu += jnp.einsum("q,q,qa,qb,ij->aibj", wq, tau_s, U, U, eye)
        J_uu += jnp.einsum("q,q,qij,qa,qb->aibj", wq, tau_s, Gu, U, phi)
        J_uu += jnp.einsum("q,q,qi,qaj,qb->aibj", wq, tau_s, res, g, phi)
        J_uu += jnp.einsum("ab,ij->aibj", D_ab, eye)
        J_up = (jnp.einsum("q,q,qbi,qa->aib", wq, tau_s, g, U)
                - jnp.einsum("q,qb,qai->aib", wq, phi, g))
        J_pu = (jnp.einsum("q,qa,qbj->abj", wq, phi, g)
                + jnp.einsum("q,qa,qb,qj->abj", wq, R, phi, ts)
                + jnp.einsum("q,q,qb,qaj->abj", wq, tau_s, U, g)
                + jnp.einsum("q,q,qb,qaj->abj", wq, tau_s, phi, Wt))
        J_pp = jnp.einsum("q,q,qab->ab", wq, tau_s, gg)
        return detJ * _assemble_blocks(J_uu, J_up, J_pu, J_pp, nv, dim, bs)

    return kernel, jac_kernel
