"""Double-float (two-f32) stabilized NS residual kernel.

Same integrand as forms/navier_stokes.py::make_ns_sups_kernel (reference
NavierStokes/NavierStokesChannelFlow.py:220-266) but every operation is
compensated two-f32 arithmetic (utils/dfloat.py), giving ~48-bit element
residuals from f32 words.  Used by the
iterative-refinement Newton (solve/refine.py) to reach the reference's
SNES rtol=atol=1e-8 (NavierStokesChannelFlow.py:281-283).

All tabulated constants (shape values, gradients, quadrature weights, nu)
enter as exact hi/lo splits of their f64 values, so the df residual is the
residual of the *f64 problem* — tests/test_dfloat.py pins it against the
f64 kernel to ~1e-12 relative.
"""

from __future__ import annotations

import functools
from typing import Callable

import jax.numpy as jnp
import numpy as np

from ..fem.elements import element, quadrature
from ..utils.dfloat import (DF, df, df_concatenate, df_det_small, df_div,
                            df_einsum, df_inv_small, df_mul, df_rsqrt)


def split64(x) -> DF:
    """Exact hi/lo split of f64 host data into two f32 words."""
    x = np.asarray(x, np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return DF(jnp.asarray(hi), jnp.asarray(lo))


def df_affine_geometry(coords: DF, dim: int):
    """df mirror of assemble.assembly.affine_geometry."""
    E = coords[1: dim + 1, :] - coords[0:1, :]
    J = DF(E.hi.T, E.lo.T)
    detJ = df_det_small(J)
    invJ = df_inv_small(J)
    absdet = DF(jnp.where(detJ.hi < 0, -detJ.hi, detJ.hi),
                jnp.where(detJ.hi < 0, -detJ.lo, detJ.lo))
    return J, invJ, absdet


def make_ns_sups_kernel_df(
    cell: str,
    nu: float,
    C_I: float = 36.0,
    transposed_stab: bool = True,
    qdeg: int = 2,
) -> Callable:
    """G-metric SUPS/LSIC residual kernel, two-f32 compensated.

    kernel(coords: DF (nv, gdim), w: DF (ndl,)) -> DF (ndl,)

    Returns an ElementKernel pytree whose leaves are the hi/lo splits of
    nu and C_I*nu^2 (the splits are exact host-f64 arithmetic, so they
    ride as traced data without losing the df precision model; one
    compiled refine program per mesh across the Re sweep)."""
    from ..utils.kernelbase import ElementKernel

    elem = element(cell, 1)
    nu_c = split64(nu)
    cinu2 = split64(C_I * float(np.float64(nu) ** 2))
    return ElementKernel(
        _sups_df_fn(cell, transposed_stab, qdeg), None, (nu_c, cinu2),
        attrs=(("nv", elem.ndof), ("bs", elem.dim + 1)))


@functools.lru_cache(maxsize=None)
def _sups_df_fn(cell: str, transposed_stab: bool, qdeg: int):
    elem = element(cell, 1)
    qr = quadrature(cell, qdeg)
    phi_np, dphi_np = elem.tabulate(qr.points)
    dim = elem.dim
    nv = elem.ndof
    bs = dim + 1

    phi_c = split64(phi_np)
    dphi_c = split64(dphi_np)
    wq_c = split64(qr.weights)

    def kernel(params, coords: DF, w: DF) -> DF:
        nu_c, cinu2 = params
        _, invJ, detJ = df_affine_geometry(coords, dim)
        G = df_einsum("ki,kj->ij", invJ, invJ)
        trG = df_einsum("ii->", G)
        GdG = df_einsum("ij,ij->", G, G)

        wb = w.reshape(nv, bs)
        u_n = wb[:, :dim]
        p_n = wb[:, dim]

        g = df_einsum("qak,ki->qai", dphi_c, invJ)
        u_q = df_einsum("qa,ai->qi", phi_c, u_n)
        grad_u = df_einsum("qaj,ai->qij", g, u_n)
        grad_p = df_einsum("qai,a->qi", g, p_n)
        div_u = df_einsum("qii->q", grad_u)
        p_q = df_einsum("qa,a->q", phi_c, p_n)

        uGu = df_einsum("qi,ij,qj->q", u_q, G, u_q)
        tau = df_rsqrt(uGu + _bcast(df_mul(cinu2, GdG), uGu.hi.shape))
        nu_lsic = df_div(df(1.0, tau.dtype),
                         df_mul(_bcast(trG, tau.hi.shape), tau))

        adv = df_einsum("qij,qj->qi", grad_u, u_q)
        if transposed_stab:
            res_m = df_einsum("qij,qi->qj", grad_u, u_q) + grad_p
        else:
            res_m = adv + grad_p

        r_u = df_einsum("q,qi,qa->ai", wq_c, adv, phi_c)
        r_u = r_u + df_mul(_bcast(nu_c, r_u.hi.shape),
                           df_einsum("q,qij,qaj->ai", wq_c, grad_u, g))
        r_u = r_u - df_einsum("q,q,qai->ai", wq_c, p_q, g)
        r_p = df_einsum("q,q,qa->a", wq_c, div_u, phi_c)

        res_dot_g = df_einsum("qj,qaj->qa", res_m, g)
        if transposed_stab:
            r_u = r_u + df_einsum("q,q,qi,qa->ai", wq_c, tau, u_q, res_dot_g)
        else:
            u_dot_g = df_einsum("qj,qaj->qa", u_q, g)
            r_u = r_u + df_einsum("q,q,qi,qa->ai", wq_c, tau, res_m, u_dot_g)
        r_p = r_p + df_einsum("q,q,qa->a", wq_c, tau, res_dot_g)

        r_u = r_u + df_einsum("q,q,q,qai->ai", wq_c, nu_lsic, div_u, g)

        r = df_concatenate(
            [r_u, DF(r_p.hi[:, None], r_p.lo[:, None])], 1).reshape(-1)
        return df_mul(r, _bcast(detJ, r.hi.shape))

    return kernel


def _bcast(x: DF, shape) -> DF:
    return DF(jnp.broadcast_to(x.hi, shape), jnp.broadcast_to(x.lo, shape))


def make_ns_ugn_kernel_df(
    cell: str,
    nu: float,
    qdeg: int = 2,
) -> Callable:
    """UGN/Tezduyar-tau stabilized NS residual kernel, two-f32 compensated
    (df mirror of forms/navier_stokes.py::make_ns_ugn_kernel; reference
    LidDrivenFlow/LidDrivenNavierStokesFlow.py:119-143).  Branch guards
    (|u| <= 1e-8, Re_UGN/3 < 1) select on hi words — the same branches the
    f32 kernel takes except within one ulp of the thresholds.

    Returns an ElementKernel pytree; the nu-derived hi/lo splits are
    traced leaves (see make_ns_sups_kernel_df)."""
    from ..utils.kernelbase import ElementKernel

    elem = element(cell, 1)
    nu_c = split64(nu)
    inv4nu = split64(1.0 / (4.0 * float(np.float64(nu))))
    inv2nu = split64(1.0 / (2.0 * float(np.float64(nu))))
    return ElementKernel(
        _ugn_df_fn(cell, qdeg), None, (nu_c, inv4nu, inv2nu),
        attrs=(("nv", elem.ndof), ("bs", elem.dim + 1)))


@functools.lru_cache(maxsize=None)
def _ugn_df_fn(cell: str, qdeg: int):
    from ..utils.dfloat import df_where
    from .stokes_df import df_cell_diameter

    elem = element(cell, 1)
    qr = quadrature(cell, qdeg)
    phi_np, dphi_np = elem.tabulate(qr.points)
    dim = elem.dim
    nv = elem.ndof
    bs = dim + 1

    phi_c = split64(phi_np)
    dphi_c = split64(dphi_np)
    wq_c = split64(qr.weights)
    third = split64(1.0 / 3.0)     # not f32-representable: needs both words
    tiny = float(jnp.finfo(jnp.float32).tiny)

    def kernel(params, coords: DF, w: DF) -> DF:
        nu_c, inv4nu, inv2nu = params
        from ..utils.dfloat import df_add, df_sqrt

        _, invJ, detJ = df_affine_geometry(coords, dim)
        h = df_cell_diameter(coords)
        h2 = df_mul(h, h)

        wb = w.reshape(nv, bs)
        u_n = wb[:, :dim]
        p_n = wb[:, dim]

        g = df_einsum("qak,ki->qai", dphi_c, invJ)
        u_q = df_einsum("qa,ai->qi", phi_c, u_n)
        grad_u = df_einsum("qaj,ai->qij", g, u_n)
        grad_p = df_einsum("qai,a->qi", g, p_n)
        div_u = df_einsum("qii->q", grad_u)
        p_q = df_einsum("qa,a->q", phi_c, p_n)

        u_sq = df_einsum("qi,qi->q", u_q, u_q)
        u_norm = df_sqrt(u_sq + df(tiny, u_sq.dtype))
        nq = u_sq.hi.shape[0]
        zero_q = df(jnp.zeros(nq, u_sq.dtype))
        guard = u_norm.hi <= 1e-8
        inv_t1 = df_where(
            guard, zero_q,
            df_div(df_mul(df(4.0, u_sq.dtype), u_sq), _bcast(h2, (nq,))))
        tau3 = df_mul(inv4nu, h2)
        inv_t3_sq = df_div(df(1.0, u_sq.dtype),
                           _bcast(df_mul(tau3, tau3), (nq,)))
        tau_s = df_rsqrt(inv_t1 + inv_t3_sq)
        re_ugn = df_mul(df_mul(u_norm, _bcast(h, (nq,))),
                        _bcast(inv2nu, (nq,)))
        re3 = df_mul(re_ugn, _bcast(third, (nq,)))
        one_q = df(jnp.ones(nq, u_sq.dtype))
        z = df_where(re3.hi < 1.0, re3, one_q)
        tau_l = df_mul(df_mul(df(0.5, u_sq.dtype), _bcast(h, (nq,))),
                       df_mul(u_norm, z))

        adv = df_einsum("qij,qj->qi", grad_u, u_q)
        res = adv + grad_p

        r_u = df_einsum("q,qi,qa->ai", wq_c, adv, phi_c)
        r_u = r_u + df_mul(_bcast(nu_c, (nv, dim)),
                           df_einsum("q,qij,qaj->ai", wq_c, grad_u, g))
        r_u = r_u - df_einsum("q,q,qai->ai", wq_c, p_q, g)
        r_p = df_einsum("q,q,qa->a", wq_c, div_u, phi_c)

        u_dot_g = df_einsum("qj,qaj->qa", u_q, g)
        r_u = r_u + df_einsum("q,q,qi,qa->ai", wq_c, tau_s, res, u_dot_g)
        res_dot_g = df_einsum("qi,qai->qa", res, g)
        r_p = r_p + df_einsum("q,q,qa->a", wq_c, tau_s, res_dot_g)
        r_u = r_u + df_einsum("q,q,q,qai->ai", wq_c, tau_l, div_u, g)

        r = df_concatenate(
            [r_u, DF(r_p.hi[:, None], r_p.lo[:, None])], 1).reshape(-1)
        return df_mul(r, _bcast(detJ, r.hi.shape))

    return kernel
