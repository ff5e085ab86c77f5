"""Double-float (two-f32) stabilized Stokes element kernel.

Mirror of forms/stokes.py (reference
NavierStokes/NavierStokesChannelFlow.py:160-172) in compensated two-f32
arithmetic, for iterative refinement of the linear Stokes solves to
reference tolerances from f32 solves (the reference solves these at rtol
1e-8-1e-10 in f64 PETSc, e.g. StokesFlow/StokesChannelFlow.py:166).
Being affine, the same refine_newton driver (solve/refine.py) performs
classical linear iterative refinement with it.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np

from ..fem.elements import element, quadrature
from ..utils.dfloat import (DF, df_concatenate, df_einsum, df_mul, df_sqrt,
                            df_where)
from ..utils.kernelbase import ElementKernel
from .navier_stokes_df import _bcast, df_affine_geometry, split64


def df_cell_diameter(coords: DF) -> DF:
    """UFL CellDiameter (longest edge) in df."""
    a = DF(coords.hi[:, None, :], coords.lo[:, None, :])
    b = DF(coords.hi[None, :, :], coords.lo[None, :, :])
    d = a - b                       # compensated: hi differences can round
    d2 = df_einsum("abk,abk->ab", d, d)
    nv = d2.hi.shape[0]
    best = d2[0, 0]
    for a in range(nv):
        for b in range(a + 1, nv):
            cand = d2[a, b]
            best = df_where(cand.hi > best.hi, cand, best)
    return df_sqrt(best)


def make_stokes_kernel_df(
    cell: str,
    nu: float = 1.0,
    mu_T_coeff: float = 0.2,
    nu_scaled_stab: bool = False,
    qdeg: int = 2,
    forcing: Optional[np.ndarray] = None,
) -> Callable:
    """df residual kernel for the stabilized Stokes form on P1-P1.

    kernel(coords: DF (nv, gdim), w: DF (ndl,)) -> DF (ndl,)

    Returns an ElementKernel pytree (traced nu/mu_T/forcing splits —
    see make_ns_sups_kernel_df)."""
    elem = element(cell, 1)
    nu_c = split64(nu)
    mu_scale = split64(
        float(mu_T_coeff) / (4.0 * float(nu)) if nu_scaled_stab
        else float(mu_T_coeff))
    f_np = None if forcing is None or not np.any(forcing) \
        else np.asarray(forcing, np.float64)
    params = (nu_c, mu_scale) if f_np is None \
        else (nu_c, mu_scale, split64(f_np))
    return ElementKernel(
        _stokes_df_fn(cell, qdeg, f_np is not None), None, params,
        attrs=(("nv", elem.ndof), ("bs", elem.dim + 1)))


@functools.lru_cache(maxsize=None)
def _stokes_df_fn(cell: str, qdeg: int, has_forcing: bool):
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
        if has_forcing:
            nu_c, mu_scale, f_c = params
        else:
            (nu_c, mu_scale), f_c = params, None
        _, invJ, detJ = df_affine_geometry(coords, dim)
        h = df_cell_diameter(coords)
        mu_T = df_mul(mu_scale, df_mul(h, h))

        wb = w.reshape(nv, bs)
        u_n = wb[:, :dim]
        p_n = wb[:, dim]

        g = df_einsum("qak,ki->qai", dphi_c, invJ)
        grad_u = df_einsum("qaj,ai->qij", g, u_n)
        grad_p = df_einsum("qai,a->qi", g, p_n)
        div_u = df_einsum("qii->q", grad_u)
        p_q = df_einsum("qa,a->q", phi_c, p_n)

        r_u = df_mul(_bcast(nu_c, (nv, dim)),
                     df_einsum("q,qij,qaj->ai", wq_c, grad_u, g))
        r_u = r_u - df_einsum("q,q,qai->ai", wq_c, p_q, g)
        r_p = df_einsum("q,q,qa->a", wq_c, div_u, phi_c)
        r_p = r_p + df_mul(_bcast(mu_T, (nv,)),
                           df_einsum("q,qi,qai->a", wq_c, grad_p, g))
        if f_c is not None:
            r_u = r_u - df_einsum("q,i,qa->ai", wq_c, f_c, phi_c)
            r_p = r_p + df_mul(_bcast(mu_T, (nv,)),
                               df_einsum("q,i,qai->a", wq_c, f_c, g))

        r = df_concatenate(
            [r_u, DF(r_p.hi[:, None], r_p.lo[:, None])], 1).reshape(-1)
        return df_mul(r, _bcast(detJ, r.hi.shape))

    return kernel
