"""Structure-of-arrays (SoA) element kernels: cell-minor assembly.

The vmapped per-cell kernels (forms/navier_stokes.py) batch cells on
axis 0, so every intermediate is (nc, nq, nv, dim, ...)-shaped with tiny
trailing dims.  Here every quantity is laid out cell-MINOR — scalars are
(C,) arrays, small tensors are (k, C) stacks — so each elementwise op
runs over the long cell axis.  Whether this layout still pays on the
GPU against the vmapped AoS kernels is not measured yet (PERF.md).

Math: instead of porting the ~25 hand-derived tangent einsums to SoA
(error-prone twice over), both residual and Jacobian flow from ONE
per-quadrature-point flux function.  With the per-qp state

    s_q = (u_i, du_i/dx_j, p, dp/dx_j) in R^m,   m = 2*dim + dim^2 + 1

the stabilized weak form pairs the test structure against a pointwise
flux f : R^m -> R^m (same component layout), so

    r_e = |detJ| sum_q w_q  E_q^T f(s_q)
    J_e = |detJ| sum_q w_q  E_q^T (df/ds)_q E_q

where E_q : w_e -> s_q is the (sparse, structured) interpolation
operator.  df/ds is exact via m JVPs of f (jax.linearize) — ~60 flops
per column — and E_q^T / E_q never materialize: each state component
touches one basis value (phi) and dim basis gradients (g), so the
contractions are 4-term fused multiply-adds on (m, C) slices.

For P1 on simplices the basis gradients are constant across quadrature
points, so the gradient states (du/dx, dp/dx) are per-cell constants and
only (u, p) vary per qp — exploited below.

Replaces the reference's FFCx-generated per-cell tabulate tensors
(/root/reference/NavierStokes/NavierStokesChannelFlow.py:253-254 — UFL
``derivative`` + C kernel JIT) on the structured hot path; parity with
the vmapped kernels (and hence with jacfwd) is pinned in
tests/test_soa.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.elements import element, quadrature

# state component indices for dim = 3:
#   0..2   u_i
#   3..11  du_i/dx_j   (3 + 3*i + j)
#   12     p
#   13..15 dp/dx_j
_M = 16


def _geometry_soa(coordsT, dtype):
    """Affine tet geometry on (12, C) transposed coordinates.

    coordsT row a*3+i = coordinate i of vertex a.  Returns
    (invJ [k][i] nested lists of (C,), absdetJ (C,)) with
    invJ[k][i] = d xi_k / d x_i — the closed-form 3x3 inverse
    (matches utils/linalg.inv_small, pinned via kernel parity).
    """
    x = [[coordsT[a * 3 + i].astype(dtype) for i in range(3)]
         for a in range(4)]
    # J[i][k] = x_{k+1, i} - x_{0, i}
    J = [[x[k + 1][i] - x[0][i] for k in range(3)] for i in range(3)]
    c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1]
    c01 = J[1][0] * J[2][2] - J[1][2] * J[2][0]
    c02 = J[1][0] * J[2][1] - J[1][1] * J[2][0]
    det = J[0][0] * c00 - J[0][1] * c01 + J[0][2] * c02
    inv_det = 1.0 / det
    invJ = [
        [c00 * inv_det,
         -(J[0][1] * J[2][2] - J[0][2] * J[2][1]) * inv_det,
         (J[0][1] * J[1][2] - J[0][2] * J[1][1]) * inv_det],
        [-c01 * inv_det,
         (J[0][0] * J[2][2] - J[0][2] * J[2][0]) * inv_det,
         -(J[0][0] * J[1][2] - J[0][2] * J[1][0]) * inv_det],
        [c02 * inv_det,
         -(J[0][0] * J[2][1] - J[0][1] * J[2][0]) * inv_det,
         (J[0][0] * J[1][1] - J[0][1] * J[1][0]) * inv_det],
    ]
    return invJ, jnp.abs(det)


def _sups_flux(nu, C_I, G, trG, GdG, transposed_stab):
    """Pointwise SUPS/LSIC flux f : R^16 -> R^16 over (C,) lanes.

    Closure constants: the cell metric G_ij = (dxi/dx)^T(dxi/dx), its
    trace and G:G, and the physical parameters.  The flux layout matches
    the state layout, so r_e = E^T f and J_e = E^T (df/ds) E — see the
    term-by-term pairing in the module docstring of
    forms/navier_stokes.py (Galerkin + SUPS + LSIC, the UFL
    ``dot(u, grad)`` transposed-stab quirk included).
    """

    def f(*s):
        u = s[0:3]
        Gu = [[s[3 + 3 * i + j] for j in range(3)] for i in range(3)]
        p = s[12]
        gp = s[13:16]
        adv = [sum(Gu[i][j] * u[j] for j in range(3)) for i in range(3)]
        if transposed_stab:
            res = [sum(Gu[i][j] * u[i] for i in range(3)) + gp[j]
                   for j in range(3)]
        else:
            res = [adv[j] + gp[j] for j in range(3)]
        uGu = sum(u[i] * G[i][j] * u[j]
                  for i in range(3) for j in range(3))
        tau = jax.lax.rsqrt(uGu + C_I * nu * nu * GdG)
        div = Gu[0][0] + Gu[1][1] + Gu[2][2]
        nu_l = 1.0 / (trG * tau)
        f_u = adv
        if transposed_stab:
            f_G = [[nu * Gu[i][j] + tau * u[i] * res[j]
                    for j in range(3)] for i in range(3)]
        else:
            f_G = [[nu * Gu[i][j] + tau * res[i] * u[j]
                    for j in range(3)] for i in range(3)]
        lsic = nu_l * div - p
        for i in range(3):
            f_G[i][i] = f_G[i][i] + lsic
        f_p = div
        f_gp = [tau * res[j] for j in range(3)]
        return tuple(f_u) + tuple(f_G[i][j] for i in range(3)
                                  for j in range(3)) + (f_p,) + tuple(f_gp)

    return f


def _ugn_flux(nu, h, u_eps, dtype):
    """Pointwise UGN/Tezduyar flux (lid-driven variant,
    forms/navier_stokes.py::make_ns_ugn_kernel): tau_SUPG from
    (tau_1, tau_3), tau_LSIC = (h/2)|u| z(Re_UGN).  h = cell diameter
    (a per-cell (C,) constant)."""

    def f(*s):
        u = s[0:3]
        Gu = [[s[3 + 3 * i + j] for j in range(3)] for i in range(3)]
        p = s[12]
        gp = s[13:16]
        adv = [sum(Gu[i][j] * u[j] for j in range(3)) for i in range(3)]
        res = [adv[j] + gp[j] for j in range(3)]
        u_sq = u[0] * u[0] + u[1] * u[1] + u[2] * u[2]
        u_norm = jnp.sqrt(u_sq + jnp.finfo(dtype).tiny)
        inv_tau1_sq = jnp.where(u_norm <= u_eps, 0.0,
                                4.0 * u_sq / (h * h))
        tau3 = h * h / (4.0 * nu)
        tau_s = jax.lax.rsqrt(inv_tau1_sq + 1.0 / (tau3 * tau3))
        re_ugn = u_norm * h / (2.0 * nu)
        z = jnp.minimum(re_ugn / 3.0, 1.0)
        tau_l = 0.5 * h * u_norm * z
        div = Gu[0][0] + Gu[1][1] + Gu[2][2]
        f_u = adv
        f_G = [[nu * Gu[i][j] + tau_s * res[i] * u[j]
                for j in range(3)] for i in range(3)]
        lsic = tau_l * div - p
        for i in range(3):
            f_G[i][i] = f_G[i][i] + lsic
        f_p = div
        f_gp = [tau_s * res[j] for j in range(3)]
        return tuple(f_u) + tuple(f_G[i][j] for i in range(3)
                                  for j in range(3)) + (f_p,) + tuple(f_gp)

    return f


def _states(phi_np, g, wT, dtype, nq):
    """Per-cell constant gradient states + per-qp value states.

    wT row a*4 + c = component c at vertex a.  Returns
    (Gu [i][j] (C,), gp [j] (C,), u_q [q][i] (C,), p_q [q] (C,))."""
    wv = [[wT[a * 4 + i].astype(dtype) for i in range(4)]
          for a in range(4)]                      # [a][comp]
    Gu = [[sum(g[a][j] * wv[a][i] for a in range(4)) for j in range(3)]
          for i in range(3)]
    gp = [sum(g[a][j] * wv[a][3] for a in range(4)) for j in range(3)]
    # float() keeps the basis values weakly typed: a raw numpy f64
    # scalar would promote the whole f32 state to f64 under x64
    u_q = [[sum(float(phi_np[q, a]) * wv[a][i] for a in range(4))
            for i in range(3)] for q in range(nq)]
    p_q = [sum(float(phi_np[q, a]) * wv[a][3] for a in range(4))
           for q in range(nq)]
    return Gu, gp, u_q, p_q


def _basis_grads(dphi0, invJ):
    """g[a][j] = sum_k dphi[a, k] invJ[k][j] — (C,) arrays (P1:
    quadrature-point independent)."""
    return [[sum(float(dphi0[a, k]) * invJ[k][j] for k in range(3))
             for j in range(3)] for a in range(4)]


def _et_dot(phi_qa, g_a, F, idx_u, idx_G, idx_p, idx_gp, alpha):
    """E^T contraction row: phi_qa * F[idx(value_alpha)] +
    sum_j g_a[j] * F[idx(grad_alpha_j)] where F is indexable by state id
    (a tuple of (C,) arrays or an (..., 16, C) array sliced on axis -2).
    """
    if alpha < 3:
        out = phi_qa * F[idx_u + alpha]
        for j in range(3):
            out = out + g_a[j] * F[idx_G + 3 * alpha + j]
    else:
        out = phi_qa * F[idx_p]
        for j in range(3):
            out = out + g_a[j] * F[idx_gp + j]
    return out


def _flux_jacobian(flux, s, dtype, C):
    """(16, 16, C) df/ds via ONE vmapped application of the linearized
    flux over the 16-unit-tangent basis.

    16 separate jvp calls unroll the linear graph 16x (measured: 20k
    StableHLO lines, ~19 s CPU compile per instance) — batching the
    basis through vmap keeps the SAME flops in a 16x smaller program.
    """
    _, flin = jax.linearize(flux, *s)
    eye = np.eye(_M)
    # tangent dtype must match each primal aval exactly (the refined
    # double-float path runs f64 primals under an f32 config dtype)
    tangs = [jnp.broadcast_to(
        jnp.asarray(eye[k], jnp.result_type(s[k]))[:, None],
        (_M, C)) for k in range(_M)]
    outs = jax.vmap(flin)(*tangs)          # tuple of 16 (16_in, C)
    return jnp.stack(outs, axis=0)         # (16_out, 16_in, C)


def _jac_q_accum(J, flux, s, phi_q, g, w, dtype, C):
    """One quadrature point's w_q * E^T (df/ds) E added to J
    ((16, 16, C)); phi_q = basis values at this qp (python floats)."""
    F = _flux_jacobian(flux, s, dtype, C)
    # FE[(b, beta), s_out, C] = (F E)_col — 4-term fma per column
    FE = jnp.stack([
        _et_dot(float(phi_q[b]), g[b],
                [F[:, k] for k in range(_M)], 0, 3, 12, 13, beta)
        for b in range(4) for beta in range(4)
    ], axis=0)                             # (16, 16, C)
    rows = [w * _et_dot(float(phi_q[a]), g[a],
                        [FE[:, k] for k in range(_M)],
                        0, 3, 12, 13, alpha)
            for a in range(4) for alpha in range(4)]
    return J + jnp.stack(rows, axis=0)     # (16, 16, C)


@functools.lru_cache(maxsize=None)
def make_sups_soa(cell: str, transposed_stab: bool, qdeg: int):
    """(res_soa, jac_soa) for the G-metric SUPS/LSIC kernel.

    Signatures (C = cell batch, minor axis):
      res_soa(params, coordsT (12, C), wT (16, C)) -> (16, C)
      jac_soa(params, coordsT (12, C), wT (16, C)) -> (16, 16, C)
    with row/col index a*bs + component, matching the per-cell kernels.
    """
    if cell != "tetrahedron":
        raise ValueError("SoA kernels are 3D (tetrahedron) only")
    elem = element(cell, 1)
    qr = quadrature(cell, qdeg)
    phi_np, dphi_np = elem.tabulate(qr.points)
    assert np.allclose(dphi_np, dphi_np[0]), "P1 gradients must be const"
    dphi0 = dphi_np[0]
    nq = phi_np.shape[0]
    wq_np = qr.weights

    def _setup(params, coordsT, wT):
        dtype = wT.dtype
        nu, C_I = (jnp.asarray(p).astype(dtype) for p in params)
        invJ, detJ = _geometry_soa(coordsT, dtype)
        g = _basis_grads(dphi0, invJ)
        G = [[sum(invJ[k][i] * invJ[k][j] for k in range(3))
              for j in range(3)] for i in range(3)]
        trG = G[0][0] + G[1][1] + G[2][2]
        GdG = sum(G[i][j] * G[i][j] for i in range(3) for j in range(3))
        flux = _sups_flux(nu, C_I, G, trG, GdG, transposed_stab)
        states = _states(phi_np, g, wT, dtype, nq)
        return flux, g, detJ, states, dtype

    def res_soa(params, coordsT, wT):
        flux, g, detJ, (Gu, gp, u_q, p_q), dtype = _setup(
            params, coordsT, wT)
        C = wT.shape[-1]
        r = [jnp.zeros((C,), dtype) for _ in range(16)]
        gflat = tuple(Gu[i][j] for i in range(3) for j in range(3))
        for q in range(nq):
            s = tuple(u_q[q]) + gflat + (p_q[q],) + tuple(gp)
            f0 = flux(*s)
            w = float(wq_np[q])
            for a in range(4):
                for alpha in range(4):
                    r[a * 4 + alpha] = r[a * 4 + alpha] + w * _et_dot(
                        float(phi_np[q, a]), g[a], f0, 0, 3, 12, 13,
                        alpha)
        return jnp.stack(r, axis=0) * detJ[None, :]

    def jac_soa(params, coordsT, wT):
        flux, g, detJ, (Gu, gp, u_q, p_q), dtype = _setup(
            params, coordsT, wT)
        C = wT.shape[-1]
        J = jnp.zeros((16, 16, C), dtype)
        gflat = tuple(Gu[i][j] for i in range(3) for j in range(3))
        for q in range(nq):
            s = tuple(u_q[q]) + gflat + (p_q[q],) + tuple(gp)
            J = _jac_q_accum(J, flux, s, phi_np[q], g,
                             float(wq_np[q]), dtype, C)
        return J * detJ[None, None, :]

    return res_soa, jac_soa


@functools.lru_cache(maxsize=None)
def make_ugn_soa(cell: str, qdeg: int):
    """(res_soa, jac_soa) for the UGN/Tezduyar-tau kernel — same
    contract as make_sups_soa; h = cell diameter enters the flux as a
    per-cell constant."""
    if cell != "tetrahedron":
        raise ValueError("SoA kernels are 3D (tetrahedron) only")
    elem = element(cell, 1)
    qr = quadrature(cell, qdeg)
    phi_np, dphi_np = elem.tabulate(qr.points)
    assert np.allclose(dphi_np, dphi_np[0])
    dphi0 = dphi_np[0]
    nq = phi_np.shape[0]
    wq_np = qr.weights

    def _diameter(coordsT, dtype):
        x = [[coordsT[a * 3 + i].astype(dtype) for i in range(3)]
             for a in range(4)]
        h2 = None
        for a in range(4):
            for b in range(a + 1, 4):
                d = sum((x[a][i] - x[b][i]) ** 2 for i in range(3))
                h2 = d if h2 is None else jnp.maximum(h2, d)
        return jnp.sqrt(h2)

    def _setup(params, coordsT, wT):
        dtype = wT.dtype
        (nu,) = (jnp.asarray(p).astype(dtype) for p in params)
        invJ, detJ = _geometry_soa(coordsT, dtype)
        g = _basis_grads(dphi0, invJ)
        h = _diameter(coordsT, dtype)
        flux = _ugn_flux(nu, h, 1e-8, dtype)
        states = _states(phi_np, g, wT, dtype, nq)
        return flux, g, detJ, states, dtype

    def res_soa(params, coordsT, wT):
        flux, g, detJ, (Gu, gp, u_q, p_q), dtype = _setup(
            params, coordsT, wT)
        C = wT.shape[-1]
        r = [jnp.zeros((C,), dtype) for _ in range(16)]
        gflat = tuple(Gu[i][j] for i in range(3) for j in range(3))
        for q in range(nq):
            s = tuple(u_q[q]) + gflat + (p_q[q],) + tuple(gp)
            f0 = flux(*s)
            w = float(wq_np[q])
            for a in range(4):
                for alpha in range(4):
                    r[a * 4 + alpha] = r[a * 4 + alpha] + w * _et_dot(
                        float(phi_np[q, a]), g[a], f0, 0, 3, 12, 13,
                        alpha)
        return jnp.stack(r, axis=0) * detJ[None, :]

    def jac_soa(params, coordsT, wT):
        flux, g, detJ, (Gu, gp, u_q, p_q), dtype = _setup(
            params, coordsT, wT)
        C = wT.shape[-1]
        J = jnp.zeros((16, 16, C), dtype)
        gflat = tuple(Gu[i][j] for i in range(3) for j in range(3))
        for q in range(nq):
            s = tuple(u_q[q]) + gflat + (p_q[q],) + tuple(gp)
            J = _jac_q_accum(J, flux, s, phi_np[q], g,
                             float(wq_np[q]), dtype, C)
        return J * detJ[None, None, :]

    return res_soa, jac_soa
