"""Preconditioners for the block-CSR operators.

Stand-in for PETSc's ASM/LU stack (SURVEY.md 2.2).  The workhorse
is node-block Jacobi: with the equal-order P1-P1 layout every mesh node
carries a (dim+1)x(dim+1) diagonal block coupling its velocity components
and pressure — inverting all of them is one batched 4x4 solve, a perfect
VPU/MXU shape.  Constrained (Dirichlet) rows/cols are projected to identity
so the preconditioner matches the bc_operator.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from ..utils.linalg import inv_small


def identity_pc() -> Callable:
    return lambda x: x


def block_jacobi(diag_blocks: jnp.ndarray, mask: jnp.ndarray) -> Callable:
    """M^{-1} from node-diagonal blocks.

    diag_blocks: (n_rows, bs, bs); mask: (n_rows*bs,) 1 on free dofs.
    Returns a closure x -> D^{-1} x consistent with
    A_bc = P A P + (I - P): each block is projected (P_b D P_b + I - P_b)
    before inversion.
    """
    n, bs, _ = diag_blocks.shape
    mb = mask.reshape(n, bs)
    P = mb[:, :, None] * mb[:, None, :]                    # (n, bs, bs)
    eye = jnp.eye(bs, dtype=diag_blocks.dtype)
    # P_b D_b P_b + diag(1 - m_b)
    Dproj = diag_blocks * P + jnp.einsum("nb,bc->nbc", 1.0 - mb, eye)
    Dinv = inv_small(Dproj)

    def apply(x):
        xb = x.reshape(n, bs)
        yb = jnp.einsum("nij,nj->ni", Dinv, xb,
                        preferred_element_type=x.dtype)
        return yb.reshape(-1)

    return apply


def _vertical_line_blocks(values, diag_pos, mask, n2d, n_planes):
    """(A, B, C) block-tridiagonal coefficients of every 2D node's
    extrusion column (the self-pair's delta = -1/0/+1 blocks), each
    (Lp, n2d, bs, bs), with constrained rows/cols projected to identity
    so the line solve matches the bc_operator."""
    bs = values.shape[0]
    Lp = n_planes
    mb = mask.reshape(Lp, n2d, bs)
    eye = jnp.eye(bs, dtype=values.dtype)
    sp = values[:, :, :, diag_pos, :]        # (bs, bs, 3, n2d, Lp)
    A = sp[:, :, 1].transpose(3, 2, 0, 1)    # (Lp, n2d, bs, bs)
    B = sp[:, :, 0].transpose(3, 2, 0, 1)    # x[l-1] coupling
    C = sp[:, :, 2].transpose(3, 2, 0, 1)    # x[l+1] coupling
    Pl = mb[:, :, :, None] * mb[:, :, None, :]
    A = A * Pl + jnp.einsum("lnb,bc->lnbc", 1.0 - mb, eye)
    # off-diagonals: rows of constrained dofs and columns of constrained
    # neighbor dofs are zeroed
    mb_m = jnp.concatenate([jnp.zeros_like(mb[:1]), mb[:-1]], axis=0)
    mb_p = jnp.concatenate([mb[1:], jnp.zeros_like(mb[:1])], axis=0)
    B = B * (mb[:, :, :, None] * mb_m[:, :, None, :])
    C = C * (mb[:, :, :, None] * mb_p[:, :, None, :])
    return A, B, C


def line_jacobi_layered(
    values: jnp.ndarray,          # (bs, bs, 3, E, Lp) layered matrix
    diag_pos: jnp.ndarray,        # (n2d,) self-pair ids
    mask: jnp.ndarray,            # (Lp*n2d*bs,)
    n2d: int,
    n_planes: int,
) -> Callable:
    """Vertical-line relaxation for extruded meshes.

    For each 2D node i, solve the block-tridiagonal system along its
    extrusion column (the self-pair's delta = -1/0/+1 blocks) — the
    strongest coupling direction of channel meshes.  All n2d columns
    factor and solve simultaneously: a blocked Thomas algorithm as a
    ``lax.scan`` over planes with (n2d, bs, bs) batched arithmetic.
    Strictly stronger than node-block Jacobi (which is its delta=0-only
    limit) at the cost of one scan per application.  (line_cr_layered is
    the same solve at log-depth — preferred inside big jit programs.)
    """
    from ..utils.linalg import inv_small

    bs = values.shape[0]
    Lp = n_planes
    A, B, C = _vertical_line_blocks(values, diag_pos, mask, n2d, n_planes)
    eye = jnp.eye(bs, dtype=values.dtype)

    # blocked Thomas factorization: forward eliminate
    def fwd(carry, inp):
        Dprev_inv, Cprev = carry
        Al, Bl, Cl = inp
        D = Al - jnp.einsum("nij,njk,nkl->nil", Bl, Dprev_inv, Cprev,
                            preferred_element_type=Al.dtype)
        Dinv = inv_small(D)
        return (Dinv, Cl), (Dinv, Bl)

    zeros = jnp.zeros((n2d, bs, bs), values.dtype)
    eye_n = jnp.broadcast_to(eye, (n2d, bs, bs))
    (_, _), (Dinv, Bs) = jax.lax.scan(
        fwd, (eye_n, zeros), (A, B, C))

    C_all = C

    def apply(x):
        r = x.reshape(Lp, n2d, bs)

        def down(carry, inp):
            y_prev = carry
            rl, Dinv_l, Bl = inp
            y = jnp.einsum("nij,nj->ni", Dinv_l,
                           rl - jnp.einsum("nij,nj->ni", Bl, y_prev,
                                           preferred_element_type=x.dtype),
                           preferred_element_type=x.dtype)
            return y, y

        y0 = jnp.zeros((n2d, bs), x.dtype)
        _, Y = jax.lax.scan(down, y0, (r, Dinv, Bs))

        def up(carry, inp):
            x_next = carry
            yl, Dinv_l, Cl = inp
            xl = yl - jnp.einsum("nij,njk,nk->ni", Dinv_l, Cl, x_next,
                                 preferred_element_type=x.dtype)
            return xl, xl

        _, X = jax.lax.scan(up, y0, (Y, Dinv, C_all), reverse=True)
        return X.reshape(-1)

    return apply


def line_cr_layered(
    values: jnp.ndarray,          # (bs, bs, 3, E, Lp) layered matrix
    diag_pos: jnp.ndarray,        # (n2d,) self-pair ids
    mask: jnp.ndarray,            # (Lp*n2d*bs,)
    n2d: int,
    n_planes: int,
    pc_dtype=None,
) -> Callable:
    """Vertical-line solve by block CYCLIC REDUCTION — log-depth.

    Same system as line_jacobi_layered (every 2D node's extrusion column,
    block-tridiagonal over planes), but eliminated by halving: each level
    removes the odd planes with batched (m/2*n2d, bs, bs) matmuls, so the
    whole solve is ~2*log2(Lp) dependency steps instead of the 2*Lp-step
    Thomas scan.  Two things follow: (1) applies are batched matmul
    work, not scan latency; (2) the XLA program is ~log Lp einsums — tiny
    — small enough to sit INSIDE one-jit Newton/FGMRES programs at 1M
    dofs.

    Factorization (this function body) runs once per Jacobian; the
    returned closure only does the rhs reduction + back-substitution.
    pc_dtype: cast the stored factors (factorization stays f32) — the
    PC only steers right-preconditioned FGMRES, so bf16 halves the HBM
    traffic of every apply.
    """
    from ..utils.linalg import inv_small

    bs = values.shape[0]
    Lp = n_planes
    A, B, C = _vertical_line_blocks(values, diag_pos, mask, n2d, n_planes)
    # pad planes to a power of two with identity rows (decoupled: B=C=0)
    m = 1 << max(1, (Lp - 1).bit_length())
    if m > Lp:
        eye_pad = jnp.broadcast_to(jnp.eye(bs, dtype=values.dtype),
                                   (m - Lp, n2d, bs, bs))
        zero_pad = jnp.zeros((m - Lp, n2d, bs, bs), values.dtype)
        A = jnp.concatenate([A, eye_pad], axis=0)
        B = jnp.concatenate([B, zero_pad], axis=0)
        C = jnp.concatenate([C, zero_pad], axis=0)

    def mm(X, Y):
        return jnp.einsum("lnij,lnjk->lnik", X, Y,
                          preferred_element_type=X.dtype)

    # per-level factors: (Ainv_odd, B_odd, C_odd, G, H) with
    #   G_j = B_{2j} Ainv_{2j-1},  H_j = C_{2j} Ainv_{2j+1}
    levels = []
    while m > 1:
        Ao, Bo, Co = A[1::2], B[1::2], C[1::2]      # odd planes (m/2)
        Ainv_o = inv_small(Ao)
        Ae, Be, Ce = A[0::2], B[0::2], C[0::2]      # even planes (m/2)
        # shift: even plane 2j couples down to odd 2j-1 (level index j-1)
        zero1 = jnp.zeros((1, n2d, bs, bs), values.dtype)
        Ainv_dn = jnp.concatenate([zero1, Ainv_o[:-1]], axis=0)
        C_dn = jnp.concatenate([zero1, Co[:-1]], axis=0)
        B_dn = jnp.concatenate([zero1, Bo[:-1]], axis=0)
        G = mm(Be, Ainv_dn)                          # zero at j=0 (B_0=0)
        H = mm(Ce, Ainv_o)
        A = Ae - mm(G, C_dn) - mm(H, Bo)
        B = -mm(G, B_dn)
        C = -mm(H, Co)
        levels.append((Ainv_o, Bo, Co, G, H))
        m //= 2
    Ainv_root = inv_small(A[0])                      # (n2d, bs, bs)

    if pc_dtype is not None:
        levels = [tuple(t.astype(pc_dtype) for t in lv) for lv in levels]
        Ainv_root = Ainv_root.astype(pc_dtype)

    Lp_pad = 1 << max(1, (Lp - 1).bit_length())

    def mv(X, y):
        return jnp.einsum("lnij,lnj->lni", X, y,
                          preferred_element_type=y.dtype)

    def apply(r):
        out_dtype = r.dtype
        if pc_dtype is not None:
            r = r.astype(pc_dtype)
        rl = r.reshape(Lp, n2d, bs)
        if Lp_pad > Lp:
            rl = jnp.concatenate(
                [rl, jnp.zeros((Lp_pad - Lp, n2d, bs), rl.dtype)], axis=0)
        # forward: reduce rhs level by level
        rhss = []
        for (Ainv_o, Bo, Co, G, H) in levels:
            ro, re = rl[1::2], rl[0::2]
            rhss.append(rl)
            zero1 = jnp.zeros((1, n2d, bs), rl.dtype)
            ro_dn = jnp.concatenate([zero1, ro[:-1]], axis=0)
            rl = re - mv(G, ro_dn) - mv(H, ro)
        x = jnp.einsum("nij,nj->ni", Ainv_root, rl[0],
                       preferred_element_type=rl.dtype)[None]
        # backward: recover odd planes
        for (Ainv_o, Bo, Co, G, H), rk in zip(reversed(levels),
                                              reversed(rhss)):
            ro = rk[1::2]
            x_up = jnp.concatenate(
                [x[1:], jnp.zeros((1, n2d, bs), x.dtype)], axis=0)
            xo = mv(Ainv_o, ro - mv(Bo, x) - mv(Co, x_up))
            mk = rk.shape[0]
            x = jnp.stack([x, xo], axis=1).reshape(mk, n2d, bs)
        return x[:Lp].reshape(-1).astype(out_dtype)

    return apply


def plane_gs_layered(
    values: jnp.ndarray,          # (bs, bs, 3, E, Lp)
    cols: jnp.ndarray,            # (E,)
    row_ids: jnp.ndarray,         # (E,) sorted
    diag_pos: jnp.ndarray,        # (n2d,)
    mask: jnp.ndarray,
    n2d: int,
    n_planes: int,
    inner_sweeps: int = 2,
    symmetric: bool = True,
    pc_dtype=None,
) -> Callable:
    """Plane-block Gauss-Seidel for the layered operator.

    Sweeps plane-by-plane downstream (and upstream when symmetric): each
    plane's 2D block system is relaxed with ``inner_sweeps`` Jacobi
    iterations using the plane-local 2D pairs.  Downstream sweeping
    follows the channel's advection, which makes the lower-triangular
    part of the NS Jacobian dominant — the classic line/plane relaxation
    for convection-dominated flow, in scan form.  Cuts FGMRES iterations
    ~4x vs node-block Jacobi on the channel Stokes system.
    """
    from ..utils.linalg import inv_small

    bs, _, _, E, Lp = values.shape
    mb = mask.reshape(Lp, n2d, bs)
    eye = jnp.eye(bs, dtype=values.dtype)
    # per-plane projected diagonal blocks + inverses
    diag = values[:, :, 1, diag_pos, :].transpose(3, 2, 0, 1)
    P = mb[:, :, :, None] * mb[:, :, None, :]
    diag = diag * P + jnp.einsum("lnb,bc->lnbc", 1.0 - mb, eye)
    Dinv = inv_small(diag)                   # (Lp, n2d, bs, bs)

    V0 = values[:, :, 1]                     # (bs, bs, E, Lp)
    Vm = values[:, :, 0]                     # x[l-1] coupling
    Vp = values[:, :, 2]                     # x[l+1] coupling
    if pc_dtype is not None:
        # the PC only steers FGMRES (right-preconditioned, flexible), so
        # reduced precision here is free bandwidth: bf16 halves the value
        # traffic of every sweep
        V0, Vm, Vp = (v.astype(pc_dtype) for v in (V0, Vm, Vp))
        Dinv = Dinv.astype(pc_dtype)
        mb = mb.astype(pc_dtype)
    rows_sorted = row_ids

    def spmv2d(Vl, x2d):
        # Vl: (bs, bs, E); x2d: (n2d, bs) — elementwise form (no
        # dot_general layout thrash, see layered_matvec)
        xj = x2d[cols].T                     # (bs, E)
        contrib = (Vl * xj[None, :, :]).sum(axis=1)      # (bs, E)
        return jax.ops.segment_sum(contrib.T, rows_sorted, num_segments=n2d,
                                   indices_are_sorted=True)

    def relax_plane(Vl, Dinv_l, ml, rhs, x0):
        x = x0
        for _ in range(inner_sweeps):
            res = (rhs - spmv2d(Vl, x * ml)) * ml + (1.0 - ml) * (rhs - x)
            x = x + jnp.einsum("nij,nj->ni", Dinv_l, res,
                               preferred_element_type=x.dtype)
        return x

    def apply(r):
        out_dtype = r.dtype
        if pc_dtype is not None:
            r = r.astype(pc_dtype)
        rb = r.reshape(Lp, n2d, bs)

        def down(x_prev, l):
            rl, ml, Dinv_l = rb[l], mb[l], Dinv[l]
            rhs = rl - spmv2d(Vm[..., l], x_prev)
            rhs = ml * rhs + (1.0 - ml) * rl
            x = relax_plane(V0[..., l], Dinv_l, ml, rhs,
                            jnp.einsum("nij,nj->ni", Dinv_l, rhs))
            return x, x

        x0 = jnp.zeros((n2d, bs), r.dtype)
        _, X = jax.lax.scan(down, x0, jnp.arange(Lp))
        if not symmetric:
            return X.reshape(-1).astype(out_dtype)

        def up(x_next, l):
            rl, ml, Dinv_l = rb[l], mb[l], Dinv[l]
            rhs = rl - spmv2d(Vp[..., l], x_next)
            rhs = ml * rhs + (1.0 - ml) * rl
            x = relax_plane(V0[..., l], Dinv_l, ml, rhs, X[l])
            return x, x

        _, X2 = jax.lax.scan(up, x0, jnp.arange(Lp), reverse=True)
        return X2.reshape(-1).astype(out_dtype)

    return apply


def plane_zebra_layered(
    values: jnp.ndarray,          # (bs, bs, 3, E, Lp)
    cols: jnp.ndarray,
    row_ids: jnp.ndarray,
    diag_pos: jnp.ndarray,
    mask: jnp.ndarray,
    n2d: int,
    n_planes: int,
    inner_sweeps: int = 2,
    zebra_sweeps: int = 2,
    pc_dtype=None,
) -> Callable:
    """Zebra (red-black plane) relaxation — plane-GS strength class with
    NO sequential scan.

    The layered operator is block-tridiagonal over planes, so planes of
    one parity only couple to the other parity: relax ALL even planes
    jointly (batched over Lp/2 planes — pure VPU/MXU work), then all odd
    planes with the fresh even values, and repeat.  Each half-sweep is
    the same plane relaxation plane-GS performs (``inner_sweeps`` damped
    Jacobi passes on the plane-local 2D system preceded by a direct
    block-diagonal hit), but the dependency depth per sweep is 2 instead
    of Lp — the XLA program is ~Lp/2 times smaller and latency-free,
    which is what plane-GS lacks at 1M dofs.  Classic smoothing
    theory: downstream GS > zebra > damped Jacobi on advective problems;
    zebra is the strongest ordering that stays parallel.
    """
    from ..utils.linalg import inv_small

    bs, _, _, E, Lp = values.shape
    Lp_pad = Lp + (Lp % 2)
    mb = mask.reshape(Lp, n2d, bs)
    if Lp_pad > Lp:
        mb = jnp.concatenate(
            [mb, jnp.zeros((1, n2d, bs), mb.dtype)], axis=0)
    eye = jnp.eye(bs, dtype=values.dtype)
    diag = values[:, :, 1, diag_pos, :].transpose(3, 2, 0, 1)
    if Lp_pad > Lp:
        diag = jnp.concatenate(
            [diag, jnp.broadcast_to(eye, (1, n2d, bs, bs))], axis=0)
    P = mb[:, :, :, None] * mb[:, :, None, :]
    diag = diag * P + jnp.einsum("lnb,bc->lnbc", 1.0 - mb, eye)
    Dinv = inv_small(diag)                   # (Lp_pad, n2d, bs, bs)

    def padV(v):                             # (bs, bs, E, Lp) -> Lp_pad
        if Lp_pad == Lp:
            return v
        return jnp.concatenate(
            [v, jnp.zeros(v.shape[:-1] + (1,), v.dtype)], axis=-1)

    V0 = padV(values[:, :, 1])
    Vm = padV(values[:, :, 0])               # couples to x[l-1]
    Vp = padV(values[:, :, 2])               # couples to x[l+1]
    if pc_dtype is not None:
        V0, Vm, Vp = (v.astype(pc_dtype) for v in (V0, Vm, Vp))
        Dinv = Dinv.astype(pc_dtype)
        mb = mb.astype(pc_dtype)
    H = Lp_pad // 2
    ev = jnp.arange(0, Lp_pad, 2)
    od = jnp.arange(1, Lp_pad, 2)

    def spmv_planes(Vsub, xsub):
        """Vsub: (bs, bs, E, L2); xsub: (L2, n2d, bs) -> (L2, n2d, bs)."""
        xjT = xsub[:, cols, :].transpose(2, 1, 0)        # (bs, E, L2)
        contrib = (Vsub * xjT[None]).sum(axis=1)         # (bs, E, L2)
        out = jax.ops.segment_sum(
            contrib.transpose(1, 0, 2), row_ids, num_segments=n2d,
            indices_are_sorted=True)                     # (n2d, bs, L2)
        return out.transpose(2, 0, 1)

    V0e, V0o = V0[..., ev], V0[..., od]
    Vme, Vmo = Vm[..., ev], Vm[..., od]
    Vpe, Vpo = Vp[..., ev], Vp[..., od]
    De, Do = Dinv[ev], Dinv[od]
    me, mo = mb[ev], mb[od]

    def relax_color(Vc, Dc, mc, rhs, x0):
        x = x0
        for _ in range(inner_sweeps):
            res = (rhs - spmv_planes(Vc, x * mc)) * mc \
                + (1.0 - mc) * (rhs - x)
            x = x + jnp.einsum("lnij,lnj->lni", Dc, res,
                               preferred_element_type=x.dtype)
        return x

    def apply(r):
        out_dtype = r.dtype
        if pc_dtype is not None:
            r = r.astype(pc_dtype)
        rb = r.reshape(Lp, n2d, bs)
        if Lp_pad > Lp:
            rb = jnp.concatenate(
                [rb, jnp.zeros((1, n2d, bs), rb.dtype)], axis=0)
        re, ro = rb[ev], rb[od]
        zero_pl = jnp.zeros((1, n2d, bs), r.dtype)
        xe = jnp.zeros((H, n2d, bs), r.dtype)
        xo = jnp.zeros((H, n2d, bs), r.dtype)
        for sweep in range(zebra_sweeps):
            # even planes 2j: lower neighbor = odd[j-1], upper = odd[j]
            xo_dn = jnp.concatenate([zero_pl, xo[:-1]], axis=0)
            rhs = re - spmv_planes(Vme, xo_dn) - spmv_planes(Vpe, xo)
            rhs = me * rhs + (1.0 - me) * re
            x0e = jnp.einsum("lnij,lnj->lni", De, rhs,
                             preferred_element_type=r.dtype) \
                if sweep == 0 else xe
            xe = relax_color(V0e, De, me, rhs, x0e)
            # odd planes 2j+1: lower = even[j], upper = even[j+1]
            xe_up = jnp.concatenate([xe[1:], zero_pl], axis=0)
            rhs = ro - spmv_planes(Vmo, xe) - spmv_planes(Vpo, xe_up)
            rhs = mo * rhs + (1.0 - mo) * ro
            x0o = jnp.einsum("lnij,lnj->lni", Do, rhs,
                             preferred_element_type=r.dtype) \
                if sweep == 0 else xo
            xo = relax_color(V0o, Do, mo, rhs, x0o)
        x = jnp.stack([xe, xo], axis=1).reshape(Lp_pad, n2d, bs)
        return x[:Lp].reshape(-1).astype(out_dtype)

    return apply


def plane_gs_grouped(
    values: jnp.ndarray,          # (bs, bs, 3, E, Lp)
    cols: jnp.ndarray,
    row_ids: jnp.ndarray,
    diag_pos: jnp.ndarray,
    mask: jnp.ndarray,
    n2d: int,
    n_planes: int,
    group: int = 8,
    inner_sweeps: int = 2,
    symmetric: bool = True,
    pc_dtype=None,
) -> Callable:
    """Plane-GS with G planes relaxed jointly per scan step.

    The per-plane scan of plane_gs_layered costs Lp sequential steps of
    tiny work — latency-bound.  Here the sweep moves in groups of
    ``group`` planes: the scan has Lp/group steps, and each step relaxes
    all G planes of the group simultaneously (Jacobi within the group,
    Gauss-Seidel between groups, downstream then upstream).  Convergence
    sits between plane-GS and plane-Jacobi; wall-clock per application
    drops by ~group.
    """
    from ..utils.linalg import inv_small

    bs, _, _, E, Lp = values.shape
    G = group
    Lp_pad = -(-Lp // G) * G
    padp = Lp_pad - Lp

    def padL(a):
        # pad the trailing plane axis with zeros
        if padp == 0:
            return a
        pw = [(0, 0)] * (a.ndim - 1) + [(0, padp)]
        return jnp.pad(a, pw)

    mb = padL(mask.reshape(Lp, n2d, bs).transpose(1, 2, 0))   # (n2d,bs,Lp_pad)
    mb = mb.transpose(2, 0, 1)                                # (Lp_pad,n2d,bs)
    eye = jnp.eye(bs, dtype=values.dtype)
    diag = padL(values[:, :, 1, diag_pos, :]).transpose(3, 2, 0, 1)
    P = mb[:, :, :, None] * mb[:, :, None, :]
    diag = diag * P + jnp.einsum("lnb,bc->lnbc", 1.0 - mb, eye)
    Dinv = inv_small(diag)                        # (Lp_pad, n2d, bs, bs)

    # (ngroups, bs, bs, G, E): G on the sublane axis, E on the lane axis
    def grouped(vpart):
        v = padL(vpart)                           # (bs, bs, E, Lp_pad)
        v = v.reshape(bs, bs, E, Lp_pad // G, G)
        return v.transpose(3, 0, 1, 4, 2)         # (ng, bs, bs, G, E)

    V0 = grouped(values[:, :, 1])
    Vm = grouped(values[:, :, 0])
    Vp = grouped(values[:, :, 2])
    if pc_dtype is not None:
        V0, Vm, Vp = (v.astype(pc_dtype) for v in (V0, Vm, Vp))
        Dinv = Dinv.astype(pc_dtype)
        mb = mb.astype(pc_dtype)
    ng = Lp_pad // G
    Dinv_g = Dinv.reshape(ng, G, n2d, bs, bs)
    mb_g = mb.reshape(ng, G, n2d, bs)

    def spmv_group(Vg, y):
        """Vg: (bs, bs, G, E); y: (G, n2d, bs) -> (G, n2d, bs)."""
        xj = y[:, cols, :].transpose(2, 0, 1)     # (bs, G, E)
        contrib = (Vg * xj[None]).sum(axis=1)     # (bs, G, E)
        out = jax.ops.segment_sum(
            contrib.transpose(2, 1, 0), row_ids, num_segments=n2d,
            indices_are_sorted=True)              # (n2d, G, bs)
        return out.transpose(1, 0, 2)

    def relax_group(V0g, Vmg, Vpg, Dg, mg, rhs, below, above, y):
        """inner Jacobi sweeps on the G-plane block system."""
        for _ in range(inner_sweeps + 1):
            y_dn = jnp.concatenate([below[None], y[:-1]], axis=0)
            y_up = jnp.concatenate([y[1:], above[None]], axis=0)
            Ay = (spmv_group(V0g, y * mg) + spmv_group(Vmg, y_dn)
                  + spmv_group(Vpg, y_up))
            res = (rhs - Ay) * mg + (1.0 - mg) * (rhs - y)
            y = y + jnp.einsum("gnij,gnj->gni", Dg, res,
                               preferred_element_type=y.dtype)
        return y

    def apply(r):
        out_dtype = r.dtype
        if pc_dtype is not None:
            r = r.astype(pc_dtype)
        rb = jnp.pad(r.reshape(Lp, n2d, bs), ((0, padp), (0, 0), (0, 0)))
        rb = rb.reshape(ng, G, n2d, bs)
        zero_pl = jnp.zeros((n2d, bs), r.dtype)

        def down(below, gidx):
            rhs = rb[gidx]
            y0 = jnp.einsum("gnij,gnj->gni", Dinv_g[gidx], rhs,
                            preferred_element_type=r.dtype)
            y = relax_group(V0[gidx], Vm[gidx], Vp[gidx], Dinv_g[gidx],
                            mb_g[gidx], rhs, below, zero_pl, y0)
            return y[-1], y

        _, Xd = jax.lax.scan(down, zero_pl, jnp.arange(ng))
        if not symmetric:
            X = Xd.reshape(Lp_pad, n2d, bs)[:Lp]
            return X.reshape(-1).astype(out_dtype)

        def up(above, gidx):
            rhs = rb[gidx]
            below = jnp.where(gidx > 0, 1.0, 0.0) * Xd[
                jnp.maximum(gidx - 1, 0), -1]
            y = relax_group(V0[gidx], Vm[gidx], Vp[gidx], Dinv_g[gidx],
                            mb_g[gidx], rhs, below, above, Xd[gidx])
            return y[0], y

        _, Xu = jax.lax.scan(up, zero_pl, jnp.arange(ng), reverse=True)
        X = Xu.reshape(Lp_pad, n2d, bs)[:Lp]
        return X.reshape(-1).astype(out_dtype)

    return apply


def scalar_jacobi(diag: jnp.ndarray, mask: jnp.ndarray) -> Callable:
    d = mask * diag + (1.0 - mask)
    inv = 1.0 / d

    def apply(x):
        return inv * x

    return apply
