"""Structured-extrusion Jacobian assembly: the scatter-free hot path.

The generic Jacobian assembly scatters element blocks with 16 colliding
segment-sum scatter-adds; generic gather-plan replacements trade them
for random small-granule gathers.  Gathering long contiguous rows is
cheaper — the insight the layered SpMV already exploits
(assemble/layered.py).  The extruded
channel gives the assembly the same structure: cells form an
(layer l, column c) grid where a column is a (triangle, tet-of-prism)
pair of the 2D cross-section, and the (matrix-pair, plane-offset)
scatter pattern of a column is LAYER-INVARIANT (the Dompierre split
depends only on relative node order, which the plane-major numbering
preserves).  So per 2D pair p, the assembled values across ALL planes
are a fixed small set of per-column contribution streams:

    V[ci, cj, p, l] = sum_t  J[col_t, l - off_t, a_t*bs+ci, b_t*bs+cj]

Laying the element Jacobians out as (column*entry, layer) — layer
minor — turns the reduction into row gathers of nl*4 B (~1 KB at
production meshes) plus plane-shifted adds: no scatter at all.

The plan is DERIVED FROM ``ell_pos`` AND VERIFIED cell-by-cell at build
time (layer-invariance is checked, not assumed); any mismatch returns
None and the caller keeps the scatter path.

Replaces the reference's FFCx insertion loop
(/root/reference/NavierStokes/NavierStokesChannelFlow.py:69-75) on the
flagship extruded-channel path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .assembly import ASM_CHUNK, _cell_jacobians


class StructuredAsm(NamedTuple):
    """Device arrays of the structured plan (a pytree; rides inside
    ``LayeredArrays.sasm``)."""

    cell_dofs: jnp.ndarray     # (M3p*nl, ndl) column-major (col, l) cells
    cell_coords: jnp.ndarray   # (M3p*nl, nv, 3)
    alive: jnp.ndarray         # (M3p*nl,) f32 1=real cell, 0=dead
    tab: jnp.ndarray           # (3Ep, degA) row-base ids into the buffer
    off: jnp.ndarray           # (3Ep, degA) f32 plane offset (0/1)
    tab_over: jnp.ndarray      # (n_over, degB) row-base ids
    off_over: jnp.ndarray      # (n_over, degB) f32
    over_ids: jnp.ndarray      # (n_over,) pair ids
    # --- SoA extension (round 4): cell-minor kernel + plane-sliced
    # w-gather + structured residual reduction; None when the dof map
    # failed layer-invariance or NS_NO_SOA was set at build ---
    coordsT: jnp.ndarray = None   # (12, M3p*nl) transposed coords
    wdof: jnp.ndarray = None      # (M3p, ndl) 2D scalar dof (row of w2)
    wolay: jnp.ndarray = None     # (M3p, ndl) plane offset {0,1}
    rtab: jnp.ndarray = None      # (n2d*bs, degR) rows col*ndl+a
    roff: jnp.ndarray = None      # (n2d*bs, degR) f32 plane offset
    rtab_over: jnp.ndarray = None  # (n_rover, degRB)
    roff_over: jnp.ndarray = None  # (n_rover, degRB) f32
    rover_ids: jnp.ndarray = None  # (n_rover,) target scalar-dof ids


def build_structured_plan(mesh, cd_np, cc_np, ep_np, n2d: int, Lp: int,
                          E: int, bs: int,
                          max_degA: int = 8,
                          cover: float = 0.99) -> Optional[StructuredAsm]:
    """Host-side plan build from the (numpy) padded cell arrays; returns
    None when the mesh does not carry the extrusion grid or the pattern
    fails layer-invariance."""
    ext = getattr(mesh, "extrusion", None)
    if ext is None:
        return None
    ntri, nl, keep = ext            # keep: (nl, ntri) bool
    if nl != Lp - 1:
        return None
    nbl = ep_np.shape[1]
    ndl = cd_np.shape[1]
    nc = mesh.n_cells
    cells = np.asarray(mesh.cells[:nc])
    ep = np.asarray(ep_np)[:nc]                   # (nc, nbl, nbl)
    cd = np.asarray(cd_np)[:nc]
    cc = np.asarray(cc_np)[:nc]
    M3 = 3 * ntri

    # ---- cell grid from the deterministic extrusion order -------------
    k_l = keep.sum(axis=1) * 3
    if int(k_l.sum()) != nc:
        return None
    offs = np.concatenate([[0], np.cumsum(k_l)])
    grid = np.full((nl, M3), -1, np.int64)
    for l in range(nl):
        kept = np.nonzero(keep[l])[0]
        cols = (3 * kept[:, None] + np.arange(3)[None, :]).ravel()
        grid[l, cols] = offs[l] + np.arange(len(cols))

    # ---- derive (pair, off) per cell and verify layer-invariance ------
    lb = (cells.min(axis=1) // n2d).astype(np.int64)       # base plane
    pair = ep // Lp                                        # (nc, nbl, nbl)
    off = ep % Lp - lb[:, None, None]
    if off.min() < 0 or off.max() > 1:
        return None
    alive = grid >= 0
    gi = np.where(alive, grid, 0)
    # reference = first alive layer of each column
    first_l = np.argmax(alive, axis=0)                     # (M3,)
    ref_cell = gi[first_l, np.arange(M3)]
    pref, oref = pair[ref_cell], off[ref_cell]             # (M3, nbl, nbl)
    ok = ((pair[gi] == pref[None]) & (off[gi] == oref[None])) \
        | ~alive[:, :, None, None]
    if not bool(ok.all()):
        return None
    if not bool((lb[gi] == np.arange(nl)[:, None])[alive].all()):
        return None

    # ---- invert: pair p -> padded contribution tables -----------------
    # contribution q = col*nbl*nbl + a*nbl + b; buffer row base =
    # col*ndl*ndl + a*bs*ndl + b*bs (16 (ci, cj) rows at +ci*ndl+cj)
    n_pairs = 3 * E
    q = np.arange(M3 * nbl * nbl, dtype=np.int64)
    colq, aq, bq = q // (nbl * nbl), (q // nbl) % nbl, q % nbl
    rowbase = colq * ndl * ndl + aq * bs * ndl + bq * bs
    p_flat = pref.reshape(-1).astype(np.int64)
    o_flat = oref.reshape(-1)
    order = np.argsort(p_flat, kind="stable")
    counts = np.bincount(p_flat, minlength=n_pairs)
    starts = np.zeros(n_pairs + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    degA = int(min(max(np.quantile(counts, cover), 1), max_degA))
    trash_row = M3 * ndl * ndl                  # the appended zero block
    j = np.arange(degA, dtype=np.int64)
    idxA = starts[:n_pairs, None] + j[None, :]
    valid = j[None, :] < counts[:, None]
    src = order[np.minimum(idxA, M3 * nbl * nbl - 1)]
    tab = np.where(valid, rowbase[src], trash_row).astype(np.int32)
    offA = np.where(valid, o_flat[src], 0).astype(np.float32)
    over_ids = np.nonzero(counts > degA)[0]
    if len(over_ids):
        degB = int(counts[over_ids].max()) - degA
        jB = degA + np.arange(degB, dtype=np.int64)
        idxB = starts[over_ids, None] + jB[None, :]
        validB = jB[None, :] < counts[over_ids, None]
        srcB = order[np.minimum(idxB, M3 * nbl * nbl - 1)]
        tab_over = np.where(validB, rowbase[srcB], trash_row) \
            .astype(np.int32)
        off_over = np.where(validB, o_flat[srcB], 0).astype(np.float32)
    else:
        tab_over = np.full((0, 1), trash_row, np.int32)
        off_over = np.zeros((0, 1), np.float32)

    # ---- pad: columns to a chunk multiple, pairs to a multiple of 8 ---
    m = max(1, ASM_CHUNK // nl)
    M3p = -(-M3 // m) * m
    P = 8
    n_pp = -(-n_pairs // P) * P
    if n_pp > n_pairs:
        padt = np.full((n_pp - n_pairs, tab.shape[1]), trash_row, np.int32)
        tab = np.concatenate([tab, padt])
        offA = np.concatenate(
            [offA, np.zeros((n_pp - n_pairs, offA.shape[1]), np.float32)])

    # ---- column-major structured cell arrays --------------------------
    ndofs = n2d * Lp * bs
    giT = grid.T                                   # (M3, nl)
    aliveT = alive.T
    gsafe = np.where(aliveT, giT, 0)
    scd = np.empty((M3p, nl, ndl), np.int32)
    scd[:M3] = cd[gsafe]
    scd[:M3][~aliveT] = ndofs                      # dead cells: safe dof
    scd[M3:] = ndofs
    np_dtype = cc.dtype
    scc = np.empty((M3p, nl) + cc.shape[1:], np_dtype)
    scc[:M3] = cc[gsafe]
    scc[M3:] = cc[0]
    smask = np.zeros((M3p, nl), np.float32)
    smask[:M3] = aliveT

    # ---- SoA extension: transposed coords + w-gather + residual plan --
    soa_fields = _build_soa_tables(
        cd, gi, alive, first_l, lb, scc, n2d, bs, nl, M3, M3p, ndl)

    return StructuredAsm(
        cell_dofs=jnp.asarray(scd.reshape(M3p * nl, ndl)),
        cell_coords=jnp.asarray(scc.reshape((M3p * nl,) + cc.shape[1:])),
        alive=jnp.asarray(smask.reshape(M3p * nl)),
        tab=jnp.asarray(tab),
        off=jnp.asarray(offA),
        tab_over=jnp.asarray(tab_over),
        off_over=jnp.asarray(off_over),
        over_ids=jnp.asarray(over_ids.astype(np.int32)),
        **soa_fields,
    )


def _build_soa_tables(cd, gi, alive, first_l, lb, scc, n2d, bs, nl, M3,
                      M3p, ndl):
    """Host-side tables for the SoA assembly path (round 4).

    Derives the layer-invariant (2D scalar dof, plane offset) of every
    (column, local dof) from the reference layer, VERIFIES it against
    every alive cell's dofmap, and inverts it into the residual
    reduction tables.  Returns {} (the plan stays AoS-only) when the
    invariance fails or NS_NO_SOA is set.
    """
    import os

    if os.environ.get("NS_NO_SOA") or ndl != 16 or bs != 4:
        return {}
    n2dbs = n2d * bs
    ref_cell = gi[first_l, np.arange(M3)]
    cdr = cd[ref_cell].astype(np.int64)              # (M3, ndl)
    lbr = lb[ref_cell][:, None]
    oa = cdr // n2dbs - lbr                          # (M3, ndl)
    if oa.min() < 0 or oa.max() > 1:
        return {}
    n2da = cdr % n2dbs
    # verify: dof(col, a, l) == (l + oa)*n2dbs + n2da for every alive cell
    expect = ((np.arange(nl)[:, None, None] + oa[None]) * n2dbs
              + n2da[None])                          # (nl, M3, ndl)
    ok = (cd[np.where(alive, gi, 0)] == expect) | ~alive[:, :, None]
    if not bool(ok.all()):
        return {}

    # w-gather tables, padded columns -> row 0 (dead, masked)
    wdof = np.zeros((M3p, ndl), np.int32)
    wdof[:M3] = n2da
    wolay = np.zeros((M3p, ndl), np.int32)
    wolay[:M3] = oa

    # residual reduction: target scalar dof t = n2da, source row
    # col*ndl + a of the (M3p*ndl, nl) contribution buffer, shifted by oa
    t_flat = n2da.reshape(-1)
    src = (np.arange(M3, dtype=np.int64)[:, None] * ndl
           + np.arange(ndl)[None, :]).reshape(-1)
    o_flat = oa.reshape(-1)
    order = np.argsort(t_flat, kind="stable")
    counts = np.bincount(t_flat, minlength=n2dbs)
    starts = np.zeros(n2dbs + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    degR = int(min(max(np.quantile(counts, 0.99), 1), 40))
    trash = M3p * ndl                                # appended zero row
    j = np.arange(degR, dtype=np.int64)
    idx = starts[:n2dbs, None] + j[None, :]
    valid = j[None, :] < counts[:, None]
    pick = order[np.minimum(idx, M3 * ndl - 1)]
    rtab = np.where(valid, src[pick], trash).astype(np.int32)
    roff = np.where(valid, o_flat[pick], 0).astype(np.float32)
    rover_ids = np.nonzero(counts > degR)[0]
    if len(rover_ids):
        degB = int(counts[rover_ids].max()) - degR
        jB = degR + np.arange(degB, dtype=np.int64)
        idxB = starts[rover_ids, None] + jB[None, :]
        validB = jB[None, :] < counts[rover_ids, None]
        pickB = order[np.minimum(idxB, M3 * ndl - 1)]
        rtab_over = np.where(validB, src[pickB], trash).astype(np.int32)
        roff_over = np.where(validB, o_flat[pickB], 0).astype(np.float32)
    else:
        rtab_over = np.full((0, 1), trash, np.int32)
        roff_over = np.zeros((0, 1), np.float32)

    coordsT = np.ascontiguousarray(
        scc.reshape(M3p * nl, -1).T)                 # (12, M3p*nl)
    return dict(
        coordsT=jnp.asarray(coordsT),
        wdof=jnp.asarray(wdof),
        wolay=jnp.asarray(wolay),
        rtab=jnp.asarray(rtab),
        roff=jnp.asarray(roff),
        rtab_over=jnp.asarray(rtab_over),
        roff_over=jnp.asarray(roff_over),
        rover_ids=jnp.asarray(rover_ids.astype(np.int32)),
    )


def gather_wT(sasm: StructuredAsm, Lp: int, w: jnp.ndarray) -> jnp.ndarray:
    """(ndl, M3p*nl) transposed solution gather — the SpMV trick applied
    to assembly: per (column, local dof) the dof ids across layers are an
    arithmetic sequence, so the gather moves nl*4 B plane-rows (~0.5 KB)
    of w2 = w reshaped (n2d*bs, Lp) instead of 4 B scalars."""
    nl = Lp - 1
    M3p, ndl = sasm.wdof.shape
    n2dbs = w.shape[0] // Lp
    w2 = w.reshape(Lp, n2dbs).T                      # (n2dbs, Lp)
    idx = jnp.stack([sasm.wdof.reshape(-1), sasm.wolay.reshape(-1)],
                    axis=1)                          # (M3p*ndl, 2)
    dnums = jax.lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(0,),
        start_index_map=(0, 1))
    rows = jax.lax.gather(w2, idx, dnums, slice_sizes=(1, nl))
    return rows.reshape(M3p, ndl, nl).transpose(1, 0, 2) \
        .reshape(ndl, M3p * nl)


def matrix_values_structured_soa(kernel, E: int, Lp: int, bs: int,
                                 sasm: StructuredAsm,
                                 w: jnp.ndarray) -> jnp.ndarray:
    """(bs, bs, 3, E, Lp) Jacobian values via the SoA kernel
    (forms/soa.py) — cell-minor math at full VPU lane width, plus the
    plane-sliced w-gather.  Reduction tables are shared with the AoS
    structured path."""
    nl = Lp - 1
    ndl = sasm.wdof.shape[1]
    e2 = ndl * ndl
    ncs = sasm.coordsT.shape[1]
    M3p = ncs // nl
    m = max(1, ASM_CHUNK // nl)
    n_chunks = M3p // m
    wT = gather_wT(sasm, Lp, w)
    alive = sasm.alive.astype(w.dtype)

    def chunk_rows(c0):
        # int32 throughout: under x64 the python-int index literals
        # canonicalize to int64 and dynamic_slice rejects mixed dtypes
        c0 = jnp.asarray(c0, jnp.int32)
        z = jnp.zeros((), jnp.int32)
        cT = jax.lax.dynamic_slice(sasm.coordsT, (z, c0), (12, m * nl))
        wc = jax.lax.dynamic_slice(wT, (z, c0), (ndl, m * nl))
        al = jax.lax.dynamic_slice(alive, (c0,), (m * nl,))
        J = kernel.jac_soa(cT, wc) * al[None, None, :]  # (ndl, ndl, m*nl)
        return J.reshape(e2, m, nl).transpose(1, 0, 2).reshape(m * e2, nl)

    if n_chunks == 1:
        buf = chunk_rows(0)
    else:
        offs = jnp.arange(n_chunks, dtype=jnp.int32)

        def body(b, k):
            return jax.lax.dynamic_update_slice(
                b, chunk_rows(k * (m * nl)),
                (k * (m * e2), jnp.zeros((), jnp.int32))), None

        buf, _ = jax.lax.scan(
            body, jnp.zeros((M3p * e2, nl), w.dtype), offs)
    return _reduce_jac_buffer(buf, sasm, E, Lp, bs, ndl, nl, w.dtype)


def residual_structured(kernel, Lp: int, sasm: StructuredAsm,
                        w: jnp.ndarray) -> jnp.ndarray:
    """(ndofs,) global residual via the SoA kernel + the structured
    (scatter-free) reduction: contributions land as (col*ndl + a, layer)
    rows and reduce per 2D scalar dof with plane-shifted row gathers —
    replaces the colliding segment-sum of assembly.py::residual_of on
    extruded meshes."""
    nl = Lp - 1
    M3p, ndl = sasm.wdof.shape
    ncs = M3p * nl
    m = max(1, ASM_CHUNK // nl)
    n_chunks = M3p // m
    wT = gather_wT(sasm, Lp, w)
    alive = sasm.alive.astype(w.dtype)

    def chunk_rows(c0):
        # int32 throughout: under x64 the python-int index literals
        # canonicalize to int64 and dynamic_slice rejects mixed dtypes
        c0 = jnp.asarray(c0, jnp.int32)
        z = jnp.zeros((), jnp.int32)
        cT = jax.lax.dynamic_slice(sasm.coordsT, (z, c0), (12, m * nl))
        wc = jax.lax.dynamic_slice(wT, (z, c0), (ndl, m * nl))
        al = jax.lax.dynamic_slice(alive, (c0,), (m * nl,))
        r = kernel.res_soa(cT, wc) * al[None, :]        # (ndl, m*nl)
        return r.reshape(ndl, m, nl).transpose(1, 0, 2).reshape(
            m * ndl, nl)

    if n_chunks == 1:
        rbuf = chunk_rows(0)
    else:
        offs = jnp.arange(n_chunks, dtype=jnp.int32)

        def body(b, k):
            return jax.lax.dynamic_update_slice(
                b, chunk_rows(k * (m * nl)),
                (k * (m * ndl), jnp.zeros((), jnp.int32))), None

        rbuf, _ = jax.lax.scan(
            body, jnp.zeros((M3p * ndl, nl), w.dtype), offs)

    rbufz = jnp.concatenate([rbuf, jnp.zeros((1, nl), w.dtype)])

    def reduce(tab, off):
        rows = rbufz[tab]                               # (nR, deg, nl)
        o = off[:, :, None].astype(w.dtype)
        s0 = (rows * (1.0 - o)).sum(axis=1)             # plane l
        s1 = (rows * o).sum(axis=1)                     # plane l + 1
        return (jnp.pad(s0, ((0, 0), (0, 1)))
                + jnp.pad(s1, ((0, 0), (1, 0))))        # (nR, Lp)

    R2 = reduce(sasm.rtab, sasm.roff)
    if sasm.rtab_over.shape[0] > 0:
        R2 = R2.at[sasm.rover_ids].add(
            reduce(sasm.rtab_over, sasm.roff_over), unique_indices=True)
    return R2.T.reshape(-1)                             # (Lp*n2d*bs,)


def matrix_values_structured(kernel, E: int, Lp: int, bs: int,
                             sasm: StructuredAsm,
                             w: jnp.ndarray) -> jnp.ndarray:
    """(bs, bs, 3, E, Lp) Jacobian values via the structured plan."""
    if sasm.coordsT is not None and getattr(kernel, "jac_soa", None):
        return matrix_values_structured_soa(kernel, E, Lp, bs, sasm, w)
    nl = Lp - 1
    ndl = sasm.cell_dofs.shape[1]
    e2 = ndl * ndl
    ncs = sasm.cell_dofs.shape[0]
    M3p = ncs // nl
    m = max(1, ASM_CHUNK // nl)
    n_chunks = M3p // m

    def chunk_rows(cdi, cci, mki):
        # (m*nl, ndl, ndl) cell Jacobians -> (m*e2, nl) layer-minor rows
        J = _cell_jacobians(kernel, cci, cdi, w)
        J = J * mki[:, None, None]
        return J.reshape(m, nl, e2).transpose(0, 2, 1).reshape(m * e2, nl)

    if n_chunks == 1:
        buf = chunk_rows(sasm.cell_dofs, sasm.cell_coords, sasm.alive)
    else:
        cd = sasm.cell_dofs.reshape(n_chunks, m * nl, ndl)
        cc = sasm.cell_coords.reshape(
            (n_chunks, m * nl) + sasm.cell_coords.shape[1:])
        mk = sasm.alive.reshape(n_chunks, m * nl)
        offs = jnp.arange(n_chunks, dtype=jnp.int32) * (m * e2)

        def body(b, inp):
            cdi, cci, mki, o = inp
            return jax.lax.dynamic_update_slice(
                b, chunk_rows(cdi, cci, mki),
                (o, jnp.zeros((), jnp.int32))), None

        buf, _ = jax.lax.scan(
            body, jnp.zeros((M3p * e2, nl), w.dtype), (cd, cc, mk, offs))

    return _reduce_jac_buffer(buf, sasm, E, Lp, bs, ndl, nl, w.dtype)


def _reduce_jac_buffer(buf, sasm: StructuredAsm, E: int, Lp: int,
                       bs: int, ndl: int, nl: int, dtype) -> jnp.ndarray:
    """(M3p*e2, nl) layer-minor contribution rows -> (bs, bs, 3, E, Lp)
    via the pair tables (shared by the AoS and SoA buffer builders)."""
    e2 = ndl * ndl
    bufz = jnp.concatenate([buf, jnp.zeros((e2, nl), dtype)])
    b2 = bs * bs
    ent = (jnp.arange(bs)[:, None] * ndl
           + jnp.arange(bs)[None, :]).reshape(-1)          # ci*ndl + cj

    def reduce_pairs(tab, off):
        # tab (np_, deg) row bases; returns (np_, b2, Lp)
        np_, deg = tab.shape
        idx = (tab[:, :, None] + ent[None, None, :])
        rows = bufz[idx.reshape(-1)].reshape(np_, deg, b2, nl)
        o = off[:, :, None, None].astype(dtype)
        s0 = (rows * (1.0 - o)).sum(axis=1)                # plane l
        s1 = (rows * o).sum(axis=1)                        # plane l+1
        return (jnp.pad(s0, ((0, 0), (0, 0), (0, 1)))
                + jnp.pad(s1, ((0, 0), (0, 0), (1, 0))))

    n_pp = sasm.tab.shape[0]
    P = 8
    cE = n_pp // P
    Vp = []
    for k in range(P):
        Vp.append(reduce_pairs(sasm.tab[k * cE:(k + 1) * cE],
                               sasm.off[k * cE:(k + 1) * cE]))
    V = jnp.concatenate(Vp, axis=0)[:3 * E]                # (3E, b2, Lp)
    if sasm.tab_over.shape[0] > 0:
        V = V.at[sasm.over_ids].add(
            reduce_pairs(sasm.tab_over, sasm.off_over),
            unique_indices=True)
    return V.transpose(1, 0, 2).reshape(bs, bs, 3, E, Lp)
