"""Layered (plane-structured) block matrix format for extruded meshes.

The hot-loop redesign (SURVEY.md 'hard parts': sparse SpMV with good
utilization).  The channel mesh is an extrusion: node = (plane l,
2D-node i), and every matrix block couples (l, i) -> (l + delta, j) with
delta in {-1, 0, +1} and j in the 2D cross-section adjacency of i.  So
the Jacobian is block-tridiagonal over planes with the SAME 2D sparsity
in every plane, and SpMV becomes:

    y[l, i] = sum_e sum_delta  V[e, delta, l] @ x[l + delta, col(e)]

where e runs over directed 2D adjacency pairs.  The gathers now move
whole plane-columns of x — (n_planes, 4) rows, KBs per index instead of
the 16 B rows of generic block-CSR — and the value stream is fully
sequential.

Assembly reuses the generic segment-sum machinery: only the scatter
target (pair, delta, plane) differs, so ``matrix_values_of`` works
unchanged with this pattern's ``ell_pos``.

Unused nodes (the solid splitter interior) stay in the dense (L+1, n2d)
node grid as identity rows masked by the BC machinery.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.space import MixedVelocityPressureSpace
from .assembly import AsmArrays, BlockPattern


class LayeredArrays(NamedTuple):
    """Device arrays for the layered operator (a pytree)."""

    cell_dofs: jnp.ndarray       # (nc, ndl) plane-major dof ids
    cell_coords: jnp.ndarray     # (nc, nv, 3)
    ell_pos: jnp.ndarray         # (nc, nbl, nbl) -> (e*3 + d)*Lp + l
    cols: jnp.ndarray            # (E,) 2D column node of each pair
    row_ids: jnp.ndarray         # (E,) 2D row node (sorted)
    diag_pos: jnp.ndarray        # (n2d,) pair id of the (i, i) pair
    # optional gather plan (assembly.py::build_gather_plan): replaces the
    # Jacobian scatter-add with dense gather+sum on the single-device
    # path (the profiled 1M-dof hot spot); None -> scatter fallback
    # (slab-sharded and stub constructions)
    gtab: jnp.ndarray = None         # (n_seg, degA) int32
    gtab_over: jnp.ndarray = None    # (n_over, degB) int32
    gtab_over_ids: jnp.ndarray = None  # (n_over,) int32
    # structured-extrusion plan (assemble/structured.py::StructuredAsm,
    # a nested pytree): the scatter-free Jacobian assembly on extruded
    # meshes; None -> scatter fallback
    sasm: object = None


@dataclasses.dataclass
class LayeredPattern:
    n2d: int
    n_planes: int                # Lp = number of node planes
    E: int                       # directed 2D pairs (incl. self)
    bs: int
    pattern_like: BlockPattern   # adapter for matrix_values_of signature
    arrays: LayeredArrays
    # which Jacobian-assembly path matrix_values_layered will take for
    # these arrays ('structured' | 'gather' | 'scatter') — decided at
    # build time by NS_NO_STRUCTURED / NS_GATHER_ASM
    asm_path: str = "scatter"

    @property
    def nnzb(self) -> int:
        return self.E * 3 * self.n_planes

    @property
    def ndofs(self) -> int:
        return self.n2d * self.n_planes * self.bs


def build_layered(
    space: MixedVelocityPressureSpace,
    n2d: int,
    n_planes: int,
    dtype=None,
) -> LayeredPattern:
    """Build the layered pattern for an extruded equal-order mixed space.

    Node ids must be plane-major: node = l * n2d + i (the layout
    mesh/extrude.py emits before compaction).
    """
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    mesh = space.mesh
    bs = space.block_size
    nbl = mesh.cells.shape[1]
    Lp = n_planes

    # fused native pass (csrc/meshops.cpp::build_layered_pattern): emits
    # the sorted 2D pair list AND the final per-cell scatter ids in two
    # linear sweeps.  The numpy fallback below chains repeat/tile/unique/
    # searchsorted over nc*nbl^2 int64 temporaries — profiled ~20 s of
    # the 39.5 s lc=0.024 setup on the single-core bench host.
    from ..utils.native import build_layered_pattern_native

    fused = build_layered_pattern_native(mesh.cells, n2d, Lp)
    if fused is not None:
        cols2d, rows2d, diag_pos, ell_pos, E = fused
    else:
        cells = mesh.cells.astype(np.int64)
        l_of = cells // n2d                  # (nc, 4) plane index
        i_of = cells % n2d                   # (nc, 4) 2D node index

        la = np.repeat(l_of, nbl, axis=1).ravel()
        lb = np.tile(l_of, (1, nbl)).ravel()
        delta = lb - la
        assert delta.min() >= -1 and delta.max() <= 1, \
            "not a 1-layer extrusion"

        from ..utils.native import build_pattern_native

        nat = build_pattern_native(i_of.astype(np.int32), n2d)
        if nat is not None:
            _indptr, cols2d, rows2d, inv_pos, diag_pos = nat
            E = len(cols2d)
            inv = inv_pos.reshape(-1).astype(np.int64)
        else:
            ia = np.repeat(i_of, nbl, axis=1).ravel()
            ib = np.tile(i_of, (1, nbl)).ravel()
            keys = ia * n2d + ib
            uniq, inv = np.unique(keys, return_inverse=True)
            E = len(uniq)
            rows2d = (uniq // n2d).astype(np.int32)
            cols2d = (uniq % n2d).astype(np.int32)
            diag_keys = np.arange(n2d, dtype=np.int64) * (n2d + 1)
            diag_pos = np.searchsorted(uniq, diag_keys)
            assert (uniq[diag_pos] == diag_keys).all(), \
                "missing diagonal pairs"
        # (delta d, pair e, row plane l) -> segment id; delta-major so
        # the value tensor lands in the (bs, bs, 3, E, Lp) layout
        seg = ((delta + 1) * E + inv) * Lp + la
        ell_pos = seg.reshape(mesh.cells.shape[0], nbl, nbl) \
            .astype(np.int32)

    from .assembly import ASM_CHUNK

    nnz_layer = E * 3 * Lp
    nc = mesh.cells.shape[0]
    # pad directly into preallocated arrays (a concatenate here copies
    # ~400 MB of already-final data at 1.45M cells); gather coordinates
    # in the TARGET dtype — an f32 gather moves half the bytes of the
    # f64 gather + device-put cast it replaces
    nc_pad = nc if nc <= ASM_CHUNK else -(-nc // ASM_CHUNK) * ASM_CHUNK
    np_dtype = np.dtype(jnp.zeros(0, dtype).dtype.name)
    pts = np.ascontiguousarray(mesh.points, dtype=np_dtype)
    cc_p = np.empty((nc_pad,) + (nbl, pts.shape[1]), np_dtype)
    cc_p[:nc] = pts[mesh.cells]
    cdw = np.asarray(space.cell_dofs_w, np.int32)
    cd_p = np.empty((nc_pad, cdw.shape[1]), np.int32)
    cd_p[:nc] = cdw
    ep_p = np.empty((nc_pad, nbl, nbl), np.int32)
    ep_p[:nc] = ell_pos
    if nc_pad > nc:
        cc_p[nc:] = cc_p[0]          # padded cells reuse cell 0 coords
        cd_p[nc:] = space.ndofs      # scatter into the trash dof
        ep_p[nc:] = nnz_layer        # scatter into the trash segment
    # the gather-plan Jacobian reduction (opt in with NS_GATHER_ASM=1)
    # replaces the scatter with random small-granule gathers; the
    # default is the structured-extrusion reduction (layer-minor row
    # gathers) — see assemble/structured.py.
    gplan = (None, None, None)
    if os.environ.get("NS_GATHER_ASM"):
        from .assembly import build_gather_plan

        tabA, tabB, over_ids = build_gather_plan(ep_p, nnz_layer)
        gplan = (jnp.asarray(tabA), jnp.asarray(tabB),
                 jnp.asarray(over_ids))
    arrays = LayeredArrays(
        cell_dofs=jnp.asarray(cd_p, jnp.int32),
        cell_coords=jnp.asarray(cc_p, dtype),
        ell_pos=jnp.asarray(ep_p),
        cols=jnp.asarray(cols2d),
        row_ids=jnp.asarray(rows2d),
        diag_pos=jnp.asarray(diag_pos.astype(np.int32)),
        gtab=gplan[0],
        gtab_over=gplan[1],
        gtab_over_ids=gplan[2],
    )
    if not os.environ.get("NS_NO_STRUCTURED"):
        from .structured import build_structured_plan

        sasm = build_structured_plan(mesh, cd_p, cc_p, ep_p, n2d, Lp, E, bs)
        if sasm is not None:
            arrays = arrays._replace(sasm=sasm)
    # Assembly numerics depend on env vars read at BUILD time (above):
    # record which Jacobian-assembly path this pattern will take so
    # benchmarks/tests can assert it instead of guessing from the env.
    asm_path = ("structured_soa" if arrays.sasm is not None
                and arrays.sasm.coordsT is not None
                else "structured" if arrays.sasm is not None
                else "gather" if arrays.gtab is not None else "scatter")
    # adapter so matrix_values_of(kernel, nnzb, bs, ...) can be reused: it
    # only needs ell_pos/cell_dofs/cell_coords + nnzb
    pat = BlockPattern(
        n_rows=n2d * Lp, bs=bs, indptr=np.zeros(1, np.int32),
        indices=cols2d, row_ids=rows2d, ell_pos=ell_pos,
        diag_pos=diag_pos.astype(np.int32))
    return LayeredPattern(n2d, Lp, E, bs, pat, arrays, asm_path)


def matrix_values_layered(
    kernel: Callable,
    E: int,
    n_planes: int,
    bs: int,
    arrays: LayeredArrays,
    w: jnp.ndarray,
) -> jnp.ndarray:
    """Layered Jacobian values in a plane-minor layout.

    Returns V with shape (bs, bs, 3, E, Lp): V[i, j, d, e, l] is the
    (row-component i, col-component j) entry of the block for layer
    offset d-1, pair e, row plane l.  Trailing axis = planes, so the HBM
    tiling pads Lp -> 128 instead of padding a trailing 4 by 32x (the
    naive (nnzb, bs, bs) layout OOMs at ~10^6 cells through a padded
    remat copy).  Assembled as bs*bs strided segment-sums over the raw
    (nc, ndl, ndl) element Jacobians — no big transposes.
    """
    from .assembly import (AsmArrays, assemble_jacobian_chunked,
                           assemble_jacobian_gather)

    Lp = n_planes
    nnz_layer = E * 3 * Lp
    asm_arrays = AsmArrays(
        cell_dofs=arrays.cell_dofs, cell_coords=arrays.cell_coords,
        indices=arrays.cols, row_ids=arrays.row_ids,
        ell_pos=arrays.ell_pos, diag_pos=arrays.diag_pos)
    if arrays.sasm is not None:
        from .structured import matrix_values_structured

        return matrix_values_structured(kernel, E, Lp, bs, arrays.sasm, w)
    if arrays.gtab is not None:
        V = assemble_jacobian_gather(
            kernel, nnz_layer, bs, asm_arrays, w,
            arrays.gtab, arrays.gtab_over, arrays.gtab_over_ids)
    else:
        V = assemble_jacobian_chunked(kernel, nnz_layer, bs, asm_arrays, w)
    return V.reshape(bs, bs, 3, E, Lp)


def residual_layered(
    kernel: Callable,
    n2d: int,
    n_planes: int,
    bs: int,
    arrays: LayeredArrays,
    w: jnp.ndarray,
) -> jnp.ndarray:
    """Global residual on the layered path.

    Takes the SoA structured route (cell-minor kernel + plane-sliced
    gather + scatter-free reduction, assemble/structured.py) when the
    build attached the tables and the kernel carries an SoA variant;
    falls back to the generic segment-sum ``residual_of`` otherwise
    (slab-sharded arrays, non-extruded meshes, foreign kernels)."""
    if (arrays.sasm is not None and arrays.sasm.coordsT is not None
            and getattr(kernel, "res_soa", None)):
        from .structured import residual_structured

        return residual_structured(kernel, n_planes, arrays.sasm, w)
    from .assembly import residual_of

    ndofs = n2d * n_planes * bs
    asm_arrays = AsmArrays(
        cell_dofs=arrays.cell_dofs, cell_coords=arrays.cell_coords,
        indices=arrays.cols, row_ids=arrays.row_ids,
        ell_pos=arrays.ell_pos, diag_pos=arrays.diag_pos)
    return residual_of(kernel, ndofs, asm_arrays, w)


def layered_matvec(
    arrays: LayeredArrays,
    n2d: int,
    n_planes: int,
    values: jnp.ndarray,          # (bs, bs, 3, E, Lp)
    x: jnp.ndarray,               # (ndofs,)
) -> jnp.ndarray:
    """y = A x in the layered format.

    Written as a broadcast multiply + small-axis reduction rather than an
    einsum: XLA lowers the (e, l)-batched contraction to dot_general with
    layout-mismatched operands and materializes ~SpMV-sized transposes
    per call (measured 246 ms vs ~2 ms at 345k dofs).  The elementwise
    form streams the value tensor exactly once.
    """
    bs, _, _, E, Lp = values.shape
    out_dtype = x.dtype
    xg = x.reshape(Lp, n2d, bs)[:, arrays.cols, :]       # (Lp, E, bs)
    xgT = xg.transpose(2, 1, 0)                          # (bs, E, Lp) small
    if values.dtype != x.dtype:
        # bf16 value stream (VERDICT round-2 item 7): cast the SMALL
        # gathered-x tensor to the values dtype so the product has no
        # mixed-dtype upcast — XLA's bf16*f32 path materializes an f32
        # copy of the whole value tensor in a separate pass (measured
        # 0.52x); with both operands bf16 the value read is half the
        # f32 HBM traffic.  Accumulation happens in f32 via the sum
        # dtype below.
        xgT = xgT.astype(values.dtype)
    zero = jnp.zeros((bs, E, 1), xgT.dtype)
    x_m = jnp.concatenate([zero, xgT[..., :-1]], axis=-1)    # x[l-1] at l
    x_p = jnp.concatenate([xgT[..., 1:], zero], axis=-1)     # x[l+1] at l
    xs = jnp.stack([x_m, xgT, x_p], axis=1)              # (bs, 3, E, Lp)
    # y[i, e, l] = sum_{j, d} V[i, j, d, e, l] * xs[j, d, e, l]
    contrib = (values * xs[None]).sum(axis=(1, 2), dtype=out_dtype)
    y2d = jax.ops.segment_sum(
        contrib.transpose(1, 0, 2), arrays.row_ids, num_segments=n2d,
        indices_are_sorted=True)                          # (n2d, bs, Lp)
    return y2d.transpose(2, 0, 1).reshape(-1)


def make_layered_op(arrays: LayeredArrays, n2d: int, n_planes: int,
                    values: jnp.ndarray, mask: jnp.ndarray) -> Callable:
    """BC-projected operator closure A(x) = P A P x + (I - P) x."""
    def matvec(x):
        return layered_matvec(arrays, n2d, n_planes, values, x)

    def op(x):
        return mask * matvec(mask * x) + (1.0 - mask) * x

    return op


def layered_diag_blocks(
    arrays: LayeredArrays,
    n2d: int,
    values: jnp.ndarray,          # (bs, bs, 3, E, Lp)
) -> jnp.ndarray:
    """(Lp * n2d, bs, bs) node-diagonal blocks (delta = 0, self pairs)."""
    bs = values.shape[0]
    d = values[:, :, 1, arrays.diag_pos, :]   # (bs, bs, n2d, Lp)
    return d.transpose(3, 2, 0, 1).reshape(-1, bs, bs)
