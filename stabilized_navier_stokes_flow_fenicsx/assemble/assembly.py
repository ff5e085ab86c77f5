"""Element assembly: vmapped kernels + segment-sum scatter into block-CSR.

Replacement for DOLFINx/FFCx assembly (SURVEY.md 2.2): the
reference JIT-compiles C element kernels per form and scatters through the
dofmap inside ``assemble_matrix`` / ``assemble_vector`` (reference
NavierStokes/NavierStokesChannelFlow.py:64-75).  Here every form is a single
*element residual kernel* — a pure JAX function

    kernel(coords_e (nv, gdim), w_e (ndl,)) -> r_e (ndl,)

and everything else is derived:

* global residual  = segment_sum over vmapped kernels (duplicate-dof
  reduction — the ghost ADD/REVERSE update collapses to one segment_sum),
* global Jacobian  = vmapped ``jax.jacfwd`` of the kernel, scattered into a
  node-block CSR matrix (replaces UFL ``derivative`` + FFCx, reference
  NavierStokesChannelFlow.py:253-254),
* linear forms     = the affine case: A = J(0), b = -r(0).

The block-CSR layout keys everything to *node blocks* (bs = dim+1 for the
equal-order P1-P1 mixed space), so SpMV is a gather + batched (bs, bs)
matmuls + segment_sum — all ops XLA fuses well.

IMPORTANT (compile time): mesh arrays are threaded through jit as
*arguments* (the ``AsmArrays`` pytree), never as closure constants —
XLA constant-folds closure constants, which at 10^6 cells means minutes of
compile time spent "precomputing" geometry into the executable.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.bc import DirichletBC, bc_mask, bc_vector
from ..fem.space import MixedVelocityPressureSpace, FunctionSpace
from ..utils.kernelbase import ElementKernel
from ..utils.linalg import det_small, inv_small


def affine_geometry(coords: jnp.ndarray, dim: int):
    """Jacobian data for an affine simplex.

    coords: (nv, gdim) vertex coordinates (first dim+1 rows are vertices).
    Returns (J (dim, dim), invJ (dim, dim), absdetJ scalar) with
    J[i, k] = d x_i / d xi_k and invJ[k, i] = d xi_k / d x_i.
    """
    E = coords[1 : dim + 1, :] - coords[0:1, :]   # rows = edge vectors
    J = E.T
    detJ = det_small(J)
    invJ = inv_small(J)
    return J, invJ, jnp.abs(detJ)


def cell_diameter(coords: jnp.ndarray) -> jnp.ndarray:
    """UFL CellDiameter: max vertex-vertex distance (longest edge)."""
    d = coords[:, None, :] - coords[None, :, :]
    return jnp.sqrt(jnp.max(jnp.sum(d * d, axis=-1)))


# assembly chunk size: caps the jacfwd intermediates (a chunk's tangent
# batch is (CH, nq, ndl, ndl)-scale; 64k cells ~= 0.3 GB) so 10^6-cell
# Jacobian assembly streams through HBM instead of OOMing
ASM_CHUNK = 65536


def pad_cells_for_chunks(cell_dofs, cell_coords, ell_pos, ndofs, nnzb):
    """Pad cell arrays to a multiple of ASM_CHUNK; padded cells scatter
    into the trash segments (ndofs / nnzb) and use cell 0's coordinates."""
    nc = cell_dofs.shape[0]
    if nc <= ASM_CHUNK:
        return cell_dofs, cell_coords, ell_pos
    nc_pad = -(-nc // ASM_CHUNK) * ASM_CHUNK
    pad = nc_pad - nc
    if pad == 0:
        return cell_dofs, cell_coords, ell_pos
    cd = np.concatenate(
        [cell_dofs, np.full((pad, cell_dofs.shape[1]), ndofs, np.int32)])
    cc = np.concatenate(
        [cell_coords,
         np.broadcast_to(cell_coords[0], (pad,) + cell_coords.shape[1:])])
    ep = np.concatenate(
        [ell_pos, np.full((pad,) + ell_pos.shape[1:], nnzb, np.int32)])
    return cd, cc, ep


class AsmArrays(NamedTuple):
    """Mesh/dofmap data threaded through jit as arguments (a pytree)."""

    cell_dofs: jnp.ndarray      # (nc, ndl) int32
    cell_coords: jnp.ndarray    # (nc, nv, gdim)
    indices: jnp.ndarray        # (nnzb,) block column ids
    row_ids: jnp.ndarray        # (nnzb,) block row ids
    ell_pos: jnp.ndarray        # (nc, nbl, nbl) int32
    diag_pos: jnp.ndarray       # (n_rows,) int32


# ----------------------------------------------------------------------------
# Block-CSR pattern (host-side, numpy)
# ----------------------------------------------------------------------------


@dataclasses.dataclass
class BlockPattern:
    """CSR over node blocks, plus the element->nnz scatter map."""

    n_rows: int                 # number of block rows
    bs: int                     # block size
    indptr: np.ndarray          # (n_rows+1,)
    indices: np.ndarray         # (nnzb,) block column ids
    row_ids: np.ndarray         # (nnzb,) block row id of each stored block
    ell_pos: np.ndarray         # (n_cells, nbl, nbl) -> nnz position
    diag_pos: np.ndarray        # (n_rows,) position of diagonal block

    @property
    def nnzb(self) -> int:
        return self.indices.shape[0]

    def to_scipy(self, values: np.ndarray):
        """Block CSR -> scipy.sparse for host-side checks."""
        from scipy.sparse import bsr_matrix

        return bsr_matrix(
            (np.asarray(values), self.indices, self.indptr),
            shape=(self.n_rows * self.bs, self.n_rows * self.bs),
        )


def build_pattern(cell_blocks: np.ndarray, n_blocks: int, bs: int) -> BlockPattern:
    """Sparsity from element block connectivity.

    cell_blocks: (n_cells, nbl) block ids touched by each cell (e.g. the
    scalar-node connectivity for an equal-order mixed space).

    Uses the native C++ sort/unique (csrc/meshops.cpp) when available —
    the numpy np.unique over nc*nbl^2 keys dominates setup at 10^6 cells.
    """
    from ..utils.native import build_pattern_native

    nat = build_pattern_native(cell_blocks, n_blocks)
    if nat is not None:
        indptr, indices, row_ids, ell_pos, diag_pos = nat
        return BlockPattern(
            n_rows=n_blocks, bs=bs, indptr=indptr, indices=indices,
            row_ids=row_ids, ell_pos=ell_pos, diag_pos=diag_pos)

    nc, nbl = cell_blocks.shape
    rows = np.repeat(cell_blocks, nbl, axis=1).ravel()
    cols = np.tile(cell_blocks, (1, nbl)).ravel()
    keys = rows.astype(np.int64) * n_blocks + cols.astype(np.int64)
    uniq, inv = np.unique(keys, return_inverse=True)
    u_rows = (uniq // n_blocks).astype(np.int32)
    u_cols = (uniq % n_blocks).astype(np.int32)
    indptr = np.zeros(n_blocks + 1, dtype=np.int32)
    np.add.at(indptr, u_rows + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    ell_pos = inv.reshape(nc, nbl, nbl).astype(np.int32)
    diag_keys = np.arange(n_blocks, dtype=np.int64) * (n_blocks + 1)
    diag_pos = np.searchsorted(uniq, diag_keys).astype(np.int32)
    return BlockPattern(
        n_rows=n_blocks, bs=bs, indptr=indptr, indices=u_cols,
        row_ids=u_rows, ell_pos=ell_pos, diag_pos=diag_pos)


# ----------------------------------------------------------------------------
# Functional assembly (jit-friendly: data in, data out)
# ----------------------------------------------------------------------------


def residual_of(kernel: Callable, ndofs: int, arrays: AsmArrays,
                w: jnp.ndarray) -> jnp.ndarray:
    """Global residual r(w) = scatter(sum_e kernel_e).

    ElementKernel pytrees (utils/kernelbase.py) enter the jit as DYNAMIC
    arguments — their physical parameters are traced, so one compiled
    program serves every nu of a Re sweep; plain-callable kernels keep
    the legacy static treatment.
    """
    if isinstance(kernel, ElementKernel):
        return _residual_of_p(kernel, ndofs, arrays, w)
    return _residual_of_s(kernel, ndofs, arrays, w)


@partial(jax.jit, static_argnums=(1,))
def _residual_of_p(kernel, ndofs: int, arrays: AsmArrays,
                   w: jnp.ndarray) -> jnp.ndarray:
    return _residual_of_impl(kernel, ndofs, arrays, w)


@partial(jax.jit, static_argnums=(0, 1))
def _residual_of_s(kernel: Callable, ndofs: int, arrays: AsmArrays,
                   w: jnp.ndarray) -> jnp.ndarray:
    return _residual_of_impl(kernel, ndofs, arrays, w)


def _residual_of_impl(kernel: Callable, ndofs: int, arrays: AsmArrays,
                      w: jnp.ndarray) -> jnp.ndarray:
    """One extra segment absorbs padded cells' scatter
    (pad_cells_for_chunks); padded cells read w at index ndofs via the
    safe concat below.  Cells stream through in ASM_CHUNK-sized scan
    steps: per-quadrature-point kernel intermediates over the whole mesh
    would otherwise be materialized at once.
    """
    w_ext = jnp.concatenate([w, jnp.zeros(1, w.dtype)])
    nc = arrays.cell_dofs.shape[0]

    def chunk_residual(cd, cc):
        r_e = jax.vmap(kernel)(cc, w_ext[cd])
        return jax.ops.segment_sum(
            r_e.reshape(-1), cd.reshape(-1), num_segments=ndofs + 1)

    if nc <= ASM_CHUNK:
        return chunk_residual(arrays.cell_dofs, arrays.cell_coords)[:ndofs]

    n_chunks = nc // ASM_CHUNK
    cd = arrays.cell_dofs.reshape(n_chunks, ASM_CHUNK, -1)
    cc = arrays.cell_coords.reshape(
        n_chunks, ASM_CHUNK, *arrays.cell_coords.shape[1:])

    def body(acc, inp):
        cdi, cci = inp
        return acc + chunk_residual(cdi, cci), None

    r, _ = jax.lax.scan(body, jnp.zeros(ndofs + 1, w.dtype), (cd, cc))
    return r[:ndofs]


def _cell_jacobians(kernel: Callable, cell_coords, cell_dofs, w):
    """(nc, ndl, ndl) element Jacobians.

    Uses the kernel's analytic tangent (``kernel.jac``, see
    forms/navier_stokes.py) when present — batched MXU matmuls instead of
    ndl forward tangents; falls back to vmapped jacfwd otherwise
    (the autodiff oracle the tests compare against).
    """
    w_ext = jnp.concatenate([w, jnp.zeros(1, w.dtype)])
    jac = getattr(kernel, "jac", None)
    if jac is not None:
        return jax.vmap(jac)(cell_coords, w_ext[cell_dofs])

    def cell_jac(coords, w_e):
        return jax.jacfwd(lambda ww: kernel(coords, ww))(w_e)

    return jax.vmap(cell_jac)(cell_coords, w_ext[cell_dofs])


def assemble_jacobian_chunked(
    kernel: Callable,
    n_segments: int,       # true nnz-flavored segment count (trash at end)
    bs: int,
    arrays: AsmArrays,
    w: jnp.ndarray,
) -> jnp.ndarray:
    """(bs*bs, n_segments) Jacobian values via chunked jacfwd assembly.

    Cells are processed in ASM_CHUNK-sized scan steps so the jacfwd
    tangent intermediates stay bounded; the bs^2 strided segment-sums
    avoid any (.., nbl, bs, nbl, bs) transpose.
    """
    nc = arrays.cell_dofs.shape[0]
    nbl = arrays.ell_pos.shape[1]

    def chunk_values(cd, cc, ep):
        J_e = _cell_jacobians(kernel, cc, cd, w)
        seg = ep.reshape(-1)
        outs = []
        for ci in range(bs):
            for cj in range(bs):
                Jsub = J_e[:, ci::bs, cj::bs]
                outs.append(jax.ops.segment_sum(
                    Jsub.reshape(-1), seg, num_segments=n_segments + 1))
        return jnp.stack(outs, axis=0)         # (bs*bs, n_segments+1)

    if nc <= ASM_CHUNK:
        V = chunk_values(arrays.cell_dofs, arrays.cell_coords,
                         arrays.ell_pos)
        return V[:, :n_segments]

    n_chunks = nc // ASM_CHUNK
    cd = arrays.cell_dofs.reshape(n_chunks, ASM_CHUNK, -1)
    cc = arrays.cell_coords.reshape(
        n_chunks, ASM_CHUNK, *arrays.cell_coords.shape[1:])
    ep = arrays.ell_pos.reshape(n_chunks, ASM_CHUNK, nbl, nbl)

    def body(acc, inp):
        cdi, cci, epi = inp
        return acc + chunk_values(cdi, cci, epi), None

    init = jnp.zeros((bs * bs, n_segments + 1), w.dtype)
    V, _ = jax.lax.scan(body, init, (cd, cc, ep))
    return V[:, :n_segments]


def build_gather_plan(ell_pos: np.ndarray, n_segments: int,
                      max_degA: int = 8, cover: float = 0.99):
    """Host-side gather tables that replace the Jacobian scatter-add.

    Targets the 16 strided ``segment_sum`` scatters of
    ``assemble_jacobian_chunked`` (scatter-adds with colliding indices).
    This inverts the map once per mesh:
    for every nnz segment, the (cell, a, b) contributions that land in
    it, padded to a fixed degree so the device-side reduction is a dense
    gather + sum (sequential writes, no collisions).

    Returns ``(tableA, tableB, over_ids)`` int32 arrays:
    ``tableA`` (n_segments, degA) indexes into the flat contribution
    array (K = nc*nbl*nbl; index K = an appended zero), covering every
    segment's first ``degA`` contributions; segments with higher degree
    (the node-diagonal slots — every cell incident to the node) put the
    remainder in ``tableB`` (n_over, degB) whose row sums are added at
    ``over_ids`` (unique — a permuted store, not a colliding scatter).
    ``degA`` = the ``cover`` quantile of the degree histogram, capped.
    """
    seg = np.asarray(ell_pos).reshape(-1).astype(np.int64)
    K = seg.size
    order = np.argsort(seg, kind="stable")
    counts = np.bincount(seg, minlength=n_segments + 1)[:n_segments]
    starts = np.zeros(n_segments + 1, np.int64)
    np.cumsum(counts, out=starts[1:])      # trash ids sort past the end
    degA = int(min(max(np.quantile(counts, cover), 1), max_degA))
    j = np.arange(degA, dtype=np.int64)
    idxA = starts[:n_segments, None] + j[None, :]
    valid = j[None, :] < counts[:, None]
    tableA = np.where(valid, order[np.minimum(idxA, K - 1)], K) \
        .astype(np.int32)
    over_ids = np.nonzero(counts > degA)[0]
    if len(over_ids):
        degB = int(counts[over_ids].max()) - degA
        jB = degA + np.arange(degB, dtype=np.int64)
        idxB = starts[over_ids, None] + jB[None, :]
        validB = jB[None, :] < counts[over_ids, None]
        tableB = np.where(validB, order[np.minimum(idxB, K - 1)], K) \
            .astype(np.int32)
    else:
        tableB = np.zeros((0, 1), np.int32)
    return tableA, tableB, over_ids.astype(np.int32)


def assemble_jacobian_gather(
    kernel: Callable,
    n_segments: int,
    bs: int,
    arrays: AsmArrays,
    w: jnp.ndarray,
    tableA: jnp.ndarray,
    tableB: jnp.ndarray,
    over_ids: jnp.ndarray,
) -> jnp.ndarray:
    """(bs*bs, n_segments) Jacobian values via the gather plan
    (``build_gather_plan``) — the scatter-free fast path.

    Element Jacobians are materialized chunk-by-chunk into a flat
    (nc, ndl, ndl) buffer (contiguous dynamic_update_slice writes), then
    each of the bs^2 strided sub-entries reduces by dense gather + sum.
    """
    nc = arrays.cell_dofs.shape[0]
    ndl = arrays.cell_dofs.shape[1]
    nbl = arrays.ell_pos.shape[1]
    b2 = bs * bs
    # reduce16 computes gather offsets as int32 id*b2: guard the padded
    # contribution count (the appended trash block sits at K = nc*nbl*nbl)
    assert (nc * nbl * nbl + 1) * b2 < 2**31, (
        "gather-plan int32 offset overflow: nc*nbl^2*bs^2 exceeds 2^31 "
        f"(nc={nc}, nbl={nbl}, bs={bs}) — premultiply on host in int64")
    # the chunked scan below silently drops trailing cells otherwise;
    # callers pad (pad_cells_for_chunks) — make the contract explicit
    assert nc <= ASM_CHUNK or nc % ASM_CHUNK == 0, (
        f"cell arrays must be padded to a multiple of ASM_CHUNK "
        f"({ASM_CHUNK}); got nc={nc}")

    def chunk_blocks(cci, cdi):
        # (ch, ndl, ndl) -> contribution-major flat (ch*nbl*nbl*b2,):
        # contribution (c, a, b) carries its b2 (ci, cj) entries
        # CONTIGUOUSLY, so the reduction below gathers 64-byte slices
        # instead of 4-byte elements (measured 0.75x -> see bench)
        J = _cell_jacobians(kernel, cci, cdi, w)
        ch = J.shape[0]
        J5 = J.reshape(ch, nbl, bs, nbl, bs).transpose(0, 1, 3, 2, 4)
        return J5.reshape(ch * nbl * nbl * b2)

    if nc <= ASM_CHUNK:
        Jflat = chunk_blocks(arrays.cell_coords, arrays.cell_dofs)
    else:
        n_chunks = nc // ASM_CHUNK
        cd = arrays.cell_dofs.reshape(n_chunks, ASM_CHUNK, -1)
        cc = arrays.cell_coords.reshape(
            n_chunks, ASM_CHUNK, *arrays.cell_coords.shape[1:])
        csz = ASM_CHUNK * nbl * nbl * b2
        offs = jnp.arange(n_chunks, dtype=jnp.int32) * csz

        def body(buf, inp):
            cdi, cci, off = inp
            return jax.lax.dynamic_update_slice(
                buf, chunk_blocks(cci, cdi), (off,)), None

        Jflat, _ = jax.lax.scan(
            body, jnp.zeros(nc * nbl * nbl * b2, w.dtype), (cd, cc, offs))

    # trash contribution id K -> an appended zero block
    Jflat = jnp.concatenate([Jflat, jnp.zeros(b2, w.dtype)])
    dnums = jax.lax.GatherDimensionNumbers(
        offset_dims=(1,), collapsed_slice_dims=(), start_index_map=(0,))

    def reduce16(tab):
        idx = (tab.astype(jnp.int32) * b2).reshape(-1, 1)
        g = jax.lax.gather(Jflat, idx, dnums, slice_sizes=(b2,))
        return g.reshape(tab.shape[0], tab.shape[1], b2).sum(axis=1)

    V16 = reduce16(tableA)                       # (n_segments, b2)
    if tableB.shape[0] > 0:
        V16 = V16.at[over_ids].add(reduce16(tableB), unique_indices=True)
    # (b2, n_segments) with entry index ci*bs+cj, matching the scatter
    # path's stacking order
    return V16.T


def matrix_values_of(kernel: Callable, nnzb: int, bs: int,
                     arrays: AsmArrays, w: jnp.ndarray) -> jnp.ndarray:
    """Block-CSR values of dr/dw at w: (nnzb, bs, bs).

    ElementKernel pytrees enter the jit dynamically (see residual_of)."""
    if isinstance(kernel, ElementKernel):
        return _matrix_values_of_p(kernel, nnzb, bs, arrays, w)
    return _matrix_values_of_s(kernel, nnzb, bs, arrays, w)


@partial(jax.jit, static_argnums=(1, 2))
def _matrix_values_of_p(kernel, nnzb: int, bs: int,
                        arrays: AsmArrays, w: jnp.ndarray) -> jnp.ndarray:
    V = assemble_jacobian_chunked(kernel, nnzb, bs, arrays, w)
    return V.T.reshape(nnzb, bs, bs)


@partial(jax.jit, static_argnums=(0, 1, 2))
def _matrix_values_of_s(kernel: Callable, nnzb: int, bs: int,
                        arrays: AsmArrays, w: jnp.ndarray) -> jnp.ndarray:
    V = assemble_jacobian_chunked(kernel, nnzb, bs, arrays, w)
    # (bs*bs, nnzb) -> (nnzb, bs, bs)
    return V.T.reshape(nnzb, bs, bs)


def bcsr_matvec(arrays: AsmArrays, n_rows: int, values: jnp.ndarray,
                x: jnp.ndarray) -> jnp.ndarray:
    """y = A x with A in block-CSR. Safe to call inside jit."""
    bs = values.shape[-1]
    xb = x.reshape(-1, bs)
    contrib = jnp.einsum("nij,nj->ni", values, xb[arrays.indices],
                         preferred_element_type=values.dtype)
    yb = jax.ops.segment_sum(contrib, arrays.row_ids, num_segments=n_rows)
    return yb.reshape(-1)


# ----------------------------------------------------------------------------
# Assembler — binds a space to its pattern/arrays, offers convenience API
# ----------------------------------------------------------------------------


class Assembler:
    def __init__(
        self,
        cell_dofs: np.ndarray,
        cell_coords: np.ndarray,
        ndofs: int,
        pattern: BlockPattern,
        dtype=None,
    ):
        if dtype is None:
            dtype = jnp.zeros(0).dtype
        self.ndofs = int(ndofs)
        self.dtype = dtype
        self.pattern = pattern
        cd_p, cc_p, ep_p = pad_cells_for_chunks(
            np.asarray(cell_dofs, np.int32), np.asarray(cell_coords),
            pattern.ell_pos, self.ndofs, pattern.nnzb)
        self.arrays = AsmArrays(
            cell_dofs=jnp.asarray(cd_p, jnp.int32),
            cell_coords=jnp.asarray(cc_p, dtype),
            indices=jnp.asarray(pattern.indices, jnp.int32),
            row_ids=jnp.asarray(pattern.row_ids, jnp.int32),
            ell_pos=jnp.asarray(ep_p, jnp.int32),
            diag_pos=jnp.asarray(pattern.diag_pos, jnp.int32),
        )

    # -- eager convenience (each call jit-cached by kernel identity) -------
    def residual(self, kernel: Callable, w: jnp.ndarray) -> jnp.ndarray:
        return residual_of(kernel, self.ndofs, self.arrays, w)

    def matrix_values(self, kernel: Callable, w: jnp.ndarray) -> jnp.ndarray:
        return matrix_values_of(
            kernel, self.pattern.nnzb, self.pattern.bs, self.arrays, w)

    def matvec(self, values: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
        return bcsr_matvec(self.arrays, self.pattern.n_rows, values, x)

    def diag_blocks(self, values: jnp.ndarray) -> jnp.ndarray:
        return values[self.arrays.diag_pos]

    # -- BC-aware wrappers ---------------------------------------------------
    def bc_operator(self, values: jnp.ndarray, mask: jnp.ndarray) -> Callable:
        """A_bc(x) = P A P x + (I - P) x (rows+cols projected)."""

        def op(x):
            return mask * self.matvec(values, mask * x) + (1.0 - mask) * x

        return op

    def bc_residual(self, kernel, w, mask, g) -> jnp.ndarray:
        """Residual with Dirichlet rows replaced by (w - g)."""
        r = self.residual(kernel, w)
        return mask * r + (1.0 - mask) * (w - g)

    def linear_system(
        self, kernel: Callable, bc: DirichletBC,
    ) -> Tuple[jnp.ndarray, Callable, jnp.ndarray, jnp.ndarray]:
        """For affine kernels: (values, A_bc, b_bc, mask).

        Solves of A_bc x = b_bc satisfy the BC exactly and the weak form on
        free dofs (same solution as dolfinx LinearProblem with lifting,
        reference NavierStokesChannelFlow.py:197-218).
        """
        zero = jnp.zeros(self.ndofs, self.dtype)
        values = self.matrix_values(kernel, zero)
        b = -self.residual(kernel, zero)
        mask = jnp.asarray(bc_mask(self.ndofs, bc), self.dtype)
        g = jnp.asarray(bc_vector(self.ndofs, bc), self.dtype)
        b_bc = mask * (b - self.matvec(values, g)) + g
        return values, self.bc_operator(values, mask), b_bc, mask


def assembler_for_mixed(space: MixedVelocityPressureSpace, dtype=None) -> Assembler:
    mesh = space.mesh
    coords = mesh.points[mesh.cells]
    if space.equal_order:
        pattern = build_pattern(
            space.V.cell_dofs_scalar, space.V.n_scalar_dofs, space.block_size)
    else:
        pattern = build_pattern(space.cell_dofs_w, space.ndofs, 1)
    return Assembler(space.cell_dofs_w, coords, space.ndofs, pattern, dtype)


def assembler_for_space(fs: FunctionSpace, dtype=None) -> Assembler:
    mesh = fs.mesh
    coords = mesh.points[mesh.cells]
    cd = fs.cell_dofs()
    pattern = build_pattern(fs.cell_dofs_scalar, fs.n_scalar_dofs, fs.vs)
    return Assembler(cd, coords, fs.ndofs, pattern, dtype)
