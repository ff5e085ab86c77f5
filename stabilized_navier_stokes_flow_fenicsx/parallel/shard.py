"""Multi-chip element sharding over a jax.sharding.Mesh.

Replacement for the reference's MPI domain decomposition
(SURVEY.md 2.3): DOLFINx partitions the mesh across ranks and exchanges
ghost dofs inside PETSc (reference NavierStokesChannelFlow.py:111,
:57-66).  Here the *elements* (and the matrix nonzeros) are sharded across
the device mesh axis; dof vectors stay replicated, and the ghost
ADD/REVERSE update becomes a single ``psum`` over ICI after each shard's
segment_sum.  No point-to-point, no ghost bookkeeping: the halo exchange
is the all-reduce the hardware is best at.

Padding scheme: cells (and nnz blocks) are padded to a multiple of the
device count; padded cells scatter into one extra dof/row segment that is
sliced off, and use copies of cell 0's coordinates so geometry stays
finite.
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..assemble.assembly import Assembler, AsmArrays
from ..solve.newton import NewtonResult, newton_solve
from ..solve.precond import block_jacobi


class ShardedArrays(NamedTuple):
    """AsmArrays padded + sharded along the cell / nnz axes."""

    cell_dofs: jnp.ndarray       # (nc_pad, ndl) -> P('cells')
    cell_coords: jnp.ndarray     # (nc_pad, nv, gdim) -> P('cells')
    ell_pos: jnp.ndarray         # (nc_pad, nbl, nbl) -> P('cells')
    indices: jnp.ndarray         # (nnzb_pad,) -> P('cells')
    row_ids: jnp.ndarray         # (nnzb_pad,) -> P('cells')
    diag_pos: jnp.ndarray        # (n_rows,) replicated


@dataclasses.dataclass
class ShardedProblem:
    mesh: Mesh
    arrays: ShardedArrays
    ndofs: int
    nnzb: int
    nnzb_pad: int
    bs: int
    n_rows: int
    axis: str = "cells"


def _pad_to(x: np.ndarray, n: int, fill) -> np.ndarray:
    pad = n - x.shape[0]
    if pad == 0:
        return x
    if np.isscalar(fill):
        tile = np.full((pad,) + x.shape[1:], fill, dtype=x.dtype)
    else:
        tile = np.broadcast_to(fill, (pad,) + x.shape[1:]).astype(x.dtype)
    return np.concatenate([x, tile], axis=0)


def make_sharded_problem(
    asm: Assembler, mesh: Mesh, axis: str = "cells"
) -> ShardedProblem:
    """Shard an Assembler's arrays over the device mesh axis."""
    nd = mesh.shape[axis]
    a = asm.arrays
    nc = a.cell_dofs.shape[0]
    nnzb = asm.pattern.nnzb
    nc_pad = -(-nc // nd) * nd
    nnzb_pad = -(-nnzb // nd) * nd

    cd = np.asarray(a.cell_dofs)
    cc = np.asarray(a.cell_coords)
    ep = np.asarray(a.ell_pos)
    # padded cells scatter into the extra dof segment (ndofs) and the
    # extra nnz segment (nnzb); coords copy cell 0 (finite geometry)
    cd_p = _pad_to(cd, nc_pad, np.int32(asm.ndofs))
    cc_p = _pad_to(cc, nc_pad, cc[0])
    ep_p = _pad_to(ep, nc_pad, np.int32(nnzb))
    idx_p = _pad_to(np.asarray(a.indices), nnzb_pad, np.int32(0))
    row_p = _pad_to(np.asarray(a.row_ids), nnzb_pad,
                    np.int32(asm.pattern.n_rows))

    shard = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())
    arrays = ShardedArrays(
        cell_dofs=jax.device_put(cd_p, shard),
        cell_coords=jax.device_put(cc_p, shard),
        ell_pos=jax.device_put(ep_p, shard),
        indices=jax.device_put(idx_p, shard),
        row_ids=jax.device_put(row_p, shard),
        diag_pos=jax.device_put(np.asarray(a.diag_pos), repl),
    )
    return ShardedProblem(
        mesh=mesh, arrays=arrays, ndofs=asm.ndofs, nnzb=nnzb,
        nnzb_pad=nnzb_pad, bs=asm.pattern.bs, n_rows=asm.pattern.n_rows,
        axis=axis)


# ---- sharded assembly/SpMV primitives (run inside shard_map) --------------


def _local_residual(kernel, ndofs, cell_dofs, cell_coords, w, axis):
    w_ext = jnp.concatenate([w, jnp.zeros(1, w.dtype)])
    w_e = w_ext[cell_dofs]
    r_e = jax.vmap(kernel)(cell_coords, w_e)
    r = jax.ops.segment_sum(
        r_e.reshape(-1), cell_dofs.reshape(-1), num_segments=ndofs + 1)
    return jax.lax.psum(r[:ndofs], axis)


def _local_jac_values(kernel, nnzb_true, nnzb_pad, bs, nbl, cell_dofs,
                      cell_coords, w, ell_pos, axis):
    """Replicated, psum'd block values padded to nnzb_pad (zeros beyond).

    Assembled with bs^2 strided segment-sums (no 5D transpose).
    """
    w_ext = jnp.concatenate([w, jnp.zeros(1, w.dtype)])
    jac = getattr(kernel, "jac", None)

    def cell_jac(coords, w_e):
        return jax.jacfwd(lambda ww: kernel(coords, ww))(w_e)

    J_e = jax.vmap(jac if jac is not None else cell_jac)(
        cell_coords, w_ext[cell_dofs])
    seg = ell_pos.reshape(-1)
    outs = []
    for ci in range(bs):
        for cj in range(bs):
            outs.append(jax.ops.segment_sum(
                J_e[:, ci::bs, cj::bs].reshape(-1), seg,
                num_segments=nnzb_pad + 1))
    v = jnp.stack(outs, axis=-1).reshape(nnzb_pad + 1, bs, bs)
    # segment nnzb_true absorbs the padded cells' scatter; clear it
    v = v.at[nnzb_true].set(0.0)   # OOB scatter drops when true == pad
    return jax.lax.psum(v[:nnzb_pad], axis)


def _local_matvec(n_rows, values_pad, indices, row_ids, x, axis):
    """SpMV with nnz work sharded: each device handles its slice of the
    (padded) nnz axis, taking the matching slice of the replicated values.
    """
    bs = values_pad.shape[-1]
    sz = indices.shape[0]                      # local shard length
    my = jax.lax.axis_index(axis)
    zero = jnp.zeros((), my.dtype)
    vloc = jax.lax.dynamic_slice(
        values_pad, (my * sz, zero, zero), (sz, bs, bs))
    xb = x.reshape(-1, bs)
    contrib = jnp.einsum("nij,nj->ni", vloc, xb[indices],
                         preferred_element_type=values_pad.dtype)
    yb = jax.ops.segment_sum(contrib, row_ids, num_segments=n_rows + 1)
    return jax.lax.psum(yb[:n_rows].reshape(-1), axis)


def sharded_newton(
    prob: ShardedProblem,
    kernel: Callable,
    mask: jnp.ndarray,
    g: jnp.ndarray,
    w0: jnp.ndarray,
    rtol: float = 1e-8,
    atol: float = 1e-8,
    max_it: int = 30,
    ksp_rtol: float = 1e-8,
    ksp_restart: int = 50,
    ksp_max_restarts: int = 40,
) -> NewtonResult:
    """Full Newton solve with element-sharded assembly and nnz-sharded SpMV.

    The entire iteration runs inside one shard_map region: every device
    executes the (replicated) Krylov vector algebra and contributes its
    element/nnz shard through psums.
    """
    ax = prob.axis
    nbl = prob.arrays.ell_pos.shape[1]
    ndofs, nnzb, bs, n_rows = prob.ndofs, prob.nnzb, prob.bs, prob.n_rows
    nnzb_pad = prob.nnzb_pad

    @partial(
        jax.shard_map,
        mesh=prob.mesh,
        in_specs=(ShardedArrays(P(ax), P(ax), P(ax), P(ax), P(ax), P()),
                  P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(arrays, mask_, g_, w0_):
        def residual(w):
            r = _local_residual(kernel, ndofs, arrays.cell_dofs,
                                arrays.cell_coords, w, ax)
            return mask_ * r + (1.0 - mask_) * (w - g_)

        def jac_values(w):
            return _local_jac_values(
                kernel, nnzb, nnzb_pad, bs, nbl, arrays.cell_dofs,
                arrays.cell_coords, w, arrays.ell_pos, ax)

        def make_op(values):
            def op(x):
                ax_y = _local_matvec(n_rows, values, arrays.indices,
                                     arrays.row_ids, mask_ * x, ax)
                return mask_ * ax_y + (1.0 - mask_) * x
            return op

        def make_pc(values):
            return block_jacobi(values[arrays.diag_pos], mask_)

        return newton_solve(
            residual, jac_values, make_op, make_pc, w0_,
            rtol=rtol, atol=atol, max_it=max_it, ksp_rtol=ksp_rtol,
            ksp_restart=ksp_restart, ksp_max_restarts=ksp_max_restarts)

    return run(prob.arrays, mask, g, w0)


# ---- row-partitioned dof vectors via the GSPMD partitioner -----------------


@functools.lru_cache(maxsize=None)
def _spmd_newton_jit(device_mesh: Mesh, axis: str, ndofs: int, nnzb: int,
                     bs: int, n_rows: int, tol_items: tuple):
    from ..solve.driver import solve_newton_bcsr

    vs = NamedSharding(device_mesh, P(axis))
    repl = NamedSharding(device_mesh, P())
    tols = dict(tol_items)
    out_sh = NewtonResult(x=vs, iters=repl, resnorm=repl, converged=repl,
                          history=repl, stalled=repl)

    def run(kernel, arrays, mask, g, w0):
        return solve_newton_bcsr(kernel, ndofs, nnzb, bs, n_rows,
                                 arrays, mask, g, w0, **tols)

    return jax.jit(run, out_shardings=out_sh)


def _pad_axis(x: np.ndarray, n: int, fill) -> np.ndarray:
    return _pad_to(np.asarray(x), n, fill)


def spmd_pad_problem(asm: Assembler, n_devices: int):
    """Pad a BCSR problem so every explicitly-sharded axis divides the
    device count: dofs are extended with Dirichlet identity rows pinned
    to 0 (the layered path's plane-padding trick, layered_shard.py),
    nnz entries with trash blocks scattering into a padded (masked)
    row, cells with the existing trash-cell scheme.  Returns
    (AsmArrays_padded, ndofs_pad, nnzb_pad, n_rows_pad).

    The padded statics are safe with the unmodified assembly/matvec:
    trash cells still gather/scatter at index ``asm.ndofs`` — now a
    real, masked, zero-pinned row instead of the sliced-off extra
    segment — and trash nnz blocks carry garbage values whose rows the
    BC mask annihilates (solve/driver.py::_bc_op).
    """
    from ..assemble.assembly import ASM_CHUNK

    D = int(n_devices)
    bs = asm.pattern.bs
    a = asm.arrays
    unit = bs * D                       # ndofs_pad % D == n_rows_pad % D == 0
    ndofs_pad = -(-(asm.ndofs + 1) // unit) * unit
    n_rows_pad = ndofs_pad // bs
    nnzb_pad = -(-asm.pattern.nnzb // D) * D
    nc = a.cell_dofs.shape[0]
    cunit = np.lcm(ASM_CHUNK, D) if nc > ASM_CHUNK else D
    nc_pad = -(-nc // cunit) * cunit
    cc = np.asarray(a.cell_coords)
    arrays = AsmArrays(
        cell_dofs=jnp.asarray(_pad_axis(a.cell_dofs, nc_pad,
                                        np.int32(asm.ndofs))),
        cell_coords=jnp.asarray(_pad_axis(cc, nc_pad, cc[0])),
        indices=jnp.asarray(_pad_axis(a.indices, nnzb_pad, np.int32(0))),
        row_ids=jnp.asarray(_pad_axis(a.row_ids, nnzb_pad,
                                      np.int32(asm.pattern.n_rows))),
        ell_pos=jnp.asarray(_pad_axis(a.ell_pos, nc_pad,
                                      np.int32(asm.pattern.nnzb))),
        diag_pos=jnp.asarray(_pad_axis(a.diag_pos, n_rows_pad,
                                       np.int32(0))),
    )
    return arrays, ndofs_pad, nnzb_pad, n_rows_pad


def spmd_newton_bcsr(
    asm: Assembler,
    kernel: Callable,
    mask,
    g,
    w0,
    device_mesh: Mesh,
    axis: str = "dofs",
    **tols,
) -> NewtonResult:
    """Newton with ROW-PARTITIONED dof vectors on the generic BCSR path.

    ``sharded_newton`` above divides the element/nnz work but replicates
    every dof vector (fine to ~8 chips; the vector memory axis caps
    scaling beyond that).  This entry point is the scaling-book recipe
    instead: annotate shardings and let the GSPMD partitioner insert the
    collectives.  Dof vectors (w, mask, g — and, by propagation, the
    Krylov basis, the dominant vector memory at restart 50) are sharded
    ``P(axis)``; cell/nnz arrays shard on their leading axes; XLA
    inserts the all-gather feeding the per-cell dof gather,
    reduce-scatters the segment-summed rows, and turns Krylov
    dots/norms into psums.  No shard_map, no hand-written collectives.
    The result's ``x`` is forced row-partitioned via ``out_shardings``
    and has ``ndofs_pad`` entries — slice ``[:asm.ndofs]`` for the
    solution (padded rows are Dirichlet-pinned zeros).

    Replacement for the reference's distributed PETSc Vec
    ownership (reference NavierStokesChannelFlow.py:111, :153-154 —
    each MPI rank owns a contiguous dof range) on unstructured meshes;
    the extruded-channel flagship path has its own hand-sharded variant
    (parallel/layered_shard.py) where the plane structure makes the
    halo a single ppermute.
    """
    D = device_mesh.shape[axis]
    arrays_np, ndofs_pad, nnzb_pad, n_rows_pad = spmd_pad_problem(asm, D)
    vs = NamedSharding(device_mesh, P(axis))
    cs = NamedSharding(device_mesh, P(axis))
    arrays = AsmArrays(
        cell_dofs=jax.device_put(arrays_np.cell_dofs, cs),
        cell_coords=jax.device_put(arrays_np.cell_coords, cs),
        indices=jax.device_put(arrays_np.indices, cs),
        row_ids=jax.device_put(arrays_np.row_ids, cs),
        ell_pos=jax.device_put(arrays_np.ell_pos, cs),
        diag_pos=jax.device_put(arrays_np.diag_pos, vs),
    )
    pad = ndofs_pad - asm.ndofs

    def pad_vec(v):
        v = np.asarray(v)
        return jax.device_put(jnp.asarray(np.concatenate(
            [v, np.zeros(pad, v.dtype)])), vs)

    run = _spmd_newton_jit(
        device_mesh, axis, ndofs_pad, nnzb_pad, asm.pattern.bs,
        n_rows_pad, tuple(sorted(tols.items())))
    return run(kernel, arrays, pad_vec(mask), pad_vec(g), pad_vec(w0))
