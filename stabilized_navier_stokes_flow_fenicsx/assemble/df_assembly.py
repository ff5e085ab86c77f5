"""Compensated (two-f32) global residual assembly.

The f32 segment-sum assembly (assembly.py::residual_of) measures residuals
no finer than ~1e-6 relative: at convergence the O(1) element
contributions cancel almost exactly, so each contribution's f32 rounding
(~6e-8 absolute) dominates the tiny true residual.  This module assembles
in double-float:

* element residuals come from a df kernel (forms/navier_stokes_df.py),
* the duplicate-dof reduction is a *gather*-based ELL sum — for each dof a
  padded list of (cell, local-slot) positions, reduced sequentially with
  compensated adds (scatter/segment_sum cannot carry compensation) —
  replacing the ghost ADD/REVERSE update of the reference's assembly
  (reference NavierStokes/NavierStokesChannelFlow.py:57-66) with a
  deterministic, exactly-rounded reduction.

Used by the iterative-refinement Newton (solve/refine.py) to reach SNES
rtol=atol=1e-8 (reference NavierStokesChannelFlow.py:281-283) from an f32
solve.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.dfloat import DF, df_add, df_mul


class DFArrays(NamedTuple):
    """Compensated-assembly data, threaded through jit as arguments."""

    cell_dofs: jnp.ndarray      # (nc, ndl) int32, padded to chunk multiple
    coords_hi: jnp.ndarray      # (nc, nv, gdim) f32
    coords_lo: jnp.ndarray      # (nc, nv, gdim) f32  (f64 - hi)
    gather: jnp.ndarray         # (ndofs, maxinc) int32


def build_gather_map(cell_dofs: np.ndarray, ndofs: int) -> np.ndarray:
    """(ndofs, maxinc) int32 positions into the flattened (nc*ndl,)
    element-residual array; pad entries point at the appended zero slot
    nc*ndl.  Entries with dof == ndofs (chunk padding) are dropped."""
    nc, ndl = cell_dofs.shape
    flat = np.asarray(cell_dofs, np.int64).ravel()
    valid = flat < ndofs
    pos = np.nonzero(valid)[0]
    d = flat[valid]
    order = np.argsort(d, kind="stable")
    d_s = d[order]
    pos_s = pos[order]
    counts = np.bincount(d_s, minlength=ndofs)
    maxinc = int(counts.max())
    starts = np.concatenate([[0], np.cumsum(counts)])
    gather = np.full((ndofs, maxinc), nc * ndl, np.int64)
    offsets = np.arange(len(d_s)) - starts[d_s]
    gather[d_s, offsets] = pos_s
    assert nc * ndl < 2**31
    return gather.astype(np.int32)


def split_coords(coords64: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Exact hi/lo split of f64 coordinates into two f32 arrays, so the
    df kernel sees the *f64 mesh*, not an f32-rounded one."""
    hi = coords64.astype(np.float32)
    lo = (coords64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


@partial(jax.jit, static_argnums=(1,))
def df_residual_of(
    kernel_df: Callable,
    ndofs: int,
    dfa: DFArrays,
    w: DF,
) -> DF:
    """Global df residual r(w) — no BC substitution.

    kernel_df is an ElementKernel pytree (utils/kernelbase.py): a
    DYNAMIC jit argument, so the nu-derived hi/lo split leaves are
    traced and one refine program serves the whole Re sweep."""
    cell_dofs, coords_hi, coords_lo, gather = dfa
    zero1 = jnp.zeros(1, w.hi.dtype)
    whi_ext = jnp.concatenate([w.hi, zero1])
    wlo_ext = jnp.concatenate([w.lo, zero1])
    nc, ndl = cell_dofs.shape
    chunk = _chunk_for(nc)
    n_chunks = nc // chunk

    def chunk_r(cd, chi, clo):
        w_e = DF(whi_ext[cd], wlo_ext[cd])
        return jax.vmap(kernel_df)(DF(chi, clo), w_e)

    if n_chunks <= 1:
        r_e = chunk_r(cell_dofs, coords_hi, coords_lo)
        flat_hi = r_e.hi.reshape(-1)
        flat_lo = r_e.lo.reshape(-1)
    else:
        cd3 = cell_dofs.reshape(n_chunks, chunk, ndl)
        ch3 = coords_hi.reshape(n_chunks, chunk, *coords_hi.shape[1:])
        cl3 = coords_lo.reshape(n_chunks, chunk, *coords_lo.shape[1:])

        def body(_, inp):
            r = chunk_r(*inp)
            return None, (r.hi, r.lo)

        _, (his, los) = jax.lax.scan(body, None, (cd3, ch3, cl3))
        flat_hi = his.reshape(-1)
        flat_lo = los.reshape(-1)

    flat_hi = jnp.concatenate([flat_hi, zero1])
    flat_lo = jnp.concatenate([flat_lo, zero1])

    gT = gather.T                      # (maxinc, ndofs)
    maxinc = gT.shape[0]
    zeros = jnp.zeros(ndofs, w.hi.dtype)

    def red(k, acc):
        idx = gT[k]
        return df_add(acc, DF(flat_hi[idx], flat_lo[idx]))

    return jax.lax.fori_loop(0, maxinc, red, DF(zeros, zeros))


def _chunk_for(nc: int, target: int = 32768) -> int:
    """Largest divisor of nc that is <= target (arrays are pre-padded to a
    multiple of the assembler chunk, so this normally returns target)."""
    if nc <= target:
        return nc
    for c in range(target, 0, -1):
        if nc % c == 0:
            return c
    return nc


class DFResidual:
    """Binds a mixed space + df kernel into a jitted compensated residual
    with SNES-style BC row substitution (rows -> w - g)."""

    def __init__(self, space, kernel_df: Callable, chunk: int = 32768):
        mesh = space.mesh
        cd = np.asarray(space.cell_dofs_w, np.int32)
        coords64 = np.asarray(mesh.points, np.float64)[mesh.cells]
        nc = cd.shape[0]
        self.ndofs = int(space.ndofs)
        if nc > chunk:
            nc_pad = -(-nc // chunk) * chunk
            pad = nc_pad - nc
            if pad:
                cd = np.concatenate(
                    [cd, np.full((pad, cd.shape[1]), self.ndofs, np.int32)])
                coords64 = np.concatenate(
                    [coords64,
                     np.broadcast_to(coords64[0],
                                     (pad,) + coords64.shape[1:])])
        hi, lo = split_coords(coords64)
        self.dfa = DFArrays(
            cell_dofs=jnp.asarray(cd),
            coords_hi=jnp.asarray(hi),
            coords_lo=jnp.asarray(lo),
            gather=jnp.asarray(build_gather_map(cd, self.ndofs)))
        self.kernel_df = kernel_df

    def raw(self, w: DF) -> DF:
        return df_residual_of(self.kernel_df, self.ndofs, self.dfa, w)

    def bc_residual(self, w: DF, mask: jnp.ndarray, g: DF) -> DF:
        r = self.raw(w)
        wm = df_add(w, -g)
        one_m = (1.0 - mask)
        return df_add(df_mul(r, DF(mask, jnp.zeros_like(mask))),
                      df_mul(wm, DF(one_m, jnp.zeros_like(one_m))))
