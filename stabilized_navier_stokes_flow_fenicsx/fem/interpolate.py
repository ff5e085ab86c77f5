"""Point location + P1 interpolation on simplex meshes.

Replacement for two DOLFINx facilities (SURVEY.md 2.2):

* non-matching interpolation with padding=1e-6 — 2D inlet profiles onto 3D
  inlet facet dofs and coarse->fine solution transfer (reference
  NavierStokes/NavierStokesChannelFlow.py:150-157, 175-194);
* the bounding-box-tree point lookup + ``uh.eval`` pair that the
  streamtracer calls per RK stage (reference streamtrace.py:144-157).

Instead of a bb-tree (pointer-chasing, vmap-hostile), cells are binned
into a uniform grid over the mesh bbox.  The grid is built host-side in
numpy; queries run either in numpy (setup-time interpolation) or as pure
jnp gather/where pipelines (the vmapped streamtracer) from the same padded
arrays.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..mesh.core import SimplexMesh


@dataclasses.dataclass
class GridLocator:
    """Uniform-grid cell locator over a simplex mesh (dim = 2 or 3)."""

    dim: int
    lo: np.ndarray              # (dim,)
    inv_h: np.ndarray           # (dim,)
    shape: Tuple[int, ...]      # bins per axis
    bin_start: np.ndarray       # (n_bins+1,) CSR offsets
    bin_cells: np.ndarray       # (total,) cell ids sorted by bin
    max_per_bin: int
    # mesh data for barycentric tests
    x0: np.ndarray              # (nc, dim) first vertex
    Tinv: np.ndarray            # (nc, dim, dim) inverse edge matrix
    cells: np.ndarray           # (nc, dim+1)

    @property
    def n_bins(self) -> int:
        return int(np.prod(self.shape))


def build_locator(mesh: SimplexMesh, bins_per_axis: Optional[int] = None
                  ) -> GridLocator:
    pts = mesh.points[:, : mesh.dim]
    cells = mesh.cells
    nc = cells.shape[0]
    dim = mesh.dim
    lo = pts.min(axis=0)
    hi = pts.max(axis=0)
    span = np.maximum(hi - lo, 1e-12)
    if bins_per_axis is None:
        # bin edge ~ 1 mean cell size per axis: keeps max_per_bin small
        # (the padded candidate tables scale query memory by max_per_bin)
        vol = float(np.prod(span))
        h_mean = (vol / max(nc, 1)) ** (1 / dim)
        shape = tuple(
            int(np.clip(np.ceil(span[d] / h_mean), 1, 512))
            for d in range(dim))
    else:
        shape = tuple(
            max(1, min(bins_per_axis,
                       int(np.ceil(bins_per_axis * span[d] / span.max()))))
            for d in range(dim))
    h = span / np.array(shape)
    inv_h = 1.0 / h

    cp = pts[cells]                                  # (nc, nv, dim)
    cmin = ((cp.min(axis=1) - lo) * inv_h).astype(np.int64)
    cmax = ((cp.max(axis=1) - lo) * inv_h).astype(np.int64)
    cmin = np.clip(cmin, 0, np.array(shape) - 1)
    cmax = np.clip(cmax, 0, np.array(shape) - 1)

    pair_bins = []
    pair_cells = []
    # enumerate covered bins per cell (cells span few bins; loop over offsets)
    spans = cmax - cmin
    max_span = spans.max(axis=0)
    for off in np.ndindex(*(max_span + 1)):
        off = np.array(off)
        ok = (off <= spans).all(axis=1)
        idx = cmin[ok] + off
        flat = np.ravel_multi_index(idx.T, shape)
        pair_bins.append(flat)
        pair_cells.append(np.nonzero(ok)[0])
    bins = np.concatenate(pair_bins)
    cls = np.concatenate(pair_cells)
    order = np.argsort(bins, kind="stable")
    bins = bins[order]
    cls = cls[order].astype(np.int32)
    n_bins = int(np.prod(shape))
    start = np.zeros(n_bins + 1, dtype=np.int64)
    np.add.at(start, bins + 1, 1)
    start = np.cumsum(start)
    max_per_bin = int(np.diff(start).max()) if len(cls) else 1

    E = cp[:, 1 : dim + 1, :] - cp[:, 0:1, :]        # (nc, dim, dim) rows=edges
    Tinv = np.linalg.inv(np.transpose(E, (0, 2, 1)))  # inverse of column mat
    return GridLocator(
        dim=dim, lo=lo, inv_h=inv_h, shape=shape,
        bin_start=start, bin_cells=cls, max_per_bin=max_per_bin,
        x0=cp[:, 0, :].copy(), Tinv=Tinv, cells=cells)


def _candidates_np(loc: GridLocator, q: np.ndarray) -> np.ndarray:
    """Padded candidate cells per query point, -1 padded: (nq, max_per_bin)."""
    idx = ((q - loc.lo) * loc.inv_h).astype(np.int64)
    idx = np.clip(idx, 0, np.array(loc.shape) - 1)
    flat = np.ravel_multi_index(idx.T, loc.shape)
    s = loc.bin_start[flat]
    e = loc.bin_start[flat + 1]
    n = len(q)
    out = np.full((n, loc.max_per_bin), -1, dtype=np.int32)
    for k in range(loc.max_per_bin):
        has = s + k < e
        out[has, k] = loc.bin_cells[(s + k)[has]]
    return out


def locate_np(loc: GridLocator, q: np.ndarray, tol: float = 1e-6
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Find containing cells (or -1) and barycentric coords for points.

    tol plays the role of dolfinx's interpolation ``padding``
    (NavierStokesChannelFlow.py:155): points within tol of a cell count
    as inside.
    """
    q = np.asarray(q, dtype=np.float64)[:, : loc.dim]
    cand = _candidates_np(loc, q)                    # (nq, K)
    K = cand.shape[1]
    safe = np.maximum(cand, 0)
    rel = q[:, None, :] - loc.x0[safe]               # (nq, K, dim)
    lam = np.einsum("nkij,nkj->nki", loc.Tinv[safe], rel)  # (nq, K, dim)
    lam0 = 1.0 - lam.sum(axis=2)
    allbar = np.concatenate([lam0[:, :, None], lam], axis=2)  # (nq,K,dim+1)
    valid = (cand >= 0) & (allbar.min(axis=2) >= -tol)
    first = np.argmax(valid, axis=1)
    found = valid.any(axis=1)
    cell = np.where(found, cand[np.arange(len(q)), first], -1)
    bary = allbar[np.arange(len(q)), first]
    return cell.astype(np.int32), bary


def interpolate_p1_np(
    mesh: SimplexMesh,
    values: np.ndarray,
    q: np.ndarray,
    loc: Optional[GridLocator] = None,
    fill: float = 0.0,
    tol: float = 1e-6,
) -> np.ndarray:
    """Evaluate a P1 field (nodal values, possibly vector) at points."""
    if loc is None:
        loc = build_locator(mesh)
    cell, bary = locate_np(loc, q, tol)
    vals = np.asarray(values)
    vcell = vals[mesh.cells[np.maximum(cell, 0)]]    # (nq, nv, ...) nodal
    out = np.einsum("nv,nv...->n...", bary, vcell)
    if out.ndim == 1:
        return np.where(cell >= 0, out, fill)
    return np.where((cell >= 0)[:, None], out, fill)


# ---- jnp query path (used by the vmapped streamtracer) --------------------


@partial(jax.tree_util.register_dataclass,
         data_fields=["lo", "inv_h", "table", "x0", "Tinv", "cells"],
         meta_fields=["dim", "shape"])
@dataclasses.dataclass
class DeviceLocator:
    """GridLocator data as jnp arrays + a padded per-bin candidate table.

    The CSR bin lists are densified to (n_bins, max_per_bin) so a query is
    three gathers and a vectorized barycentric test — no data-dependent
    shapes anywhere.  Registered as a pytree (dim/shape static) so it can
    flow through jit as an argument.
    """

    dim: int
    lo: jnp.ndarray
    inv_h: jnp.ndarray
    shape: Tuple[int, ...]
    table: jnp.ndarray           # (n_bins, K) int32, -1 padded
    x0: jnp.ndarray
    Tinv: jnp.ndarray
    cells: jnp.ndarray


def device_locator(loc: GridLocator, dtype=None) -> DeviceLocator:
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    n_bins = loc.n_bins
    K = loc.max_per_bin
    table = np.full((n_bins, K), -1, dtype=np.int32)
    for b in range(n_bins):
        s, e = loc.bin_start[b], loc.bin_start[b + 1]
        table[b, : e - s] = loc.bin_cells[s:e]
    return DeviceLocator(
        dim=loc.dim,
        lo=jnp.asarray(loc.lo, dtype),
        inv_h=jnp.asarray(loc.inv_h, dtype),
        shape=loc.shape,
        table=jnp.asarray(table),
        x0=jnp.asarray(loc.x0, dtype),
        Tinv=jnp.asarray(loc.Tinv, dtype),
        cells=jnp.asarray(loc.cells, jnp.int32),
    )


def recover_extrusion(mesh: SimplexMesh):
    """Recover (x_planes, n2d, tris2d, tri_of_prism, layer_of_prism)
    from a bare extruded tet mesh, or None.

    The channel meshes are x-plane extrusions with plane-major nodes and
    3-tets-per-prism cells (mesh/extrude.py) — but the product pipeline
    re-reads meshes from XDMF (reference InletBatchScript.py:39-52), which
    drops that provenance.  This detects the structure geometrically so
    the streamtrace locator can exploit it on re-read meshes too.  All
    checks are exact (the XDMF round-trip preserves coordinates bit-for-
    bit); any failure returns None and callers fall back to the general
    grid locator.
    """
    pts = np.asarray(mesh.points)
    if mesh.cell != "tetrahedron" or pts.shape[1] != 3:
        return None
    cells = np.asarray(mesh.cells)
    if len(cells) % 3:
        return None
    x = pts[:, 0]
    xs = np.unique(x)
    Lp = len(xs)
    n = len(pts)
    if Lp < 2 or Lp > 4096 or n % Lp:
        return None
    n2d = n // Lp
    X = x.reshape(Lp, n2d)
    if (X != X[:, :1]).any() or (X[:, 0] != xs).any():
        return None
    yz = pts[:, 1:].reshape(Lp, n2d, 2)
    if (yz != yz[:1]).any():
        return None
    # prisms: consecutive cell triples (extrude order: tet-minor)
    ids = cells.reshape(-1, 12)
    lay = ids.min(axis=1) // n2d
    if (ids // n2d != lay[:, None]).sum() * 2 != ids.size:
        return None                       # not exactly half top-plane
    loc2 = np.sort(ids % n2d, axis=1)
    new = np.concatenate(
        [np.ones((len(loc2), 1), bool), loc2[:, 1:] != loc2[:, :-1]],
        axis=1)
    if (new.sum(axis=1) != 3).any():
        return None                       # prism footprint must be a tri
    tri_nodes = loc2[new].reshape(-1, 3)  # (n_prisms, 3) sorted node ids
    # unique rows via scalar int64 keys: positional encoding preserves
    # lexicographic order, and 1-D np.unique is ~10x faster than axis=0
    # (which sorts a structured view) at the 484k-prism bench mesh.
    if n2d >= 1 << 21:
        # key max ~ n2d^3 would overflow int64 and silently collide
        # distinct triangles; fall back to the exact (slower) row-unique.
        tris, tri_of = np.unique(tri_nodes, axis=0, return_inverse=True)
    else:
        n2d64 = np.int64(n2d)
        key = (tri_nodes[:, 0].astype(np.int64) * n2d64
               + tri_nodes[:, 1]) * n2d64 + tri_nodes[:, 2]
        ukey, tri_of = np.unique(key, return_inverse=True)
        tris = np.stack([ukey // (n2d64 * n2d64),
                         (ukey // n2d64) % n2d64,
                         ukey % n2d64], axis=1)
    return xs, n2d, tris.astype(np.int32), tri_of.astype(np.int32), \
        lay.astype(np.int32)


@partial(jax.tree_util.register_dataclass,
         data_fields=["x_planes", "lo2", "inv_h2", "tab2", "prism_base",
                      "prism_geom", "cells"],
         meta_fields=["nl", "nt", "shape2"])
@dataclasses.dataclass
class LayeredDeviceLocator:
    """Extrusion-aware point locator (the streamtrace hot path).

    The general grid locator pays K=max_per_bin candidate gathers per
    query (measured K=54, ~2.6 KB/query at the 1.05M-dof bench mesh).
    This locator is PACKED for gather GRANULARITY (each dynamic row
    gather pays a fixed per-row cost regardless of width, so 20 tiny
    gathers cost far more than one wide one): a query is

      * x-layer: compare against the (Lp,) plane array (broadcast,
        no gather),
      * ONE row gather of ``tab2[bin]`` — all K2d 2D candidates WITH
        their inlined (x0, Tinv) triangle geometry in a single
        (K2, 7) row — followed by vectorized barycentric tests,
      * ONE scalar gather of ``prism_base[tri * nl + layer]``,
      * ONE row gather of ``prism_geom[prism]`` — the (36,) packed
        (x0, Tinv) of the prism's three sub-tets.

    4 gather rows per query vs ~35 for the round-4 layout (measured
    8.6x trace-step speedup at the 1.05M-dof bench mesh).
    """

    nl: int                       # layers = Lp - 1
    nt: int                       # 2D triangles
    shape2: Tuple[int, int]       # 2D grid bins
    x_planes: jnp.ndarray         # (Lp,)
    lo2: jnp.ndarray              # (2,) 2D grid origin
    inv_h2: jnp.ndarray           # (2,)
    tab2: jnp.ndarray             # (n_bins, K2, 7) f32: [tri, x0(2), Tinv(4)]
    prism_base: jnp.ndarray       # (nt * nl,) 3*prism or -1 (dead)
    prism_geom: jnp.ndarray       # (n_prisms, 36): 3 x [x0(3), Tinv(9)]
    cells: jnp.ndarray            # (nc, 4)


@jax.jit
def _prism_pack_device(pts: jnp.ndarray, cells: jnp.ndarray,
                       out_dtype: jnp.ndarray):
    """One fused program: per-tet (x0, Tinv) geometry packed into
    per-prism (36,) rows, in a single persistent-cacheable dispatch
    instead of an eager concat/reshape/cast chain."""
    x0, Tinv = _cell_geometry_device(pts, cells)
    return jnp.concatenate(
        [x0, Tinv.reshape(-1, 9)],
        axis=1).reshape(-1, 36).astype(out_dtype.dtype)


@jax.jit
def _cell_geometry_device(pts: jnp.ndarray, cells: jnp.ndarray):
    """(x0, Tinv) per tet, batched on device.

    Tinv = inv(E^T) with E the (3,3) edge matrix, via the closed-form
    adjugate — three cross products and one dot, all elementwise ops
    that XLA fuses into the gather.
    """
    cp = pts[cells]                                   # (nc, 4, 3)
    x0 = cp[:, 0, :]
    e = cp[:, 1:4, :] - cp[:, 0:1, :]                 # (nc, 3, 3) rows e_k
    # M = E^T has columns e_k  ->  inv(M) rows = cross(e_j, e_k) / det
    c0 = jnp.cross(e[:, 1], e[:, 2])
    c1 = jnp.cross(e[:, 2], e[:, 0])
    c2 = jnp.cross(e[:, 0], e[:, 1])
    det = jnp.einsum("ni,ni->n", e[:, 0], c0)[:, None, None]
    # Degenerate tets (|det| ~ 0) get NaN Tinv rows: NaN barycentrics
    # fail every ``>= -tol`` test, so points in such a cell locate as
    # outside (cell = -1) instead of silently mislocating on inf values.
    scale = jnp.max(jnp.abs(e), axis=(1, 2))[:, None, None] ** 3
    bad = jnp.abs(det) <= 1e-14 * jnp.maximum(scale, 1e-300)
    det = jnp.where(bad, jnp.nan, det)
    Tinv = jnp.stack([c0, c1, c2], axis=1) / det
    return x0, Tinv


def build_layered_locator(mesh: SimplexMesh, dtype=None
                          ) -> Optional[LayeredDeviceLocator]:
    """LayeredDeviceLocator from a (possibly re-read) extruded channel
    mesh, or None when the mesh is not a recoverable extrusion."""
    rec = recover_extrusion(mesh)
    if rec is None:
        return None
    xs, n2d, tris, tri_of, lay = rec
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    nl = len(xs) - 1
    nt = len(tris)
    if nt >= 1 << 24:
        return None      # tri ids are carried exactly as f32 in tab2
    mesh2d = SimplexMesh("triangle", np.asarray(mesh.points)[:n2d, 1:3],
                         tris)
    loc2 = build_locator(mesh2d)
    base = np.full(nt * nl, -1, np.int32)
    base[tri_of * nl + lay] = np.arange(len(tri_of), dtype=np.int32) * 3
    # Packed 2D candidate table: candidate ids AND triangle geometry in
    # one (K2, 7) row — a query gathers one row instead of 1 + 2*K2.
    n_bins = loc2.n_bins
    K2 = loc2.max_per_bin
    tab2 = np.zeros((n_bins, K2, 7), np.float64)
    tab2[:, :, 0] = -1.0
    counts = np.diff(loc2.bin_start)
    rows = np.repeat(np.arange(n_bins), counts)
    slot = np.arange(len(loc2.bin_cells)) - np.repeat(
        loc2.bin_start[:-1], counts)
    ids = loc2.bin_cells
    tab2[rows, slot, 0] = ids
    tab2[rows, slot, 1:3] = loc2.x0[ids]
    tab2[rows, slot, 3:7] = loc2.Tinv[ids].reshape(-1, 4)
    # Per-cell geometry (x0, Tinv) is computed ON DEVICE: the host path
    # (pts[cells] gather + LAPACK-loop np.linalg.inv over (nc,3,3)) cost
    # 8.8 s of the 12.5 s locator build at 1.45M cells; the device gather
    # + closed-form adjugate inverse is milliseconds and uploads pts/cells
    # (which must go up anyway) instead of the 10x larger cp/Tinv arrays.
    # Geometry (adjugate/det) is computed at the highest precision the
    # session supports and cast to dtype AFTER: under x64 the f64 path
    # keeps sliver-cell barycentric tests within the 1e-6 tol; under
    # default f32 there is no wider dtype to use.
    high = jnp.float64 if jax.config.jax_enable_x64 else dtype
    np_dt = np.dtype(dtype)
    # ONE batched host->device transfer for every locator array (dtype
    # casts done in numpy first) instead of one transfer per array.
    pts_d, cells_d, xs_d, lo2_d, ih2_d, tab2_d, base_d = jax.device_put((
        np.asarray(mesh.points, np.float64 if high == jnp.float64
                   else np_dt),
        np.asarray(mesh.cells, np.int32),
        np.asarray(xs, np_dt),
        np.asarray(loc2.lo, np_dt),
        np.asarray(loc2.inv_h, np_dt),
        np.asarray(tab2, np_dt),
        base,
    ))
    # prism-packed tet geometry: cells are 3 consecutive tets per prism
    # (mesh/extrude.py order, verified by recover_extrusion); ONE fused
    # device program
    prism_geom = _prism_pack_device(pts_d, cells_d, jnp.zeros(0, dtype))
    return LayeredDeviceLocator(
        nl=nl, nt=nt, shape2=loc2.shape,
        x_planes=xs_d,
        lo2=lo2_d,
        inv_h2=ih2_d,
        tab2=tab2_d,
        prism_base=base_d,
        prism_geom=prism_geom,
        cells=cells_d,
    )


def locate_device_layered(dloc: LayeredDeviceLocator, q: jnp.ndarray,
                          tol: float = 1e-6):
    """jnp point location on the layered locator — same contract as
    locate_device: (cell id or -1, barycentric (4,)).

    Four gather rows total (tab2, prism_base, prism_geom — see the
    class docstring); everything else is broadcast vector math.
    """
    xp = dloc.x_planes
    l = jnp.clip(jnp.sum(q[0] >= xp) - 1, 0, dloc.nl - 1)
    in_x = (q[0] >= xp[0] - tol) & (q[0] <= xp[-1] + tol)
    # 2D locate from the packed row
    q2 = q[1:3]
    sh = jnp.asarray(dloc.shape2)
    idx = jnp.clip(((q2 - dloc.lo2) * dloc.inv_h2).astype(jnp.int32),
                   0, sh - 1)
    row = dloc.tab2[idx[0] * dloc.shape2[1] + idx[1]]     # (K2, 7)
    rel = q2[None, :] - row[:, 1:3]
    l1 = row[:, 3] * rel[:, 0] + row[:, 4] * rel[:, 1]
    l2 = row[:, 5] * rel[:, 0] + row[:, 6] * rel[:, 1]
    bar2 = jnp.stack([1.0 - l1 - l2, l1, l2], axis=1)     # (K2, 3)
    ok2 = (row[:, 0] >= 0) & (bar2.min(axis=1) >= -tol)
    tri = jnp.where(ok2.any(), row[jnp.argmax(ok2), 0].astype(jnp.int32),
                    -1)
    base = dloc.prism_base[jnp.maximum(tri, 0) * dloc.nl + l]
    base = jnp.where((tri >= 0) & in_x, base, -1)
    geom = dloc.prism_geom[jnp.maximum(base, 0) // 3]     # (36,)
    g3 = geom.reshape(3, 12)
    rel3 = q[None, :] - g3[:, :3]                         # (3, 3)
    Ti = g3[:, 3:].reshape(3, 3, 3)
    lam = jnp.einsum("kij,kj->ki", Ti, rel3)
    lam0 = 1.0 - lam.sum(axis=1, keepdims=True)
    bar = jnp.concatenate([lam0, lam], axis=1)            # (3, 4)
    valid = (base >= 0) & (bar.min(axis=1) >= -tol)
    first = jnp.argmax(valid)
    cand = jnp.maximum(base, 0) + jnp.arange(3, dtype=jnp.int32)
    cell = jnp.where(valid.any(), cand[first], -1)
    return cell, bar[first]


def locate_any(dloc, q: jnp.ndarray, tol: float = 1e-6):
    """Type-dispatching locate (static under jit — the locator pytree
    type is part of the trace)."""
    if isinstance(dloc, LayeredDeviceLocator):
        return locate_device_layered(dloc, q, tol)
    return locate_device(dloc, q, tol)


def build_trace_locator(mesh: SimplexMesh, dtype=None):
    """Best available device locator for the streamtracer: the layered
    one when the mesh is a recoverable extrusion, else the general grid
    locator."""
    dl = build_layered_locator(mesh, dtype)
    if dl is not None:
        return dl
    return device_locator(build_locator(mesh), dtype)


def locate_device(dloc: DeviceLocator, q: jnp.ndarray, tol: float = 1e-6):
    """jnp point location for a single point q (dim,). vmap over seeds.

    Returns (cell id or -1, barycentric (dim+1,)).
    """
    shape = jnp.asarray(dloc.shape)
    idx = jnp.clip(((q - dloc.lo) * dloc.inv_h).astype(jnp.int32),
                   0, shape - 1)
    if dloc.dim == 3:
        flat = (idx[0] * dloc.shape[1] + idx[1]) * dloc.shape[2] + idx[2]
    else:
        flat = idx[0] * dloc.shape[1] + idx[1]
    cand = dloc.table[flat]                          # (K,)
    safe = jnp.maximum(cand, 0)
    rel = q[None, :] - dloc.x0[safe]                 # (K, dim)
    lam = jnp.einsum("kij,kj->ki", dloc.Tinv[safe], rel)
    lam0 = 1.0 - lam.sum(axis=1, keepdims=True)
    bar = jnp.concatenate([lam0, lam], axis=1)       # (K, dim+1)
    valid = (cand >= 0) & (bar.min(axis=1) >= -tol)
    first = jnp.argmax(valid)
    found = valid.any()
    cell = jnp.where(found, cand[first], -1)
    return cell, bar[first]
