"""Geometric-algebraic multigrid on the layered operator.

The mesh-independent preconditioner (VERDICT round-1 item 6): block-Jacobi
and plane-GS iteration counts grow ~1/h, which dominates wall-clock at the
reference's 1e-8 tolerances (the reference leans on ASM+tfqmr robustness,
NavierStokes/NavierStokesChannelFlow.py:197-202).  The layered operator
(assemble/layered.py) is (2D cross-section graph) x (tridiagonal plane
coupling), and that tensor structure survives coarsening:

* 2D: greedy graph aggregation (aggregates of ~4 nodes) — piecewise-
  constant prolongation over *node blocks*, so the (bs, bs) u/p block
  structure is preserved on every level (point-block AMG);
* planes: pair planes l -> l//2 — tridiagonal stays tridiagonal.

With 0/1 prolongation the Galerkin product RAP is a pure SEGMENT-SUM of
the fine value tensor with a host-precomputed index map — it runs on
device at SpMV cost per Newton iteration, no sparse-sparse products.
Smoother: the existing plane-GS (solve/precond.py); coarsest level is
relaxed with extra sweeps.  The V-cycle is used as a (fixed, linear)
right preconditioner inside FGMRES.

Dirichlet handling: the fine values are projected (P A P) before RAP, the
coarse mask marks an aggregate component free iff any member is free, and
every level's operator acts as P A P + (I - P), exactly like the fine
bc_operator.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..assemble.layered import LayeredArrays, layered_matvec
from .precond import plane_gs_layered


class MGLevel(NamedTuple):
    """Device arrays for one coarse level (a pytree).

    seg_map/node_map live on the PARENT (finer) level's index space and
    define restriction into this level.
    """

    seg_map: jnp.ndarray     # (3*E_f*Lp_f,) -> coarse seg id or trash
    node_map: jnp.ndarray    # (Lp_f*n2d_f,) -> coarse node id
    cols: jnp.ndarray        # (E_c,)
    row_ids: jnp.ndarray     # (E_c,) sorted
    diag_pos: jnp.ndarray    # (n2d_c,)
    mask: jnp.ndarray        # (Lp_c*n2d_c*bs,)


class MGHierarchy:
    """levels are pytree children; dims are static aux data, so the
    per-level (n2d, Lp, E) stay Python ints inside jit (reshapes and the
    recursion depth are static)."""

    def __init__(self, levels: Tuple[MGLevel, ...],
                 dims: Tuple[Tuple[int, int, int], ...]):
        self.levels = tuple(levels)
        self.dims = tuple(dims)


jax.tree_util.register_pytree_node(
    MGHierarchy,
    lambda h: (h.levels, h.dims),
    lambda dims, levels: MGHierarchy(levels=levels, dims=dims))


def _aggregate_graph(rows: np.ndarray, cols: np.ndarray, n: int,
                     target: int = 4) -> Tuple[np.ndarray, int]:
    """Greedy BFS aggregation of an undirected graph into clusters of up
    to ``target`` nodes.  Returns (agg id per node, n_agg)."""
    order = np.argsort(rows, kind="stable")
    r_s, c_s = rows[order], cols[order]
    indptr = np.zeros(n + 1, np.int64)
    np.add.at(indptr, r_s + 1, 1)
    indptr = np.cumsum(indptr)
    agg = np.full(n, -1, np.int64)
    n_agg = 0
    for i in range(n):
        if agg[i] >= 0:
            continue
        agg[i] = n_agg
        size = 1
        for j in c_s[indptr[i]:indptr[i + 1]]:
            if size >= target:
                break
            if agg[j] < 0:
                agg[j] = n_agg
                size += 1
        n_agg += 1
    return agg, n_agg


def _coarsen_level(
    rows2d: np.ndarray, cols2d: np.ndarray, n2d: int, Lp: int,
    mask_np: np.ndarray, bs: int, agg_target: int = 4,
    coarsen_planes: bool = True,
):
    """Host-side maps for one coarsening step."""
    E = len(rows2d)
    agg, n2d_c = _aggregate_graph(rows2d, cols2d, n2d, agg_target)
    Lp_c = (Lp + 1) // 2 if coarsen_planes else Lp

    # coarse 2D pairs = image of fine pairs (plus plane-offset pairs map
    # onto the same 2D pair set)
    ck = agg[rows2d] * n2d_c + agg[cols2d]
    uniq, pair_of_fine = np.unique(ck, return_inverse=True)
    E_c = len(uniq)
    rows2d_c = (uniq // n2d_c).astype(np.int32)
    cols2d_c = (uniq % n2d_c).astype(np.int32)
    diag_keys = np.arange(n2d_c, dtype=np.int64) * (n2d_c + 1)
    diag_pos_c = np.searchsorted(uniq, diag_keys)
    assert (uniq[diag_pos_c] == diag_keys).all()

    # seg map on the fine (d, e, l) grid: seg = (d*E + e)*Lp + l
    d_grid = np.arange(3)[:, None, None] - 1           # -1, 0, +1
    e_grid = np.arange(E)[None, :, None]
    l_grid = np.arange(Lp)[None, None, :]
    lcol = l_grid + d_grid
    valid = (lcol >= 0) & (lcol < Lp)
    L = l_grid // 2 if coarsen_planes else l_grid
    Lcol = np.where(valid, lcol, 0) // 2 if coarsen_planes \
        else np.where(valid, lcol, 0)
    d_c = Lcol - L
    valid &= (d_c >= -1) & (d_c <= 1)
    e_c = pair_of_fine[e_grid]
    seg_c = ((d_c + 1) * E_c + e_c) * Lp_c + L
    n_seg_c = 3 * E_c * Lp_c
    seg_map = np.where(valid, seg_c, n_seg_c).reshape(-1).astype(np.int32)

    # node map (plane-major): fine (l, i) -> coarse (l//2, agg[i])
    l_f = np.repeat(np.arange(Lp), n2d)
    i_f = np.tile(np.arange(n2d), Lp)
    Lf = l_f // 2 if coarsen_planes else l_f
    node_map = (Lf * n2d_c + agg[i_f]).astype(np.int32)

    # coarse mask: free iff any member free
    mb = mask_np.reshape(Lp * n2d, bs)
    mask_c = np.zeros((Lp_c * n2d_c, bs), mask_np.dtype)
    np.maximum.at(mask_c, node_map, mb)

    return (seg_map, node_map, rows2d_c, cols2d_c, diag_pos_c,
            mask_c.reshape(-1), n2d_c, Lp_c, E_c)


def build_mg_hierarchy(
    rows2d: np.ndarray, cols2d: np.ndarray, n2d: int, Lp: int,
    mask_np: np.ndarray, bs: int,
    n_levels: int = 3, agg_target: int = 4, min_dofs: int = 2000,
    coarsen_planes: bool = True,
) -> MGHierarchy:
    """Host-side setup: ``n_levels`` coarsenings (or until below
    ``min_dofs``).  Static per mesh; values are re-RAP'd per Newton
    iteration on device.

    coarsen_planes=False builds a SEMI-coarsened hierarchy: only the 2D
    cross-section aggregates, every level keeps all Lp planes.  This is
    the pairing for the line-CR smoother on the advective NS Jacobian:
    the exact vertical line solve owns the streamwise (plane-direction)
    advection on every level, and coarsening only has to represent the
    in-plane, diffusion/pressure-dominated error — full plane pairing
    feeds the 0/1 Galerkin RAP an averaged vertical advection operator
    that destabilizes the cycle (measured: benchmarks/_line_cr_exp.py).
    """
    levels: List[MGLevel] = []
    dims: List[Tuple[int, int, int]] = []
    r, c, n, L, m = (np.asarray(rows2d, np.int64), np.asarray(cols2d, np.int64),
                     int(n2d), int(Lp), np.asarray(mask_np))
    for _ in range(n_levels):
        if n * L * bs <= min_dofs:
            break
        (seg_map, node_map, r_c, c_c, dp_c, m_c, n_c, L_c, E_c) = \
            _coarsen_level(r, c, n, L, m, bs, agg_target,
                           coarsen_planes=coarsen_planes)
        levels.append(MGLevel(
            seg_map=jnp.asarray(seg_map), node_map=jnp.asarray(node_map),
            cols=jnp.asarray(c_c), row_ids=jnp.asarray(r_c),
            diag_pos=jnp.asarray(dp_c.astype(np.int32)),
            mask=jnp.asarray(m_c)))
        dims.append((n_c, L_c, E_c))
        r, c, n, L, m = r_c.astype(np.int64), c_c.astype(np.int64), \
            n_c, L_c, m_c
    return MGHierarchy(levels=tuple(levels), dims=tuple(dims))


def _stub_arrays(cols, row_ids) -> LayeredArrays:
    """layered_matvec only reads cols/row_ids."""
    z = jnp.zeros(0, jnp.int32)
    return LayeredArrays(cell_dofs=z, cell_coords=z, ell_pos=z,
                        cols=cols, row_ids=row_ids, diag_pos=z)


def _project_values(values, mask, cols, row_ids, n2d, Lp):
    """P A P on the value tensor: rows scaled by the row-dof mask, cols by
    the (plane-shifted) col-dof mask."""
    bs = values.shape[0]
    mb = mask.reshape(Lp, n2d, bs)
    mrow = mb[:, row_ids, :].transpose(2, 1, 0)      # (bs, E, Lp)
    mcol = mb[:, cols, :].transpose(2, 1, 0)         # (bs, E, Lp)
    zero = jnp.zeros_like(mcol[:, :, :1])
    mcol_m = jnp.concatenate([zero, mcol[..., :-1]], axis=-1)
    mcol_p = jnp.concatenate([mcol[..., 1:], zero], axis=-1)
    mcol_d = jnp.stack([mcol_m, mcol, mcol_p], axis=1)   # (bs, 3, E, Lp)
    return values * mrow[:, None, None, :, :] * mcol_d[None]


def make_mg_pc(
    hierarchy: MGHierarchy,
    values: jnp.ndarray,          # fine (bs, bs, 3, E, Lp), unprojected
    cols: jnp.ndarray,
    row_ids: jnp.ndarray,
    diag_pos: jnp.ndarray,
    mask: jnp.ndarray,
    n2d: int,
    n_planes: int,
    n_coarse_sweeps: int = 4,
    pc_dtype=None,
    smoother: str = "plane_gs",
    coarse: str = "dense",
    dense_cap: int = 8192,
    cycle_type: str = "v",
    cheby_degree: int = 6,
    cheby_alpha: float = 3.0,
    cheby_safety: float = 1.4,
) -> Callable:
    """V-cycle preconditioner closure r -> x for the layered operator.

    smoother='plane_gs': strongest per-sweep reduction, but each sweep
    is a sequential lax.scan over planes — ~77 dependent steps per level
    at the production channel, so a V-cycle apply is LATENCY-bound
    (~230 ms measured) regardless of problem size.  smoother='jacobi':
    two damped (omega=0.7) node-block-Jacobi sweeps — one batched 4x4
    matmul + SpMV each, fully parallel; more Krylov iterations but far
    cheaper applies.

    coarse='dense' (default): solve the coarsest level EXACTLY by
    materializing it as a dense matrix and inverting once per PC build
    (a few GFLOP at the ~2k-dof coarsest level — noise next to one fine
    SpMV); each apply is then a dense matvec, fully MXU-parallel.  A
    V-cycle's mesh-independence requires the coarse problem actually
    solved — n_coarse_sweeps of a point smoother on a 2k-dof advective
    problem was the real bottleneck of the whole cycle.  Falls back to
    relaxation sweeps when the coarsest level exceeds ``dense_cap``
    dofs (inverse memory/FLOPs grow cubically)."""
    bs = values.shape[0]
    # level 0 keeps the RAW value tensor — every smoother/matvec below is
    # already mask-composed (P A P + (I-P) via the mask multiplies), and
    # a persistent projected copy of the fine values OOMed HBM at 1.05M
    # dofs (measured: 17.53G > 15.75G).  Projection happens transiently
    # inside the RAP only.
    lv_vals = [values]
    lv_cols = [cols]
    lv_rows = [row_ids]
    lv_diag = [diag_pos]
    lv_mask = [mask]
    lv_dims = [(n2d, n_planes, values.shape[3])]

    for lev, (n_c, L_c, E_c) in zip(hierarchy.levels, hierarchy.dims):
        nk, Lk, _ = lv_dims[-1]
        Vf = _project_values(
            lv_vals[-1], lv_mask[-1].astype(values.dtype), lv_cols[-1],
            lv_rows[-1], nk, Lk)
        n_seg_c = 3 * E_c * L_c
        # vmap the segment-sum over the 16 (i, j) block entries so the
        # operand inside is 1-D (nnz,): a (nnz, 4, 4) operand gets a
        # T(4,128) tiling on the tiny trailing dims — 32x padding, 10.3G
        # of HLO temp at 1.05M dofs (measured compile OOM)
        Vc = jax.vmap(
            lambda v: jax.ops.segment_sum(
                v, lev.seg_map, num_segments=n_seg_c + 1)[:n_seg_c]
        )(Vf.reshape(bs * bs, -1))
        Vc = Vc.reshape(bs, bs, 3, E_c, L_c)
        # re-project: aggregates can mix free/constrained dofs
        Vc = _project_values(Vc, lev.mask.astype(Vc.dtype), lev.cols,
                             lev.row_ids, n_c, L_c)
        lv_vals.append(Vc)
        lv_cols.append(lev.cols)
        lv_rows.append(lev.row_ids)
        lv_diag.append(lev.diag_pos)
        lv_mask.append(lev.mask.astype(Vc.dtype))
        lv_dims.append((n_c, L_c, E_c))

    n_lv = len(lv_vals)
    coarse_vals_full = lv_vals[-1]    # pre-cast: the dense coarse matrix
    if pc_dtype is not None:
        # stream the V-cycle's value tensors in the PC dtype: with bf16
        # values layered_matvec reads them at half the HBM bandwidth
        # (measured 1.22x at 345k, benchmarks/_bf16_spmv_bench.py) and
        # still accumulates in f32.  PC quality in bf16 is ample — the
        # outer FGMRES operator keeps the caller's f32 tensor.
        lv_vals = [v.astype(pc_dtype) for v in lv_vals]
    smoothers = []
    matvecs = []
    for k in range(n_lv):
        nk, Lk, _ = lv_dims[k]
        arrs = _stub_arrays(lv_cols[k], lv_rows[k])
        Vk, mk = lv_vals[k], lv_mask[k]

        def mv(x, arrs=arrs, Vk=Vk, mk=mk, nk=nk, Lk=Lk):
            return mk * layered_matvec(arrs, nk, Lk, Vk, mk * x) \
                + (1.0 - mk) * x
        matvecs.append(mv)

        def _lam_max_tail(Dinv, mvk, mk=mk, n_pow=12, burn_in=5):
            """|lambda|max(D^-1 A) estimate that is robust on the
            NONNORMAL NS Jacobian: power iteration with a running MAX of
            the norm ratios over the tail iterations.

            Plain power iteration (the final ratio) underestimates badly
            at evolved NS states: the dominant eigenpair goes complex,
            the iterate norm OSCILLATES over the rotating eigenplane,
            and the final sample landed 25-40% LOW at 1.05M dofs
            (round-3 measurement, reproduced on CPU: the degree-6
            Chebyshev polynomial then AMPLIFIES the modes above the
            interval — V-cycle rho drifts above 1 and FGMRES flatlines
            at ~1.3x per 200 its).  The tail-max samples the oscillation
            PEAK instead (>= the cycle mean ~ |lambda|), and any
            leftover nonnormal transient growth biases it high — the
            safe direction.  NOT sigma_max(B): on this operator family
            the nonnormality gap is ~4x (sigma 7.9 vs rho 1.8 at the
            benign state, CPU-measured) — an interval top at sigma_max
            parks the whole Chebyshev band above the actual spectrum,
            the smoother stops smoothing, and the naked aggregation
            coarse correction DIVERGES (rho ~ 800 measured).
            """
            def B(x):
                return Dinv(mvk(x).astype(jnp.float32))

            v0 = mk.astype(jnp.float32)
            v0 = v0 / jnp.maximum(jnp.linalg.norm(v0), 1e-30)

            def _pow(i, carry):
                v, best = carry
                w = B(v)
                nw = jnp.maximum(jnp.linalg.norm(w), 1e-30)
                best = jnp.where(i >= burn_in, jnp.maximum(best, nw),
                                 best)
                return w / nw, best

            _, lmax = jax.lax.fori_loop(
                0, n_pow, _pow, (v0, jnp.float32(0.0)))
            return lmax

        if smoother == "jacobi":
            from .precond import block_jacobi

            d = Vk[:, :, 1, lv_diag[k], :]          # (bs, bs, n2d, Lp)
            blocks = d.transpose(3, 2, 0, 1).reshape(-1, bs, bs)
            Dinv = block_jacobi(blocks.astype(jnp.float32),
                                mk.astype(jnp.float32))
            # omega auto-scaled to the measured spectrum: the historical
            # fixed 0.7 assumed rho(D^-1 A) <~ 2 — at the evolved NS
            # state at 1M dofs the spectrum reaches ~10x further and the
            # two-sweep smoother AMPLIFIED by >20x per V-cycle (round-3
            # CPU measurement).  1.4/ub reproduces omega=0.7 exactly on
            # benign states (ub ~ 2) and stays stable everywhere else.
            ub_j = cheby_safety * jnp.maximum(
                _lam_max_tail(Dinv, matvecs[k]), jnp.float32(1e-6))
            omega = 1.4 / ub_j

            def sm(r, Dinv=Dinv, mvk=matvecs[k], omega=omega):
                x = omega * Dinv(r)
                return x + omega * Dinv(r - mvk(x))
            smoothers.append(sm)
        elif smoother == "cheby":
            # Chebyshev-accelerated block-Jacobi (the standard AMG
            # smoother upgrade, cf. hypre's relax 16): a degree-q
            # Chebyshev polynomial in D^-1 A tuned to damp the upper
            # [lmax/alpha, lmax] part of the spectrum — same
            # fully-parallel per-step cost as a Jacobi sweep, far
            # stronger smoothing.  Measured on the NS Jacobian
            # (channel, Re=10): degree 4 turns the V-cycle near
            # mesh-independent — 18 its at 70k dofs, 25 at 166k,
            # 35 at 345k (degree 3: 92/223; two damped Jacobi sweeps: 185/508);
            # above ~500k dofs degree 6 is needed (degree 4 stalls, see
            # parse_mg_pc grammar for reaching cheby_degree).
            # The interval top comes from _lam_max_tail (see its
            # docstring for why plain power iteration fails here).  The polynomial is fixed once
            # built, so the smoother stays a LINEAR operator (a
            # requirement for the V-cycle to be a fixed preconditioner;
            # FGMRES tolerates drift regardless).
            from .precond import block_jacobi

            d = Vk[:, :, 1, lv_diag[k], :]
            blocks = d.transpose(3, 2, 0, 1).reshape(-1, bs, bs)
            Dinv = block_jacobi(blocks.astype(jnp.float32),
                                mk.astype(jnp.float32))
            mvk = matvecs[k]

            ub = cheby_safety * jnp.maximum(_lam_max_tail(Dinv, mvk),
                                            jnp.float32(1e-6))
            lb = ub / cheby_alpha
            theta = 0.5 * (ub + lb)
            delta = 0.5 * (ub - lb)
            sigma = theta / delta

            def sm(r, Dinv=Dinv, mvk=mvk, theta=theta, delta=delta,
                   sigma=sigma, q=cheby_degree):
                rf = r.astype(jnp.float32)
                x = Dinv(rf) / theta
                dx = x
                rho = jnp.float32(1.0) / sigma

                # lax.fori_loop, NOT a Python loop: an unrolled degree-q
                # polynomial inlines q-1 SpMV graphs PER SMOOTHER
                # INSTANCE into the executable.
                def body(_, carry):
                    x, dx, rho = carry
                    res = rf - mvk(x).astype(jnp.float32)
                    rho_new = 1.0 / (2.0 * sigma - rho)
                    dx = (rho_new * rho) * dx \
                        + (2.0 * rho_new / delta) * Dinv(res)
                    return (x + dx, dx, rho_new)

                x, _, _ = jax.lax.fori_loop(0, q - 1, body, (x, dx, rho))
                return x.astype(r.dtype)
            smoothers.append(sm)
        elif smoother == "zebra":
            # red-black plane relaxation: plane-GS-class smoothing with
            # dependency depth 2 per sweep instead of Lp — compile-safe
            # inside Newton programs at 1M dofs, batched over planes
            from .precond import plane_zebra_layered

            smoothers.append(plane_zebra_layered(
                lv_vals[k], lv_cols[k], lv_rows[k], lv_diag[k],
                lv_mask[k], nk, Lk, zebra_sweeps=1, pc_dtype=pc_dtype))
        elif smoother == "linej":
            # hybrid: exact vertical line solve, then a damped node-block
            # Jacobi correction on the remaining (in-plane) residual —
            # the line solve owns the streamwise coupling, the Jacobi
            # pass damps the in-plane modes the line solve ignores
            from .precond import block_jacobi as _bj, line_cr_layered

            base = line_cr_layered(
                lv_vals[k], lv_diag[k], lv_mask[k], nk, Lk,
                pc_dtype=pc_dtype)
            d = Vk[:, :, 1, lv_diag[k], :]
            blocks = d.transpose(3, 2, 0, 1).reshape(-1, bs, bs)
            Dinv = _bj(blocks.astype(jnp.float32),
                       mk.astype(jnp.float32))
            omega = 0.7

            def sm(r, base=base, Dinv=Dinv, mvk=matvecs[k], omega=omega):
                x = omega * base(r)
                return x + omega * Dinv(r - mvk(x))
            smoothers.append(sm)
        elif smoother in ("line", "lined"):
            # vertical-line solve by cyclic reduction (log-depth, no
            # scan): exact in the extrusion/streamwise direction, Jacobi
            # between lines.  'lined' damps the update (omega=0.7).
            # CAUTION (measured, benchmarks/_line_cr_exp.py): strong at
            # lc=0.12 (66 its — the best NS count there) but the line
            # family degrades/diverges on the NS Jacobian at lc<=0.085
            # even damped or semi-coarsened; kept for coarse problems
            # and as a documented negative result — 'zebra' is the
            # robust scan-free smoother.
            from .precond import line_cr_layered

            base = line_cr_layered(
                lv_vals[k], lv_diag[k], lv_mask[k], nk, Lk,
                pc_dtype=pc_dtype)
            if smoother == "lined":
                omega = 0.7

                def sm(r, base=base, omega=omega):
                    return omega * base(r)
                smoothers.append(sm)
            else:
                smoothers.append(base)
        elif smoother == "grouped":
            # plane-GS strength at 1/8 the scan latency (G planes per
            # scan step) — and a ~8x smaller XLA program, which is what
            # lets this V-cycle compile inside Newton loops at scale
            from .precond import plane_gs_grouped

            smoothers.append(plane_gs_grouped(
                lv_vals[k], lv_cols[k], lv_rows[k], lv_diag[k],
                lv_mask[k], nk, Lk, group=8, pc_dtype=pc_dtype))
        else:
            smoothers.append(plane_gs_layered(
                lv_vals[k], lv_cols[k], lv_rows[k], lv_diag[k],
                lv_mask[k], nk, Lk, pc_dtype=pc_dtype))

    coarse_apply = None
    nk, Lk, Ek = lv_dims[-1]
    if coarse == "dense" and nk * Lk * bs <= dense_cap:
        Vk, mk = coarse_vals_full, lv_mask[-1]
        N = nk * Lk
        # scatter the (bs, bs) blocks of the coarsest value tensor into a
        # dense (N*bs, N*bs) matrix: entry V[:, :, d, e, l] couples block
        # row (l, row_ids[e]) to block col (l+d-1, cols[e])
        d_g = jnp.arange(3)[:, None, None] - 1
        e_g = jnp.arange(Ek)[None, :, None]
        l_g = jnp.arange(Lk)[None, None, :]
        lcol = l_g + d_g
        Rb = l_g * nk + lv_rows[-1][e_g]                  # (3, Ek, Lk)
        Cb = jnp.where((lcol >= 0) & (lcol < Lk), lcol, Lk) * nk \
            + lv_cols[-1][e_g]
        idx = jnp.where(Cb < N, Rb * N + Cb, N * N).reshape(-1)
        blocks = Vk.transpose(2, 3, 4, 0, 1).reshape(-1, bs, bs)
        Ad = jnp.zeros((N * N + 1, bs, bs), jnp.float32) \
            .at[idx].add(blocks.astype(jnp.float32))[:N * N]
        Ad = Ad.reshape(N, N, bs, bs).transpose(0, 2, 1, 3) \
            .reshape(N * bs, N * bs)
        # lv_vals[-1] is already P A P projected; add (I - P) rows
        Ad = Ad + jnp.diag(1.0 - mk.astype(jnp.float32))
        # the inverse stays f32 regardless of pc_dtype: a bf16 inverse of
        # the (ill-conditioned) coarse operator injects kappa*eps_bf16
        # noise that zeroes the whole V-cycle's progress, and the
        # ~2k-dof dense matvec is negligible next to one fine SpMV.
        # linalg.inv internals need not honour the matmul precision
        # setting — two Newton-Schulz steps with explicit HIGHEST
        # matmuls polish it to f32 accuracy independent of conditioning.
        HI = jax.lax.Precision.HIGHEST
        Ainv = jnp.linalg.inv(Ad)
        Id = jnp.eye(Ad.shape[0], dtype=Ad.dtype)
        for _ in range(2):
            Rd = Id - jnp.matmul(Ad, Ainv, precision=HI)
            Ainv = Ainv + jnp.matmul(Ainv, Rd, precision=HI)

        def coarse_apply(r, Ainv=Ainv):
            y = jnp.matmul(Ainv, r.astype(Ainv.dtype), precision=HI)
            return y.astype(r.dtype)

    def restrict(k, r):
        # sum rows into aggregates (R = P^T for 0/1 prolongation)
        lev = hierarchy.levels[k]
        nk1, Lk1, _ = lv_dims[k + 1]
        rb = r.reshape(-1, bs)
        rc = jax.ops.segment_sum(rb, lev.node_map,
                                 num_segments=nk1 * Lk1)
        return rc.reshape(-1)

    def prolong(k, xc):
        lev = hierarchy.levels[k]
        xb = xc.reshape(-1, bs)
        return xb[lev.node_map].reshape(-1)

    def cycle(k, r):
        if k == n_lv - 1:
            if coarse_apply is not None:
                return coarse_apply(r)
            x = smoothers[k](r)
            for _ in range(n_coarse_sweeps - 1):
                x = x + smoothers[k](r - matvecs[k](x))
            return x
        x = smoothers[k](r)                       # pre-smooth
        res = r - matvecs[k](x)
        xc = cycle(k + 1, restrict(k, res))
        if cycle_type == "w" and k + 1 < n_lv - 1:
            # W-cycle: a second coarse correction on the remaining
            # coarse-level residual (helps when the 0/1-prolongation
            # coarse correction is only marginally accurate)
            rc = restrict(k, res)
            xc = xc + cycle(k + 1, rc - matvecs[k + 1](xc))
        x = x + prolong(k, xc)
        x = x + smoothers[k](r - matvecs[k](x))   # post-smooth
        return x

    def apply(r):
        return cycle(0, r)

    return apply
