"""Image-defined channel flow: Stokes -> coarse NS -> fine NS continuation.

The flagship pipeline, replicating reference
NavierStokes/NavierStokesChannelFlow.py:468-549 (solve_NS_flow):

  1. inlet profiles from the image (flow/inlet.py; reference :102-104)
  2. coarse channel mesh (lc = 0.1; reference :515)
  3. P1-P1 mixed space + BCs: no-slip walls (marker 4), inlet Dirichlet
     velocity from the interpolated 2D profiles (markers 1, 2), outlet
     pressure 0 (marker 3) (reference :127-147)
  4. stabilized Stokes solve (mu_T = 0.2 h^2; reference :160-218)
  5. coarse Navier-Stokes Newton solve from the Stokes guess
     (G-metric SUPS/LSIC form; reference :220-312)
  6. fine mesh at the user lc; coarse solution interpolated as the initial
     guess (non-matching interpolation; reference :175-194, :526-530)
  7. fine Navier-Stokes Newton solve

All solves run as single jitted XLA programs on the device; meshing and
interpolation are host-side numpy setup.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..assemble.assembly import assembler_for_mixed, residual_of
from ..assemble.df_assembly import DFResidual
from ..config import Config, DEFAULT
from ..fem.bc import DirichletBC, bc_mask, bc_vector, combine_bcs
from ..fem.interpolate import build_locator, interpolate_p1_np
from ..fem.space import MixedVelocityPressureSpace, make_mixed_space
from ..forms.navier_stokes import make_ns_sups_kernel
from ..forms.navier_stokes_df import make_ns_sups_kernel_df, split64
from ..forms.stokes import make_stokes_kernel
from ..mesh.core import SimplexMesh
from ..mesh.extrude import extrude_channel
from ..mesh.image import get_contours, load_image, optimize_contour
from ..mesh.tri2d import triangulate_cross_section
from ..solve.driver import (refine_newton_bcsr,
    refine_newton_layered_stepped, residual_norm_layered,
    solve_linear_bcsr, solve_linear_layered, solve_newton_bcsr,
    solve_newton_layered, solve_newton_layered_stepped)
from .inlet import InletProfile, solve_inlet_profiles


@dataclasses.dataclass
class ChannelSolution:
    mesh: SimplexMesh
    space: MixedVelocityPressureSpace
    w: np.ndarray
    u: np.ndarray                  # (n_nodes, 3)
    p: np.ndarray                  # (n_nodes,)
    Re: float
    newton_iters: int
    newton_resnorm: float
    converged: bool
    timings: dict
    # double-float refinement (solve/refine.py), populated when enabled.
    # When refined=True, ``converged`` reports the REFINED solve (the f32
    # Newton flag alone is measured against a residual f32 assembly
    # cannot resolve below ~1e-6 — the premise of the refinement path);
    # the base f32 Newton flag is kept in ``base_converged``.
    refined: bool = False
    refine_iters: int = 0
    refine_resnorm: float = float("nan")
    w_lo: Optional[np.ndarray] = None     # hi+lo = two-f32 solution
    # ||F(w0)|| at the fine solve's initial guess: refinement stops at
    # max(newton_rtol * refine_n0, newton_atol) (SNES semantics)
    refine_n0: float = float("nan")
    base_converged: bool = True


def generate_channel_mesh(
    img_fname: str, lc: float, cfg: Config = DEFAULT, layered: bool = False,
) -> Tuple[SimplexMesh, np.ndarray, np.ndarray]:
    """Image -> marked 3D channel tet mesh (reference image2gmsh3D.main).

    Returns (mesh, inner_loop, outer_loop) in (y, z) coordinates.
    layered=True keeps the plane-major node grid for the layered solver
    (assemble/layered.py).
    """
    gray = load_image(img_fname)
    contours = get_contours(gray, cfg.contour)
    if len(contours) != 2:
        raise ValueError(
            f"expected 2 contours in {img_fname}, found {len(contours)}")
    outer_c, _ = optimize_contour(
        contours[0], cfg.contour.fft_cutoff_3d, cfg.contour.rdp_epsilon,
        cfg.contour.mesh_lc_frac_3d)
    inner_c, _ = optimize_contour(
        contours[1], cfg.contour.fft_cutoff_3d, cfg.contour.rdp_epsilon,
        cfg.contour.mesh_lc_frac_3d)
    inner_loop = inner_c[:, [1, 0]]
    outer_loop = outer_c[:, [1, 0]]
    tri = triangulate_cross_section(
        inner_loop, outer_loop, lc, cfg.channel.half_width)
    mesh = extrude_channel(tri, inner_loop, cfg.channel, lc,
                           compact=not layered)
    return mesh, inner_loop, outer_loop


def channel_bcs(
    mesh: SimplexMesh,
    W: MixedVelocityPressureSpace,
    inlet1: InletProfile,
    inlet2: InletProfile,
) -> DirichletBC:
    """No-slip walls + inlet profiles + outlet pressure (reference
    :127-147).  List order matches the reference's set_bc order (later
    wins on shared dofs)."""

    def vdofs(nodes):
        return np.stack(
            [W.velocity_dof(nodes, c) for c in range(3)], -1).ravel()

    wall = mesh.nodes_with_marker(4)
    n1 = mesh.nodes_with_marker(1)
    n2 = mesh.nodes_with_marker(2)
    out = mesh.nodes_with_marker(3)

    v1 = np.zeros((len(n1), 3))
    v1[:, 0] = inlet1.eval(mesh.points[n1][:, 1:3])
    v2 = np.zeros((len(n2), 3))
    v2[:, 0] = inlet2.eval(mesh.points[n2][:, 1:3])

    return combine_bcs([
        DirichletBC(vdofs(wall), np.zeros(3 * len(wall))),
        DirichletBC(vdofs(n1), v1.ravel()),
        DirichletBC(vdofs(n2), v2.ravel()),
        DirichletBC(W.pressure_dof(out), np.zeros(len(out))),
    ])


def interpolate_solution(
    src_mesh: SimplexMesh,
    src_space: MixedVelocityPressureSpace,
    w_src: np.ndarray,
    dst_mesh: SimplexMesh,
    dst_space: MixedVelocityPressureSpace,
) -> np.ndarray:
    """Coarse -> fine initial guess (reference interpolate_initial_guess,
    :175-194; padding 1e-6, outside points get zero)."""
    u, p = src_space.split(w_src)
    loc = build_locator(src_mesh)
    pts = dst_mesh.points
    u_i = interpolate_p1_np(src_mesh, np.asarray(u), pts, loc, tol=1e-6)
    p_i = interpolate_p1_np(src_mesh, np.asarray(p), pts, loc, tol=1e-6)
    return np.asarray(dst_space.combine(u_i, p_i))


def _setup(mesh, inlet1, inlet2, dtype=None):
    W = make_mixed_space(mesh, 1, 1)
    asm = assembler_for_mixed(W, dtype=dtype)
    bc = channel_bcs(mesh, W, inlet1, inlet2)
    g64 = bc_vector(W.ndofs, bc)
    mask = jnp.asarray(bc_mask(W.ndofs, bc), asm.dtype)
    g = jnp.asarray(g64, asm.dtype)
    return W, asm, mask, g, g64


def _setup_layered(mesh, inlet1, inlet2, dtype=None, mg_levels=0):
    """Layered-solver setup: BCs plus identity rows on the unused nodes
    of the solid splitter interior.  mg_levels > 0 also builds the
    multigrid hierarchy (solve/mg.py); returned as the 6th element."""
    from ..assemble.layered import build_layered
    from ..fem.bc import DirichletBC, combine_bcs

    W = make_mixed_space(mesh, 1, 1)
    n2d, n_planes, used = mesh.layered
    lp = build_layered(W, n2d, n_planes, dtype)
    bc = channel_bcs(mesh, W, inlet1, inlet2)
    unused_nodes = np.nonzero(~used)[0].astype(np.int64)
    bs = W.block_size
    unused_dofs = (unused_nodes[:, None] * bs
                   + np.arange(bs)[None, :]).ravel()
    bc = combine_bcs(
        [DirichletBC(unused_dofs, np.zeros(len(unused_dofs))), bc])
    if dtype is None:
        dtype = jnp.zeros(0).dtype
    g64 = bc_vector(W.ndofs, bc)
    mask = jnp.asarray(bc_mask(W.ndofs, bc), dtype)
    g = jnp.asarray(g64, dtype)
    if mg_levels <= 0:
        return W, lp, mask, g, g64
    from ..solve.mg import build_mg_hierarchy

    hier = build_mg_hierarchy(
        np.asarray(lp.pattern_like.row_ids),
        np.asarray(lp.pattern_like.indices),
        lp.n2d, lp.n_planes, bc_mask(W.ndofs, bc).astype(np.float32),
        lp.bs, n_levels=mg_levels)
    return W, lp, mask, g, g64, hier


def solve_ns_flow(
    Re: float,
    img_fname: str,
    flowrate_ratio: float,
    channel_mesh_size: float = 0.1,
    cfg: Config = DEFAULT,
    coarse_Re: Optional[float] = None,
    coarse_lc: float = 0.1,
    layered: bool = True,
    dtype=None,
    warm: Optional["ChannelSolution"] = None,
) -> ChannelSolution:
    """Full continuation solve (reference solve_NS_flow, :468-549).

    coarse_Re defaults to the target Re (solve_NS_flow:522); the reference
    main() instead uses Re=1 for the coarse pass (:567).

    layered=True (default) uses the plane-structured operator
    (assemble/layered.py) for extruded channel meshes; layered=False
    keeps the generic block-CSR path.

    warm: a ChannelSolution of a DIFFERENT Re on the SAME (image, lc)
    — a Reynolds-sweep fast path the per-run reference contract lacks
    (run_all_RE.sh re-runs the whole pipeline per Re): the coarse
    mesh/Stokes/coarse-NS/interpolation phases are skipped entirely and
    the fine Newton starts from the previous Re's fine solution.  The
    converged result is identical (same Newton tolerances on the same
    fine operator); only the initial guess changes.  Ignored when the
    mesh shape does not match (e.g. different lc).
    """
    scfg = cfg.solver
    timings = {}

    t0 = time.time()
    inlet1, inlet2 = solve_inlet_profiles(img_fname, flowrate_ratio, cfg)
    timings["inlet_profiles"] = time.time() - t0

    if warm is not None and layered:
        sol = _solve_ns_flow_warm(
            Re, img_fname, inlet1, inlet2, channel_mesh_size, cfg,
            dtype, warm, timings)
        if sol is not None:
            return sol
        # shape mismatch: fall through to the full continuation solve

    # ---- coarse mesh: Stokes + NS --------------------------------------
    t0 = time.time()
    mesh_c, inner_loop, _ = generate_channel_mesh(
        img_fname, coarse_lc, cfg, layered=layered)
    timings["coarse_mesh"] = time.time() - t0

    stokes_k = make_stokes_kernel(
        "tetrahedron", nu=1.0, mu_T_coeff=cfg.stab.stokes_mu_T_coeff)
    cRe = Re if coarse_Re is None else coarse_Re

    def ns_kernel(r):
        return make_ns_sups_kernel(
            "tetrahedron", nu=1.0 / r, C_I=cfg.stab.C_I,
            transposed_stab=cfg.stab.transposed_advection_in_stab)

    # Reynolds continuation on the coarse mesh: Newton straight from the
    # Stokes init stalls above Re ~ 60 (measured: the reference's Re=70
    # sweep configuration); a short geometric Re ladder keeps every rung
    # inside Newton's basin at coarse-mesh cost.  The reference has no
    # equivalent — its MUMPS-exact SNES absorbs more of the gap.
    if cRe > 50:
        n_rungs = int(np.ceil(np.log2(cRe / 25.0))) + 1
        re_ladder = list(np.geomspace(25.0, cRe, n_rungs + 1)[1:])
    else:
        re_ladder = [cRe]
    ns_c = ns_kernel(re_ladder[-1])
    ns_f = ns_kernel(Re)

    mg_lv = scfg.mg_levels if (scfg.pc.startswith("mg")
                               or scfg.pc_newton.startswith("mg")) else 0

    # ---- fine mesh EARLY + background AOT of the fine Newton program
    # (VERDICT round-4 item 10): the first production Re of a session
    # pays the big fine-mesh XLA compiles while the host would
    # otherwise sit in the coarse phases.  Host meshing/pattern build
    # happens up front (it needs no device); the lower+compile then
    # runs on a daemon thread concurrently with the coarse solve —
    # when it finishes first, the fine Newton's own jit call is served
    # from the in-process/persistent executable caches.
    fine_early = None
    prewarm = None
    distinct_fine = abs(channel_mesh_size - coarse_lc) >= 1e-12
    if layered and distinct_fine and os.environ.get(
            "SNS_OVERLAP_COMPILE", "1") != "0":
        t0 = time.time()
        mesh_f0, _, _ = generate_channel_mesh(
            img_fname, channel_mesh_size, cfg, layered=layered)
        timings["fine_mesh"] = time.time() - t0
        t0 = time.time()
        W_f0, lp_f0, mask_f0, g_f0, g64_f0, *mg_f0 = _setup_layered(
            mesh_f0, inlet1, inlet2, dtype, mg_levels=mg_lv)
        mg_f0 = mg_f0[0] if mg_f0 else None
        timings["fine_setup"] = time.time() - t0
        fine_early = (mesh_f0, W_f0,
                      (lp_f0, mask_f0, g_f0, g64_f0, mg_f0))

        import threading

        prewarm_errors = []

        def _prewarm():
            try:
                # the NORMAL jit call with the production statics (one
                # 1-step program per mesh shape — the stepped driver's
                # in-loop call, solve/driver.py), NOT an AOT
                # lower/compile: AOT produces a SEPARATE executable
                # instance, so only the jit path leaves the stepped
                # driver's later calls as pure cache hits.  Reading
                # resnorm fences compile + one execution.  The device
                # queue serializes this throwaway step with the
                # concurrent coarse solve.
                out = solve_newton_layered(
                    ns_f, lp_f0.n2d, lp_f0.n_planes, lp_f0.bs,
                    lp_f0.arrays, mask_f0, g_f0, g_f0, lp_f0.E,
                    0.0, 0.0, 1, scfg.ksp_rtol, scfg.ksp_restart, 40,
                    scfg.pc_newton, mg_f0, scfg.ksp_type)
                float(out.resnorm)
                # the double-float refine program too (the second big
                # cold-start item): one throwaway stepped-refine
                # iteration with the
                # production statics — the kernels are traced pytree
                # leaves, so this is the same executable every Re
                refine_on = scfg.refine == "on" or (
                    scfg.refine == "auto"
                    and mask_f0.dtype == jnp.float32)
                if refine_on:
                    kdf0 = make_ns_sups_kernel_df(
                        "tetrahedron", nu=1.0 / Re, C_I=cfg.stab.C_I,
                        transposed_stab=(
                            cfg.stab.transposed_advection_in_stab))
                    dfr0 = DFResidual(W_f0, kdf0)
                    g_df0 = split64(g64_f0)
                    refine_newton_layered_stepped(
                        ns_f, kdf0, lp_f0.n2d, lp_f0.n_planes, lp_f0.bs,
                        lp_f0.E, lp_f0.arrays, dfr0.dfa, mask_f0,
                        g_df0.hi, g_df0.lo, out.x,
                        jnp.asarray(1.0, mask_f0.dtype),
                        scfg.newton_rtol, scfg.newton_atol, 1,
                        scfg.refine_ksp_rtol, scfg.ksp_restart,
                        scfg.refine_ksp_max_restarts, scfg.pc_newton,
                        mg_f0)
            except Exception as exc:    # re-raised before the fine solve
                prewarm_errors.append(exc)

        prewarm = threading.Thread(target=_prewarm, daemon=True)
        prewarm.start()

    if layered:
        W_c, lp_c, mask_c, g_c, g64_c, *mg_c = _setup_layered(
            mesh_c, inlet1, inlet2, dtype, mg_levels=mg_lv)
        mg_c = mg_c[0] if mg_c else None
        t0 = time.time()
        sres = solve_linear_layered(
            stokes_k, lp_c.n2d, lp_c.n_planes, lp_c.bs, lp_c.arrays,
            mask_c, g_c, lp_c.E, 1e-8, scfg.ksp_restart, scfg.pc, mg_c)
        timings["stokes"] = time.time() - t0
        t0 = time.time()
        x_rung = sres.x
        for r in re_ladder:
            nres_c = solve_newton_layered_stepped(
                ns_kernel(r) if r != re_ladder[-1] else ns_c,
                lp_c.n2d, lp_c.n_planes, lp_c.bs, lp_c.arrays,
                mask_c, g_c, x_rung, lp_c.E,
                scfg.newton_rtol, scfg.newton_atol, scfg.newton_max_it,
                scfg.ksp_rtol, scfg.ksp_restart, 40, scfg.pc_newton,
                mg_c, scfg.ksp_type)
            x_rung = nres_c.x
        timings["coarse_ns"] = time.time() - t0
    else:
        W_c, asm_c, mask_c, g_c, g64_c = _setup(mesh_c, inlet1, inlet2, dtype)
        pat = asm_c.pattern
        t0 = time.time()
        sres = solve_linear_bcsr(
            stokes_k, asm_c.ndofs, pat.nnzb, pat.bs, pat.n_rows,
            1e-8, scfg.ksp_restart, asm_c.arrays, mask_c, g_c)
        timings["stokes"] = time.time() - t0
        t0 = time.time()
        nres_c = solve_newton_bcsr(
            ns_c, asm_c.ndofs, pat.nnzb, pat.bs, pat.n_rows,
            asm_c.arrays, mask_c, g_c, sres.x,
            rtol=scfg.newton_rtol, atol=scfg.newton_atol,
            max_it=scfg.newton_max_it, ksp_rtol=scfg.ksp_rtol,
            ksp_restart=scfg.ksp_restart)
        timings["coarse_ns"] = time.time() - t0
    w_c = np.asarray(nres_c.x)

    # ---- fine mesh: NS from interpolated coarse ------------------------
    if not distinct_fine:
        mesh_f, W_f, w0_f = mesh_c, W_c, nres_c.x
        setup_f = (lp_c, mask_c, g_c, g64_c, mg_c) if layered else \
            (asm_c, mask_c, g_c, g64_c)
    elif fine_early is not None:
        mesh_f, W_f, setup_f = fine_early
        if prewarm is not None:
            t0 = time.time()
            prewarm.join(timeout=600.0)
            timings["prewarm_join"] = time.time() - t0
            if prewarm_errors:
                raise prewarm_errors[0]
        t0 = time.time()
        w0_f = jnp.asarray(interpolate_solution(mesh_c, W_c, w_c,
                                                mesh_f, W_f),
                           setup_f[1].dtype)
        w0_f = setup_f[1] * w0_f + (1.0 - setup_f[1]) * setup_f[2]
        timings["interpolate"] = time.time() - t0
    else:
        t0 = time.time()
        mesh_f, inner_loop, _ = generate_channel_mesh(
            img_fname, channel_mesh_size, cfg, layered=layered)
        timings["fine_mesh"] = time.time() - t0
        if layered:
            W_f, lp_f, mask_f, g_f, g64_f, *mg_f = _setup_layered(
                mesh_f, inlet1, inlet2, dtype, mg_levels=mg_lv)
            setup_f = (lp_f, mask_f, g_f, g64_f,
                       mg_f[0] if mg_f else None)
        else:
            W_f, asm_f, mask_f, g_f, g64_f = _setup(
                mesh_f, inlet1, inlet2, dtype)
            setup_f = (asm_f, mask_f, g_f, g64_f)
        t0 = time.time()
        w0_f = jnp.asarray(interpolate_solution(mesh_c, W_c, w_c,
                                                mesh_f, W_f),
                           setup_f[1].dtype)
        # re-impose BC values exactly on the fine mesh
        w0_f = setup_f[1] * w0_f + (1.0 - setup_f[1]) * setup_f[2]
        timings["interpolate"] = time.time() - t0

    return _fine_newton_refine(Re, cfg, mesh_f, W_f, setup_f, ns_f,
                               w0_f, timings, layered)


def _fine_newton_refine(Re, cfg, mesh_f, W_f, setup_f, ns_f, w0_f,
                        timings, layered):
    """Fine-mesh Newton + optional double-float refinement + result
    packaging — the shared tail of the continuation solve and the
    Reynolds-sweep warm path."""
    scfg = cfg.solver
    t0 = time.time()
    if layered:
        lp_f, mask_f, g_f, g64_f, mg_f = setup_f
        nres_f = solve_newton_layered_stepped(
            ns_f, lp_f.n2d, lp_f.n_planes, lp_f.bs, lp_f.arrays,
            mask_f, g_f, w0_f, lp_f.E,
            scfg.newton_rtol, scfg.newton_atol, scfg.newton_max_it,
            scfg.ksp_rtol, scfg.ksp_restart, 40, scfg.pc_newton, mg_f,
            scfg.ksp_type)
    else:
        asm_f, mask_f, g_f, g64_f = setup_f
        patf = asm_f.pattern
        nres_f = solve_newton_bcsr(
            ns_f, asm_f.ndofs, patf.nnzb, patf.bs, patf.n_rows,
            asm_f.arrays, mask_f, g_f, w0_f,
            rtol=scfg.newton_rtol, atol=scfg.newton_atol,
            max_it=scfg.newton_max_it, ksp_rtol=scfg.ksp_rtol,
            ksp_restart=scfg.ksp_restart)
    timings["fine_ns"] = time.time() - t0

    # ---- double-float refinement to reference tolerances on f32 --------
    refine_on = scfg.refine == "on" or (
        scfg.refine == "auto" and mask_f.dtype == jnp.float32)
    rres = None
    if refine_on:
        t0 = time.time()
        ndofs_f = int(mask_f.shape[0])
        kdf = make_ns_sups_kernel_df(
            "tetrahedron", nu=1.0 / Re, C_I=cfg.stab.C_I,
            transposed_stab=cfg.stab.transposed_advection_in_stab)
        dfr = DFResidual(W_f, kdf)
        g_df = split64(g64_f)
        if layered:
            # the small layered assembly-only program (shared with the
            # stepped Newton's tolerance probe — one executable, not a
            # second residual program to upload)
            n0 = residual_norm_layered(
                ns_f, lp_f.n2d, lp_f.n_planes, lp_f.bs, lp_f.arrays,
                mask_f, g_f, w0_f, lp_f.E)
        else:
            r0 = residual_of(ns_f, ndofs_f, asm_f.arrays, w0_f)
            n0 = jnp.linalg.norm(
                mask_f * r0 + (1.0 - mask_f) * (w0_f - g_f))
        if layered:
            rres = refine_newton_layered_stepped(
                ns_f, kdf, lp_f.n2d, lp_f.n_planes, lp_f.bs, lp_f.E,
                lp_f.arrays, dfr.dfa, mask_f, g_df.hi, g_df.lo,
                nres_f.x, n0, scfg.newton_rtol, scfg.newton_atol,
                scfg.refine_max_it, scfg.refine_ksp_rtol,
                scfg.ksp_restart, scfg.refine_ksp_max_restarts,
                scfg.pc_newton, mg_f)
        else:
            rres = refine_newton_bcsr(
                ns_f, kdf, asm_f.ndofs, patf.nnzb, patf.bs, patf.n_rows,
                asm_f.arrays, dfr.dfa, mask_f, g_df.hi, g_df.lo,
                nres_f.x, n0, scfg.newton_rtol, scfg.newton_atol,
                scfg.refine_max_it, scfg.refine_ksp_rtol,
                scfg.ksp_restart, scfg.refine_ksp_max_restarts)
        timings["refine"] = time.time() - t0

    if rres is not None:
        w = np.asarray(rres.x_hi)
        w_lo = np.asarray(rres.x_lo)
        u, p = W_f.split(np.asarray(rres.x_hi, np.float64) + w_lo)
        return ChannelSolution(
            mesh_f, W_f, w, np.asarray(u), np.asarray(p), Re,
            int(nres_f.iters), float(nres_f.resnorm),
            bool(rres.converged), timings,
            refined=True, refine_iters=int(rres.iters),
            refine_resnorm=float(rres.resnorm), w_lo=w_lo,
            refine_n0=float(n0),
            base_converged=bool(nres_f.converged))

    w = np.asarray(nres_f.x)
    u, p = W_f.split(w)
    return ChannelSolution(
        mesh_f, W_f, w, np.asarray(u), np.asarray(p), Re,
        int(nres_f.iters), float(nres_f.resnorm), bool(nres_f.converged),
        timings)


def _solve_ns_flow_warm(Re, img_fname, inlet1, inlet2, lc, cfg, dtype,
                        warm, timings):
    """Reynolds-sweep warm path: fine mesh + setup only, Newton from the
    previous Re's fine solution.  Returns None on shape mismatch (the
    caller falls back to the full continuation solve)."""
    scfg = cfg.solver
    t0 = time.time()
    mesh_f, _, _ = generate_channel_mesh(img_fname, lc, cfg, layered=True)
    timings["fine_mesh"] = time.time() - t0
    if (mesh_f.points.shape != warm.mesh.points.shape
            or mesh_f.cells.shape != warm.mesh.cells.shape):
        return None
    mg_lv = scfg.mg_levels if (scfg.pc.startswith("mg")
                               or scfg.pc_newton.startswith("mg")) else 0
    t0 = time.time()
    W_f, lp_f, mask_f, g_f, g64_f, *mg_f = _setup_layered(
        mesh_f, inlet1, inlet2, dtype, mg_levels=mg_lv)
    setup_f = (lp_f, mask_f, g_f, g64_f, mg_f[0] if mg_f else None)
    timings["fine_setup"] = time.time() - t0
    w0_f = jnp.asarray(np.asarray(warm.w), mask_f.dtype)
    # re-impose the (Re-independent) BC values exactly
    w0_f = mask_f * w0_f + (1.0 - mask_f) * g_f
    ns_f = make_ns_sups_kernel(
        "tetrahedron", nu=1.0 / Re, C_I=cfg.stab.C_I,
        transposed_stab=cfg.stab.transposed_advection_in_stab)
    return _fine_newton_refine(Re, cfg, mesh_f, W_f, setup_f, ns_f,
                               w0_f, timings, layered=True)


def solve_ns_flow_single_mesh(
    Re: float,
    img_fname: str,
    flowrate_ratio: float,
    channel_mesh_size: float = 0.1,
    cfg: Config = DEFAULT,
    layered: bool = True,
) -> ChannelSolution:
    """Single-mesh variant without coarse->fine continuation — the
    reference's OldNavierStokesChannelFlow.py pipeline (SURVEY.md 2.1:
    'Single-mesh variant of the flagship ... kept for reference')."""
    return solve_ns_flow(
        Re, img_fname, flowrate_ratio, channel_mesh_size, cfg,
        coarse_Re=Re, coarse_lc=channel_mesh_size, layered=layered)
