"""DFG 3D pillar benchmark (3D-1Z, Re=20).

Replicates reference NavierStokes/Validation_Flow/DFG_3D_Validation.py:
channel [0,2.2]x[0,0.41]x[0,0.41] with a circular pillar (c=(0.5,0.2),
r=0.05) extruded through the span (dfg_pillar_3D.geo:33-36,96);
bi-parabolic inlet u_x = 0.45 * 16 y z (0.41-y)(0.41-z)/0.41^4 (:103-106);
Stokes init -> G-metric SUPS Navier-Stokes at nu = 1e-3 (:193);
drag/lift from the traction integral sigma.(-n) over the pillar with
C = 2F/(rho Uc^2 Lc), Uc = 0.2, Lc = 0.041 (:344-367).

Markers: 2 = inlet, 3 = outlet, 4 = walls (incl. z-planes), 5 = obstacle.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..assemble.assembly import assembler_for_mixed
from ..config import SolverConfig
from ..fem.bc import DirichletBC, bc_mask, bc_vector, combine_bcs
from ..fem.space import make_mixed_space
from ..flow.forces import traction_force_3d
from ..forms.navier_stokes import make_ns_sups_kernel
from ..forms.stokes import make_stokes_kernel
from ..mesh.core import SimplexMesh, mark_boundary_facets
from ..mesh.extrude import extrude_tri_mesh
from ..mesh.sizefield import (
    merge_meshes, structured_annulus, triangulate_sizefield)
from ..solve.newton_host import linear_host_lu, newton_host_lu

L, W = 2.2, 0.41
CX, CY, R = 0.5, 0.2, 0.05
NU = 1e-3
UC, LC_REF = 0.2, 0.1 * 0.41


def dfg3d_mesh(scale: float = 1.0, cyl_factor: float = 1.0,
               symmetric_band: bool = True,
               near_growth: float = 0.3) -> SimplexMesh:
    """cyl_factor < 1 refines the pillar neighbourhood only (the drag
    error is dominated by the surface/boundary-layer resolution);
    symmetric_band glues a structured annulus into the cross-section
    (see dfg2d / mesh/sizefield.py) before extruding through the span;
    near_growth sets the in-plane size growth off the pillar (the 2D
    lift-accuracy axis, apps/dfg2d.py — the 3D default stays 0.3
    because every in-plane cell is extruded through the whole span)."""
    lc_far = 0.09 * scale
    lc_wake = 0.035 * scale
    lc_cyl = 0.014 * scale * cyl_factor

    def lc_fn(p):
        p = np.atleast_2d(p)
        d = np.hypot(p[:, 0] - CX, p[:, 1] - CY) - R
        near = lc_cyl + near_growth * np.maximum(d, 0.0)
        wake = np.where(
            (p[:, 0] > CX) & (p[:, 0] < 1.4) & (np.abs(p[:, 1] - CY) < 0.15),
            lc_wake, lc_far)
        return np.minimum(near, wake)

    rect = np.array([[0, 0], [L, 0], [L, W], [0, W]], dtype=float)
    center = np.array([CX, CY])
    if symmetric_band:
        apts, atris, _inner, outer_ids = structured_annulus(
            center, R, lc_cyl, n_layers=3)
        ann = SimplexMesh("triangle", apts, atris).orient_positive()
        tri = triangulate_sizefield(
            rect, [], lc_fn, lc_min=lc_cyl,
            fixed_hole_loops=[apts[outer_ids]])
        tri = merge_meshes(tri, ann)
    else:
        th = np.linspace(0, 2 * np.pi, 128, endpoint=False)
        circle = np.stack(
            [CX + R * np.cos(th), CY + R * np.sin(th)], axis=1)
        tri = triangulate_sizefield(rect, [circle], lc_fn, lc_min=lc_cyl)
    # span resolution follows the UNSCALED cylinder lc (the z-direction
    # needs no extra refinement when cyl_factor shrinks in-plane cells)
    n_layers = max(4, int(np.ceil(W / (2.5 * 0.014 * scale))))
    msh = extrude_tri_mesh(tri, np.linspace(0.0, W, n_layers + 1))
    eps = 1e-9

    def on_pillar(p):
        return np.hypot(p[:, 0] - CX, p[:, 1] - CY) < R + 0.25 * lc_cyl

    mark_boundary_facets(msh, {
        2: lambda p: p[:, 0] < eps,
        3: lambda p: p[:, 0] > L - eps,
        5: on_pillar,
    }, default=4)
    return msh


@dataclasses.dataclass
class DFG3DResult:
    mesh: SimplexMesh
    u: np.ndarray
    p: np.ndarray
    cd: float                    # consistent reaction-force evaluation
    cl: float
    newton_iters: int
    converged: bool
    cd_surface: float = float("nan")   # reference traction integral
    cl_surface: float = float("nan")


def solve_dfg3d_fine(scale: float = 0.5,
                     cyl_factor: float = 1.0,
                     near_growth: float = 0.15,
                     ksp_rtol: float = 1e-5,
                     pc: str = "mg_cheby6_bf16",
                     mg_levels: int = 3) -> DFG3DResult:
    """DFG 3D-1Z at ~10^6-node meshes on the layered path
    (VERDICT round-4 item 5: validate the 3D lift at a mesh where the
    0.15%-of-drag signal clears the discretization noise floor).

    The pillar mesh is a z-extrusion with plane-major node ids
    (mesh/extrude.py::extrude_tri_mesh), which is exactly the contract
    of the layered operator (assemble/layered.py:99) — the extrusion
    axis never enters the pattern build, so the whole channel fast
    path (plane-structured assembly, mg-Chebyshev V-cycle, stepped
    Newton, double-float refinement) applies verbatim.  The host-LU
    path (solve_dfg3d) tops out near ~30k nodes on one core; this
    routine solves 4M+ dofs in minutes on one chip.

    Forces use the same consistent reaction functional, evaluated from
    the RAW layered residual (no BC substitution), plus the reference's
    traction surface integral for parity.
    """
    import time as _time

    from ..assemble.layered import build_layered, residual_layered
    from ..forms.navier_stokes_df import make_ns_sups_kernel_df
    from ..solve.driver import (refine_newton_layered_stepped,
                                solve_newton_layered_stepped)
    from ..solve.mg import build_mg_hierarchy

    t_all = _time.time()
    mesh = dfg3d_mesh(scale, cyl_factor=cyl_factor,
                      near_growth=near_growth)
    Wsp = make_mixed_space(mesh, 1, 1)
    np2 = len(mesh.points) // len(np.unique(mesh.points[:, 2]))
    Lp = len(mesh.points) // np2
    lp = build_layered(Wsp, np2, Lp)

    inlet = mesh.nodes_with_marker(2)
    walls = mesh.nodes_with_marker(4)
    obst = mesh.nodes_with_marker(5)

    def vdofs(nodes):
        return np.stack(
            [Wsp.velocity_dof(nodes, c) for c in range(3)], -1).ravel()

    iv = np.zeros((len(inlet), 3))
    y, z = mesh.points[inlet, 1], mesh.points[inlet, 2]
    iv[:, 0] = (4 * y * (W - y) / W**2) * (4 * z * (W - z) / W**2) * 0.45
    bc = combine_bcs([
        DirichletBC(vdofs(inlet), iv.ravel()),
        DirichletBC(vdofs(walls), np.zeros(3 * len(walls))),
        DirichletBC(vdofs(obst), np.zeros(3 * len(obst))),
    ])
    dtype = jnp.zeros(0).dtype
    mask = jnp.asarray(bc_mask(Wsp.ndofs, bc), dtype)
    g = jnp.asarray(bc_vector(Wsp.ndofs, bc), dtype)
    hier = build_mg_hierarchy(
        np.asarray(lp.pattern_like.row_ids),
        np.asarray(lp.pattern_like.indices),
        lp.n2d, lp.n_planes, np.asarray(mask), lp.bs,
        n_levels=mg_levels)
    print(f"dfg3d_fine: {len(mesh.points)} nodes, {mesh.n_cells} tets, "
          f"{Wsp.ndofs} dofs, n2d={np2} Lp={Lp} "
          f"(setup {_time.time() - t_all:.1f}s)", flush=True)

    # nu continuation to the target viscosity (textbook SUPS residual,
    # see solve_dfg3d's transposed_stab note)
    x = g
    for nu_step in (1e-1, 1e-2, 3e-3, NU):
        ns_k = make_ns_sups_kernel("tetrahedron", nu=nu_step,
                                   transposed_stab=False)
        t0 = _time.time()
        nres = solve_newton_layered_stepped(
            ns_k, lp.n2d, lp.n_planes, lp.bs, lp.arrays, mask, g,
            x, lp.E, 1e-8, 1e-9, 30, ksp_rtol, 50, 40, pc, hier)
        x = nres.x
        print(f"dfg3d_fine: nu={nu_step} its={int(nres.iters)} "
              f"|F|={float(nres.resnorm):.3e} "
              f"({_time.time() - t0:.1f}s)", flush=True)

    # double-float refinement at the target nu (f32 chip, f64 result)
    kdf = make_ns_sups_kernel_df("tetrahedron", nu=NU,
                                 transposed_stab=False)
    from ..assemble.df_assembly import DFResidual
    from ..forms.navier_stokes_df import split64

    dfr = DFResidual(Wsp, kdf)
    g_df = split64(np.asarray(g, np.float64))
    r_raw = residual_layered(ns_k, lp.n2d, lp.n_planes, lp.bs,
                             lp.arrays, x)
    n0 = jnp.linalg.norm(mask * r_raw + (1.0 - mask) * (x - g))
    t0 = _time.time()
    rres = refine_newton_layered_stepped(
        ns_k, kdf, lp.n2d, lp.n_planes, lp.bs, lp.E, lp.arrays,
        dfr.dfa, mask, g_df.hi, g_df.lo, x, n0,
        1e-8, 1e-10, 8, 1e-2, 50, 8, pc, hier)
    print(f"dfg3d_fine: refine its={int(rres.iters)} "
          f"df|F|={float(rres.resnorm):.3e} "
          f"({_time.time() - t0:.1f}s)", flush=True)
    w64 = np.asarray(rres.x_hi, np.float64) + np.asarray(rres.x_lo)

    # consistent reaction force from the RAW residual (f64 via the
    # df evaluation path would be ideal; the f32 residual at the f64
    # iterate is accurate to ~1e-6 of the force scale, well below the
    # lift bar at these meshes)
    w_dev = jnp.asarray(w64, dtype)
    r = np.asarray(residual_layered(
        ns_k, lp.n2d, lp.n_planes, lp.bs, lp.arrays, w_dev))
    F = np.array([
        -r[np.asarray(Wsp.velocity_dof(obst, c))].sum()
        for c in range(3)])
    cd = 2 * F[0] / (UC**2 * LC_REF)
    cl = 2 * F[1] / (UC**2 * LC_REF)
    u, p = Wsp.split(w64)
    u, p = np.asarray(u), np.asarray(p)
    Fs = -traction_force_3d(mesh, u, p, 5, NU)
    cd_s = 2 * Fs[0] / (UC**2 * LC_REF)
    cl_s = 2 * Fs[1] / (UC**2 * LC_REF)
    print(f"dfg3d_fine: Cd={cd:.5f} Cl={cl:.6f} "
          f"(surface Cd={cd_s:.5f} Cl={cl_s:.6f}) "
          f"total {_time.time() - t_all:.1f}s", flush=True)
    return DFG3DResult(mesh, u, p, float(cd), float(cl),
                       int(nres.iters),
                       bool(rres.converged) or bool(nres.converged),
                       float(cd_s), float(cl_s))


def solve_dfg3d(scale: float = 1.0,
                solver: Optional[SolverConfig] = None,
                **mesh_kwargs) -> DFG3DResult:
    cfg = solver or SolverConfig()
    mesh = dfg3d_mesh(scale, **mesh_kwargs)
    Wsp = make_mixed_space(mesh, 1, 1)
    asm = assembler_for_mixed(Wsp)

    inlet = mesh.nodes_with_marker(2)
    walls = mesh.nodes_with_marker(4)
    obst = mesh.nodes_with_marker(5)

    def vdofs(nodes):
        return np.stack(
            [Wsp.velocity_dof(nodes, c) for c in range(3)], -1).ravel()

    iv = np.zeros((len(inlet), 3))
    y, z = mesh.points[inlet, 1], mesh.points[inlet, 2]
    iv[:, 0] = (4 * y * (W - y) / W**2) * (4 * z * (W - z) / W**2) * 0.45
    bc = combine_bcs([
        DirichletBC(vdofs(inlet), iv.ravel()),
        DirichletBC(vdofs(walls), np.zeros(3 * len(walls))),
        DirichletBC(vdofs(obst), np.zeros(3 * len(obst))),
    ])
    mask = jnp.asarray(bc_mask(Wsp.ndofs, bc), asm.dtype)
    g = jnp.asarray(bc_vector(Wsp.ndofs, bc), asm.dtype)

    stokes_k = make_stokes_kernel("tetrahedron", nu=1.0, mu_T_coeff=0.2)
    x = jnp.asarray(linear_host_lu(asm, stokes_k, mask, g))

    # transposed_stab=False: the textbook SUPS residual (u.grad)u, not the
    # reference's UFL dot(u, grad(u)) quirk ((grad u)^T u).  The quirk
    # residual is inconsistent (nonzero at the exact solution), which
    # poisons the consistent reaction-force functional: measured Cd
    # DIVERGES 7.27 -> 7.54 -> 8.03 under refinement with the quirk, and
    # converges with the textbook form.  The production channel solver
    # keeps the quirk behind its flag for field parity; validation apps
    # validate physics.
    for nu_step in (1e-1, 1e-2, 3e-3, NU):
        ns_k = make_ns_sups_kernel("tetrahedron", nu=nu_step,
                                   transposed_stab=False)
        nres = newton_host_lu(asm, ns_k, mask, g, x,
                              rtol=1e-8, atol=1e-9,
                              max_it=cfg.newton_max_it)
        x = jnp.asarray(nres.x)

    w = np.asarray(nres.x)
    u, p = Wsp.split(w)
    u, p = np.asarray(u), np.asarray(p)
    # consistent reaction force (superconvergent; see flow/forces.py)
    from ..flow.forces import reaction_force

    F = reaction_force(asm, ns_k, Wsp, mesh, w, 5)
    cd = 2 * F[0] / (UC**2 * LC_REF)
    cl = 2 * F[1] / (UC**2 * LC_REF)
    # the reference's traction surface integral, kept for parity
    Fs = -traction_force_3d(mesh, u, p, 5, NU)
    cd_s = 2 * Fs[0] / (UC**2 * LC_REF)
    cl_s = 2 * Fs[1] / (UC**2 * LC_REF)
    return DFG3DResult(mesh, u, p, float(cd), float(cl),
                       int(nres.iters), bool(nres.converged),
                       cd_surface=float(cd_s), cl_surface=float(cl_s))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    scale = float(argv[0]) if argv else 1.5
    r = solve_dfg3d(scale)
    print(f"Velocity Degrees of Freedom: {3 * r.mesh.n_nodes}")
    print(f"Coefficient of Lift: {r.cl}")
    print(f"Coefficient of Drag: {r.cd}")
    return r


if __name__ == "__main__":
    main()
