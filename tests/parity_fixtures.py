"""Matched-mesh parity fixtures (VERDICT round-1 item 5; BASELINE.md).

The north-star correctness bar is L2 < 1e-6 against the reference's fields
on matched meshes.  FEniCSx is not installable in this environment, so the
stored oracle fields are this framework's own CPU-f64 solves — which the
physics tests independently cross-check against analytic/literature
oracles (Poiseuille exact profile in test_stokes_duct.py, Ghia cavity
values in test_cavity.py, DFG coefficients in test_dfg.py), the same
solutions FEniCSx converges to at these tolerances (reference SNES
rtol=atol=1e-8, NavierStokes/NavierStokesChannelFlow.py:281-283).

test_parity.py then pins, per case:
  (a) regression — a fresh f64 solve matches the stored field, and
  (b) the f32 + double-float-refinement path (the default f32
      configuration) matches the stored f64 field to L2 < 1e-6.

Regenerate with:  python tests/parity_fixtures.py
"""

import os
import pathlib

import numpy as np

FIXTURE_DIR = pathlib.Path(__file__).parent / "fixtures"

DUCT = dict(n_cross=6, n_axial=12, length=2.0, Re=20.0)
CAVITY = dict(n=24, Re=100.0)
CHANNEL = dict(Re=10.0, ratio=0.5, lc=0.12, shape="circle")
# production scale (VERDICT round-2 item 9): the lc the reference's
# NavierStokesChannelFlow.py runs at (~230k dofs).  Generated with
# `python tests/parity_fixtures.py production` (hours on the CPU host);
# consumed by the PARITY_PROD=1-gated tests in test_parity.py.
CHANNEL_PROD = dict(Re=10.0, ratio=0.5, lc=0.04, shape="circle")


def duct_problem(dtype, n_cross, n_axial, length, Re):
    """Stabilized SUPS NS in a square duct (matches the flagship's form;
    reference NavierStokesChannelFlow.py:220-266 on the duct geometry of
    StokesFlow/DuctStokesFlow.py:39-142)."""
    import jax.numpy as jnp

    from stabilized_navier_stokes_flow_fenicsx.assemble.assembly import (
        assembler_for_mixed)
    from stabilized_navier_stokes_flow_fenicsx.fem.bc import (
        DirichletBC, bc_mask, bc_vector, combine_bcs)
    from stabilized_navier_stokes_flow_fenicsx.fem.space import (
        make_mixed_space)
    from stabilized_navier_stokes_flow_fenicsx.mesh.structured import (
        duct_mesh)
    from stabilized_navier_stokes_flow_fenicsx.utils.exact import (
        square_duct_mean, square_duct_profile)

    mesh = duct_mesh(n_cross, n_axial, length=length)
    W = make_mixed_space(mesh, 1, 1)
    asm = assembler_for_mixed(W, dtype=dtype)
    wall = mesh.nodes_with_marker(4)
    inlet = mesh.nodes_with_marker(1)
    outlet = mesh.nodes_with_marker(3)

    def vdofs(nodes):
        return np.stack(
            [W.velocity_dof(nodes, c) for c in range(3)], -1).ravel()

    iv = np.zeros((len(inlet), 3))
    yz = mesh.points[inlet][:, 1:3]
    iv[:, 0] = square_duct_profile(yz[:, 0], yz[:, 1]) / square_duct_mean()
    bc = combine_bcs([
        DirichletBC(vdofs(wall), np.zeros(3 * len(wall))),
        DirichletBC(vdofs(inlet), iv.ravel()),
        DirichletBC(W.pressure_dof(outlet), np.zeros(len(outlet))),
    ])
    g64 = bc_vector(W.ndofs, bc)
    mask = jnp.asarray(bc_mask(W.ndofs, bc), asm.dtype)
    g = jnp.asarray(g64, asm.dtype)
    return W, asm, mask, g, g64


def solve_duct_ns(dtype, refine: bool):
    """Returns the solution vector as f64 (hi+lo when refined)."""
    import jax.numpy as jnp

    from stabilized_navier_stokes_flow_fenicsx.assemble.df_assembly import (
        DFResidual)
    from stabilized_navier_stokes_flow_fenicsx.forms.navier_stokes import (
        make_ns_sups_kernel)
    from stabilized_navier_stokes_flow_fenicsx.forms.navier_stokes_df import (
        make_ns_sups_kernel_df, split64)
    from stabilized_navier_stokes_flow_fenicsx.solve.driver import (
        refine_newton_bcsr, solve_newton_bcsr)

    W, asm, mask, g, g64 = duct_problem(dtype, **{
        k: v for k, v in DUCT.items()})
    nu = 1.0 / DUCT["Re"]
    kern = make_ns_sups_kernel("tetrahedron", nu=nu)
    pat = asm.pattern
    out = solve_newton_bcsr(
        kern, asm.ndofs, pat.nnzb, pat.bs, pat.n_rows, asm.arrays,
        mask, g, jnp.zeros(asm.ndofs, asm.dtype),
        rtol=1e-10, atol=1e-10, max_it=30,
        ksp_rtol=1e-6 if refine else 1e-10)
    if not refine:
        assert bool(out.converged)
        return np.asarray(out.x, np.float64)
    kdf = make_ns_sups_kernel_df("tetrahedron", nu=nu)
    dfr = DFResidual(W, kdf)
    g_df = split64(g64)
    zero = jnp.zeros(asm.ndofs, asm.dtype)
    n0 = jnp.linalg.norm(
        mask * asm.residual(kern, zero) + (1.0 - mask) * (zero - g))
    rres = refine_newton_bcsr(
        kern, kdf, asm.ndofs, pat.nnzb, pat.bs, pat.n_rows,
        asm.arrays, dfr.dfa, mask, g_df.hi, g_df.lo, out.x, n0,
        1e-8, 0.0, 12, 1e-2)
    assert bool(rres.converged), float(rres.resnorm)
    return np.asarray(rres.x_hi, np.float64) + np.asarray(rres.x_lo)


def solve_cavity_ns(dtype):
    from stabilized_navier_stokes_flow_fenicsx.apps.lid_driven import (
        solve_lid_driven)
    from stabilized_navier_stokes_flow_fenicsx.config import SolverConfig

    # the cavity Jacobian is ill-conditioned (~1e4 relative): two solves
    # both at residual 1e-8*n0 can differ by ~1e-5 in L2.  Converge both
    # the f64 oracle and the refined f32 run to 1e-11 so the parity bound
    # is set by conditioning * 1e-11 << 1e-6.
    cfg = SolverConfig(newton_rtol=1e-11, newton_atol=0.0,
                       ksp_rtol=1e-10, refine_max_it=25)
    r = solve_lid_driven(CAVITY["n"], CAVITY["Re"], solver=cfg, dtype=dtype)
    assert r.converged, (r.newton_resnorm, r.refine_resnorm)
    if r.refined:
        return np.asarray(r.w, np.float64) + np.asarray(r.w_lo)
    return np.asarray(r.w, np.float64)


def channel_image(tmpdir="/tmp"):
    from stabilized_navier_stokes_flow_fenicsx.utils.testimg import (
        make_annulus_image)

    img = os.path.join(tmpdir, f"parity_{CHANNEL['shape']}.png")
    if not os.path.exists(img):
        make_annulus_image(img, CHANNEL["shape"])
    return img


def solve_channel_ns(dtype=None, case=CHANNEL):
    """dtype=float32 exercises the f32 configuration (auto-refinement);
    dtype=None/float64 under x64 generates the oracle field."""
    from stabilized_navier_stokes_flow_fenicsx.flow.channel import (
        solve_ns_flow)

    sol = solve_ns_flow(
        case["Re"], channel_image(), case["ratio"],
        channel_mesh_size=case["lc"], coarse_lc=case["lc"],
        dtype=dtype)
    assert sol.converged
    w = np.asarray(sol.w, np.float64)
    if sol.refined:
        w = w + np.asarray(sol.w_lo)
    return w


def generate():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    FIXTURE_DIR.mkdir(exist_ok=True)
    w = solve_duct_ns(jnp.float64, refine=False)
    np.savez_compressed(FIXTURE_DIR / "duct_ns.npz", w=w, **DUCT)
    print("duct_ns:", w.shape, "|w|", np.linalg.norm(w))

    w = solve_cavity_ns(jnp.float64)
    np.savez_compressed(FIXTURE_DIR / "cavity_ns.npz", w=w, **CAVITY)
    print("cavity_ns:", w.shape, "|w|", np.linalg.norm(w))

    w = solve_channel_ns()
    np.savez_compressed(
        FIXTURE_DIR / "channel_ns.npz", w=w,
        **{k: v for k, v in CHANNEL.items() if k != "shape"})
    print("channel_ns:", w.shape, "|w|", np.linalg.norm(w))


def generate_production():
    """lc=0.04 oracle (CPU f64, hours on the single-core host) —
    regenerates fixtures/channel_ns_prod.npz only."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    FIXTURE_DIR.mkdir(exist_ok=True)
    w = solve_channel_ns(case=CHANNEL_PROD)
    np.savez_compressed(
        FIXTURE_DIR / "channel_ns_prod.npz", w=w,
        **{k: v for k, v in CHANNEL_PROD.items() if k != "shape"})
    print("channel_ns_prod:", w.shape, "|w|", np.linalg.norm(w))


if __name__ == "__main__":
    import sys

    if "production" in sys.argv[1:]:
        generate_production()
    else:
        generate()
