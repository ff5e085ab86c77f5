"""Layered (plane-structured) operator vs generic block-CSR equivalence."""

import numpy as np
import pytest

import jax.numpy as jnp

from stabilized_navier_stokes_flow_fenicsx.assemble.assembly import (
    assembler_for_mixed)
from stabilized_navier_stokes_flow_fenicsx.assemble.layered import (
    build_layered, layered_matvec, matrix_values_layered)
from stabilized_navier_stokes_flow_fenicsx.fem.space import (
    make_mixed_space)
from stabilized_navier_stokes_flow_fenicsx.forms.navier_stokes import (
    make_ns_sups_kernel)
from stabilized_navier_stokes_flow_fenicsx.mesh.extrude import (
    extrude_channel)
from stabilized_navier_stokes_flow_fenicsx.mesh.image import (
    get_contours, load_image, optimize_contour)
from stabilized_navier_stokes_flow_fenicsx.mesh.tri2d import (
    triangulate_cross_section)
from stabilized_navier_stokes_flow_fenicsx.utils.testimg import (
    make_annulus_image)


@pytest.fixture(scope="module")
def channel(tmp_path_factory):
    img = str(tmp_path_factory.mktemp("lay") / "c.png")
    make_annulus_image(img, "circle", size=300)
    g = load_image(img)
    cs = get_contours(g)
    co, _ = optimize_contour(cs[0], cutoff=0.15, mesh_lc_frac=0.01)
    ci, _ = optimize_contour(cs[1], cutoff=0.15, mesh_lc_frac=0.01)
    inner = ci[:, [1, 0]]
    tri = triangulate_cross_section(inner, co[:, [1, 0]], lc=0.09)
    mesh = extrude_channel(tri, inner, lc=0.09, compact=False)
    return mesh


def test_layered_matvec_matches_bcsr(channel):
    mesh = channel
    n2d, n_planes, used = mesh.layered
    W = make_mixed_space(mesh, 1, 1)
    lp = build_layered(W, n2d, n_planes)
    asm = assembler_for_mixed(W)
    kern = make_ns_sups_kernel("tetrahedron", nu=0.1)
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.normal(size=W.ndofs) * 0.1)
    x = jnp.asarray(rng.normal(size=W.ndofs))

    vals_bcsr = asm.matrix_values(kern, w)
    y_ref = np.asarray(asm.matvec(vals_bcsr, x))

    vals_lay = matrix_values_layered(
        kern, lp.E, n_planes, lp.bs, lp.arrays, w)
    assert vals_lay.shape == (4, 4, 3, lp.E, n_planes)
    y_lay = np.asarray(layered_matvec(lp.arrays, n2d, n_planes, vals_lay, x))
    np.testing.assert_allclose(y_lay, y_ref, rtol=0, atol=1e-11)


def test_layered_channel_solution_matches(channel, tmp_path):
    """Full pipeline: layered and BCSR paths give the same fields."""
    from stabilized_navier_stokes_flow_fenicsx.flow.channel import (
        solve_ns_flow)
    from stabilized_navier_stokes_flow_fenicsx.utils.testimg import (
        make_annulus_image)

    img = str(tmp_path / "c.png")
    make_annulus_image(img, "circle", size=300)
    sol_l = solve_ns_flow(5, img, 0.5, channel_mesh_size=0.12,
                          coarse_lc=0.12, layered=True)
    sol_b = solve_ns_flow(5, img, 0.5, channel_mesh_size=0.12,
                          coarse_lc=0.12, layered=False)
    assert sol_l.converged and sol_b.converged
    used = sol_l.mesh.layered[2]
    err = np.abs(sol_l.u[used] - sol_b.u).max() \
        / (np.abs(sol_b.u).max() + 1e-30)
    assert err < 1e-9


def test_stepped_newton_matches_monolithic(channel):
    """solve_newton_layered_stepped (one program per Newton step)
    reaches the same solution as the one-jit Newton."""
    from stabilized_navier_stokes_flow_fenicsx.solve.driver import (
        solve_newton_layered, solve_newton_layered_stepped)
    import jax.numpy as jnp

    mesh = channel
    n2d, n_planes, used = mesh.layered
    W = make_mixed_space(mesh, 1, 1)
    lp = build_layered(W, n2d, n_planes)
    kern = make_ns_sups_kernel("tetrahedron", nu=0.5)
    # mask: constrain boundary-ish dofs via a simple deterministic rule
    rng = np.random.default_rng(7)
    mask = jnp.asarray(
        (rng.uniform(size=W.ndofs) > 0.2).astype(np.float64))
    g = jnp.asarray(rng.normal(size=W.ndofs) * 0.05) * (1.0 - mask)
    w0 = g

    mono = solve_newton_layered(
        kern, n2d, n_planes, lp.bs, lp.arrays, mask, g, w0, lp.E,
        1e-10, 0.0, 8, 1e-8, 50, 40, "plane_gs")
    step = solve_newton_layered_stepped(
        kern, n2d, n_planes, lp.bs, lp.arrays, mask, g, w0, lp.E,
        1e-10, 0.0, 8, 1e-8, 50, 40, "plane_gs")
    assert bool(mono.converged) == bool(step.converged)
    xm, xs = np.asarray(mono.x), np.asarray(step.x)
    rel = np.linalg.norm(xm - xs) / max(np.linalg.norm(xm), 1e-30)
    assert rel < 1e-6, rel


def test_newton_tfqmr_matches_fgmres(channel):
    """ksp="tfqmr" (the reference's SNES KSP, NavierStokesChannelFlow.py:
    198-202) reaches the same Newton solution as the FGMRES default."""
    from stabilized_navier_stokes_flow_fenicsx.solve.driver import (
        solve_newton_layered)

    mesh = channel
    n2d, n_planes, used = mesh.layered
    W = make_mixed_space(mesh, 1, 1)
    lp = build_layered(W, n2d, n_planes)
    kern = make_ns_sups_kernel("tetrahedron", nu=0.5)
    rng = np.random.default_rng(7)
    mask = jnp.asarray(
        (rng.uniform(size=W.ndofs) > 0.2).astype(np.float64))
    g = jnp.asarray(rng.normal(size=W.ndofs) * 0.05) * (1.0 - mask)
    w0 = g

    base = solve_newton_layered(
        kern, n2d, n_planes, lp.bs, lp.arrays, mask, g, w0, lp.E,
        1e-10, 0.0, 8, 1e-8, 50, 40, "plane_gs")
    tf = solve_newton_layered(
        kern, n2d, n_planes, lp.bs, lp.arrays, mask, g, w0, lp.E,
        1e-10, 0.0, 8, 1e-8, 50, 40, "plane_gs", None, "tfqmr")
    assert bool(tf.converged)
    xb, xt = np.asarray(base.x), np.asarray(tf.x)
    rel = np.linalg.norm(xb - xt) / max(np.linalg.norm(xb), 1e-30)
    assert rel < 1e-6, rel


def test_structured_soa_residual_and_path(channel):
    """SoA structured residual == generic segment-sum residual, and the
    build records the SoA path (round 4, assemble/structured.py)."""
    from stabilized_navier_stokes_flow_fenicsx.assemble.assembly import (
        AsmArrays, residual_of)
    from stabilized_navier_stokes_flow_fenicsx.assemble.layered import (
        residual_layered)

    mesh = channel
    n2d, n_planes, _ = mesh.layered
    W = make_mixed_space(mesh, 1, 1)
    lp = build_layered(W, n2d, n_planes)
    assert lp.asm_path == "structured_soa"
    kern = make_ns_sups_kernel("tetrahedron", nu=0.1)
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.normal(size=W.ndofs) * 0.1)

    a = lp.arrays
    asm_a = AsmArrays(cell_dofs=a.cell_dofs, cell_coords=a.cell_coords,
                      indices=a.cols, row_ids=a.row_ids,
                      ell_pos=a.ell_pos, diag_pos=a.diag_pos)
    r_ref = np.asarray(residual_of(kern, lp.ndofs, asm_a, w))
    r_soa = np.asarray(residual_layered(kern, n2d, n_planes, lp.bs, a, w))
    np.testing.assert_allclose(r_soa, r_ref, rtol=0,
                               atol=1e-12 * max(1.0, np.abs(r_ref).max()))


def test_structured_soa_vs_aos_jacobian(channel, monkeypatch):
    """SoA and AoS structured Jacobian buffers agree through the shared
    reduction (same mesh, same kernel, f64)."""
    import os

    mesh = channel
    n2d, n_planes, _ = mesh.layered
    W = make_mixed_space(mesh, 1, 1)
    kern = make_ns_sups_kernel("tetrahedron", nu=0.1)
    rng = np.random.default_rng(2)
    lp = build_layered(W, n2d, n_planes)
    w = jnp.asarray(rng.normal(size=W.ndofs) * 0.1)
    V_soa = matrix_values_layered(kern, lp.E, n_planes, lp.bs,
                                  lp.arrays, w)
    monkeypatch.setitem(os.environ, "NS_NO_SOA", "1")
    lp_aos = build_layered(W, n2d, n_planes)
    assert lp_aos.asm_path == "structured"
    V_aos = matrix_values_layered(kern, lp_aos.E, n_planes, lp_aos.bs,
                                  lp_aos.arrays, w)
    np.testing.assert_allclose(np.asarray(V_soa), np.asarray(V_aos),
                               rtol=0, atol=1e-11)
