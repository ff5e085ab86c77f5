"""Multigrid preconditioner: mesh-independence and correctness.

VERDICT round-1 item 6: block-Jacobi/plane-GS Krylov counts grow ~1/h;
the aggregation MG V-cycle (solve/mg.py) must hold them ~flat.  The
reference's analogue is ASM robustness at 1e-8 tolerances
(NavierStokes/NavierStokesChannelFlow.py:197-202).
"""

import os

import numpy as np
import pytest

from stabilized_navier_stokes_flow_fenicsx.config import DEFAULT
from stabilized_navier_stokes_flow_fenicsx.flow.channel import (
    _setup_layered, generate_channel_mesh)
from stabilized_navier_stokes_flow_fenicsx.flow.inlet import (
    solve_inlet_profiles)
from stabilized_navier_stokes_flow_fenicsx.forms.stokes import (
    make_stokes_kernel)
from stabilized_navier_stokes_flow_fenicsx.solve.driver import (
    solve_linear_layered)
from stabilized_navier_stokes_flow_fenicsx.utils.testimg import (
    make_annulus_image)


@pytest.fixture(scope="module")
def channel_image(tmp_path_factory):
    img = str(tmp_path_factory.mktemp("mg") / "circle.png")
    make_annulus_image(img, "circle")
    return img


def _solve(img, lc, pc):
    inlet1, inlet2 = solve_inlet_profiles(img, 0.5, DEFAULT)
    mesh, _, _ = generate_channel_mesh(img, lc, DEFAULT, layered=True)
    mg_lv = 3 if pc.startswith("mg") else 0
    W, lp, mask, g, g64, *hier = _setup_layered(
        mesh, inlet1, inlet2, mg_levels=mg_lv)
    kern = make_stokes_kernel("tetrahedron", nu=1.0, mu_T_coeff=0.2)
    res = solve_linear_layered(
        kern, lp.n2d, lp.n_planes, lp.bs, lp.arrays, mask, g, lp.E,
        1e-8, 50, pc, hier[0] if hier else None)
    return res, np.asarray(res.x)


def test_mg_iterations_near_flat(channel_image):
    """Refining lc 0.15 -> 0.085 roughly doubles 1/h; MG iteration counts
    must stay within 1.6x while plane-GS demonstrably grows faster."""
    res_c, x_c = _solve(channel_image, 0.15, "mg")
    res_f, x_f = _solve(channel_image, 0.085, "mg")
    assert bool(res_c.converged) and bool(res_f.converged)
    assert int(res_f.iters) <= 1.6 * int(res_c.iters), (
        int(res_c.iters), int(res_f.iters))

    pg_c, _ = _solve(channel_image, 0.15, "plane_gs")
    pg_f, _ = _solve(channel_image, 0.085, "plane_gs")
    # the growth MG removes is real on this problem
    assert int(pg_f.iters) > 1.6 * int(pg_c.iters), (
        int(pg_c.iters), int(pg_f.iters))
    # and MG genuinely beats plane-GS at the finer size
    assert int(res_f.iters) < int(pg_f.iters) / 3


def test_mg_solution_matches_plane_gs(channel_image):
    """Same linear system, two preconditioners, same converged answer."""
    _, x_mg = _solve(channel_image, 0.15, "mg")
    _, x_pg = _solve(channel_image, 0.15, "plane_gs")
    rel = np.linalg.norm(x_mg - x_pg) / np.linalg.norm(x_pg)
    assert rel < 1e-6, rel


def test_mg_jacobi_smoother(channel_image):
    """The latency-friendly damped block-Jacobi smoother variant
    converges to the same answer with a bounded iteration overhead vs
    the plane-GS-smoothed cycle."""
    mg_res, x_mg = _solve(channel_image, 0.15, "mg")
    res, x = _solve(channel_image, 0.15, "mg_jacobi")
    assert bool(res.converged)
    rel = np.linalg.norm(x - x_mg) / np.linalg.norm(x_mg)
    assert rel < 1e-6, rel
    assert int(res.iters) <= 4 * int(mg_res.iters), (
        int(mg_res.iters), int(res.iters))


def test_mg_cheby_smoother(channel_image):
    """Chebyshev-accelerated block-Jacobi smoothing: same fully-parallel
    structure as 'jacobi', ~2x fewer Krylov iterations (measured 185->92
    at 70k dofs, 508->223 at 166k on the NS Jacobian)."""
    jac_res, x_jac = _solve(channel_image, 0.15, "mg_jacobi")
    res, x = _solve(channel_image, 0.15, "mg_cheby")
    assert bool(res.converged)
    rel = np.linalg.norm(x - x_jac) / np.linalg.norm(x_jac)
    assert rel < 1e-6, rel
    assert int(res.iters) <= int(jac_res.iters), (
        int(jac_res.iters), int(res.iters))


def test_mg_grouped_smoother(channel_image):
    """Grouped-plane-GS smoother: plane-GS-class strength at 1/8 the
    scan latency (the variant that compiles inside Newton at scale)."""
    mg_res, x_mg = _solve(channel_image, 0.15, "mg")
    res, x = _solve(channel_image, 0.15, "mg_grouped")
    assert bool(res.converged)
    rel = np.linalg.norm(x - x_mg) / np.linalg.norm(x_mg)
    assert rel < 1e-6, rel
    assert int(res.iters) <= 2 * int(mg_res.iters), (
        int(mg_res.iters), int(res.iters))


def test_line_cr_matches_thomas(channel_image):
    """Cyclic-reduction vertical-line solve == blocked-Thomas solve of
    the same block-tridiagonal columns (solve/precond.py)."""
    import jax.numpy as jnp

    from stabilized_navier_stokes_flow_fenicsx.assemble.layered import (
        matrix_values_layered)
    from stabilized_navier_stokes_flow_fenicsx.forms.stokes import (
        make_stokes_kernel)
    from stabilized_navier_stokes_flow_fenicsx.solve.precond import (
        line_cr_layered, line_jacobi_layered)

    inlet1, inlet2 = solve_inlet_profiles(channel_image, 0.5, DEFAULT)
    mesh, _, _ = generate_channel_mesh(channel_image, 0.15, DEFAULT,
                                       layered=True)
    W, lp, mask, g, g64 = _setup_layered(mesh, inlet1, inlet2)
    kern = make_stokes_kernel("tetrahedron", nu=1.0, mu_T_coeff=0.2)
    V = matrix_values_layered(kern, lp.E, lp.n_planes, lp.bs, lp.arrays,
                              jnp.zeros(W.ndofs))
    r = jnp.asarray(np.random.default_rng(3).standard_normal(W.ndofs))
    x_cr = line_cr_layered(V, lp.arrays.diag_pos, mask, lp.n2d,
                           lp.n_planes)(r)
    x_th = line_jacobi_layered(V, lp.arrays.diag_pos, mask, lp.n2d,
                               lp.n_planes)(r)
    rel = float(np.linalg.norm(np.asarray(x_cr - x_th))
                / np.linalg.norm(np.asarray(x_th)))
    assert rel < 1e-12, rel


def test_mg_line_smoother(channel_image):
    """Line-CR-smoothed V-cycle: the compile-safe (log-depth, scan-free)
    smoother that also handles the advective NS Jacobian — measured the
    strongest NS PC in benchmarks/_line_cr_exp.py (66 its vs 99
    mg_jacobi / 365 plane-GS-smoothed at lc=0.12)."""
    mg_res, x_mg = _solve(channel_image, 0.15, "mg")
    res, x = _solve(channel_image, 0.15, "mg_line")
    assert bool(res.converged)
    rel = np.linalg.norm(x - x_mg) / np.linalg.norm(x_mg)
    assert rel < 1e-6, rel
    assert int(res.iters) <= 3 * int(mg_res.iters), (
        int(mg_res.iters), int(res.iters))


def test_parse_mg_pc():
    """PC-name grammar mg[_<sm>][<degree>][w][_bf16] (solve/driver.py):
    the degree/cycle knobs landed after the round-3 1M-dof measurement
    that degree-4 Chebyshev smoothing stalls the NS V-cycle above ~500k
    dofs while degree 6 converges (see solve/mg.py make_mg_pc)."""
    import jax.numpy as jnp

    from stabilized_navier_stokes_flow_fenicsx.solve.driver import (
        parse_mg_pc)

    assert parse_mg_pc("mg") == ("plane_gs", 6, "v", None)
    assert parse_mg_pc("mg_bf16") == ("plane_gs", 6, "v", jnp.bfloat16)
    assert parse_mg_pc("mg_cheby") == ("cheby", 6, "v", None)
    assert parse_mg_pc("mg_cheby6_bf16") == ("cheby", 6, "v", jnp.bfloat16)
    assert parse_mg_pc("mg_chebyw_bf16") == ("cheby", 6, "w", jnp.bfloat16)
    assert parse_mg_pc("mg_cheby8w") == ("cheby", 8, "w", None)
    assert parse_mg_pc("mg_jacobi_bf16") == ("jacobi", 6, "v", jnp.bfloat16)
    assert parse_mg_pc("mg_lined") == ("lined", 6, "v", None)
    assert parse_mg_pc("mg_line") == ("line", 6, "v", None)
    assert parse_mg_pc("jacobi") is None
    assert parse_mg_pc("mg_bogus") is None
