"""End-to-end: image -> inlet profiles -> channel NS -> streamtrace -> IO.

The minimum full-product test (reference InletBatchScript flow) on a tiny
synthetic circle image; also XDMF round-trip (checkpoint semantics).
"""

import os

import numpy as np
import pytest

from stabilized_navier_stokes_flow_fenicsx.config import (
    Config, SolverConfig, TraceConfig)
from stabilized_navier_stokes_flow_fenicsx.flow.channel import (
    solve_ns_flow)
from stabilized_navier_stokes_flow_fenicsx.flow.inlet import (
    _p1_integral, solve_inlet_profiles)
from stabilized_navier_stokes_flow_fenicsx.io.xdmf import (
    read_xdmf_function, write_xdmf_function)
from stabilized_navier_stokes_flow_fenicsx.trace.pipeline import (
    for_and_rev_streamtrace)
from stabilized_navier_stokes_flow_fenicsx.utils.testimg import (
    make_annulus_image)


@pytest.fixture(scope="module")
def img(tmp_path_factory):
    p = tmp_path_factory.mktemp("e2e") / "circle.png"
    return make_annulus_image(str(p), "circle", size=400)


def test_inlet_profiles_flow_split(img):
    p1, p2 = solve_inlet_profiles(img, 0.3)
    np.testing.assert_allclose(_p1_integral(p1.mesh, p1.u), 0.3, atol=1e-9)
    np.testing.assert_allclose(_p1_integral(p2.mesh, p2.u), 0.7, atol=1e-9)
    # profile vanishes on its boundary and is positive inside
    assert p1.u.min() >= -1e-12
    assert p1.u.max() > 0


@pytest.fixture(scope="module")
def solution(img):
    cfg = Config(solver=SolverConfig(ksp_restart=60))
    return solve_ns_flow(10, img, 0.5, channel_mesh_size=0.1, cfg=cfg), cfg


def test_channel_ns_solve(solution):
    sol, _ = solution
    assert sol.converged
    m = sol.mesh

    def flux(marker):
        f = m.facets[m.facet_markers == marker]
        tp = m.points[f]
        ar = np.linalg.norm(np.cross(tp[:, 1] - tp[:, 0],
                                     tp[:, 2] - tp[:, 0]) / 2, axis=1)
        return (sol.u[f, 0].mean(axis=1) * ar).sum()

    total_in = flux(1) + flux(2)
    # inlet split honors the BC interpolation (coarse-mesh quadrature
    # differs from the 2D profile integral by O(h^2))
    assert abs(flux(1) / total_in - 0.5) < 0.05
    # outlet mass within stabilization consistency error at lc=0.1
    assert abs(flux(3) - total_in) / total_in < 0.05
    # no-slip on walls — except nodes shared with inlet facets, where the
    # reference's set_bc ordering lets the inlet interpolation win
    # (NavierStokesChannelFlow.py:146: [wall, inlet_1, inlet_2, outlet])
    wall = m.nodes_with_marker(4)
    shared = np.union1d(m.nodes_with_marker(1), m.nodes_with_marker(2))
    pure_wall = np.setdiff1d(wall, shared)
    assert np.abs(sol.u[pure_wall]).max() < 1e-12


def test_xdmf_roundtrip(solution, tmp_path):
    sol, _ = solution
    base = str(tmp_path / "Re10ChannelVelocity")
    write_xdmf_function(base, sol.mesh, sol.u, "Velocity")
    assert os.path.exists(base + ".xdmf")
    mesh2, u2 = read_xdmf_function(base, "Velocity")
    np.testing.assert_array_equal(mesh2.cells, sol.mesh.cells)
    np.testing.assert_allclose(u2, sol.u, atol=0)


def test_streamtrace_outlet(solution, img):
    sol, cfg = solution
    p1, _ = solve_inlet_profiles(img, 0.5)
    res = for_and_rev_streamtrace(
        24, img, sol.mesh, sol.u, p1.mesh.points, cfg)
    # forward endpoints reached the outlet event plane
    assert len(res.forward_endpoints) > 0.5 * len(p1.mesh.points)
    np.testing.assert_allclose(
        res.forward_endpoints[:, 0], 3.7, atol=0.05)
    # a circular coextrusion keeps a centered, roughly circular core
    op = res.outlet_points
    assert len(op) > 50
    assert np.abs(op.mean(axis=0)).max() < 0.03
    r = np.hypot(op[:, 0], op[:, 1])
    assert r.max() < 0.35


def test_xdmf_time_series_roundtrip(solution, tmp_path):
    from stabilized_navier_stokes_flow_fenicsx.io.xdmf import (
        XdmfTimeSeries, read_xdmf_series)

    sol, _ = solution
    base = str(tmp_path / "series")
    with XdmfTimeSeries(base, sol.mesh, "Velocity") as ts:
        ts.append(sol.u, 0.0)
        ts.append(2.0 * np.asarray(sol.u), 0.5)
    mesh, vals, times = read_xdmf_series(base, "Velocity")
    assert vals.shape[0] == 2 and mesh.n_nodes == sol.mesh.n_nodes
    np.testing.assert_allclose(times, [0.0, 0.5])
    np.testing.assert_allclose(vals[1], 2.0 * np.asarray(sol.u))
    # the series file still serves as a step-0 checkpoint
    from stabilized_navier_stokes_flow_fenicsx.io.xdmf import (
        read_xdmf_function)
    _, v0 = read_xdmf_function(base, "Velocity")
    np.testing.assert_allclose(v0, np.asarray(sol.u))
