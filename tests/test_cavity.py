"""Lid-driven cavity NS vs Ghia et al. benchmark values (loose bars at
coarse resolution — P1-P1 + UGN stabilization is diffusive by design)."""

import numpy as np

from stabilized_navier_stokes_flow_fenicsx.apps.lid_driven import (
    solve_lid_driven)


def centerline_min(r):
    pts = r.mesh.points
    cl = np.nonzero(np.abs(pts[:, 0] - 0.5) < 1e-9)[0]
    return float(r.u[cl, 0].min())


def test_cavity_re100():
    r = solve_lid_driven(32, 100.0)
    assert r.converged
    assert r.newton_iters <= 12
    umin = centerline_min(r)
    # Ghia Re=100: u_min = -0.2109; coarse stabilized P1-P1 undershoots
    assert -0.25 < umin < -0.14
    # pressure pinned at the corner
    corner = int(np.argmin(r.mesh.points[:, 0] ** 2
                           + r.mesh.points[:, 1] ** 2))
    assert abs(r.p[corner]) < 1e-12


def test_cavity_refinement_approaches_ghia():
    r32 = solve_lid_driven(32, 100.0)
    r48 = solve_lid_driven(48, 100.0)
    u32, u48 = centerline_min(r32), centerline_min(r48)
    ghia = -0.2109
    assert abs(u48 - ghia) < abs(u32 - ghia)
