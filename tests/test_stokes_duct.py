"""Stabilized Stokes on the square duct vs the exact developed profile.

This is the reference's own smoke test ('a test file ... has a known
output', reference README.md:44-56) made quantitative.
"""

import numpy as np
import pytest

from stabilized_navier_stokes_flow_fenicsx.apps.duct_stokes import (
    solve_duct)
from stabilized_navier_stokes_flow_fenicsx.utils.exact import (
    square_duct_mean, square_duct_profile)


def rel_l2(result):
    pts = result.mesh.points
    uex = square_duct_profile(pts[:, 1], pts[:, 2]) / square_duct_mean()
    return float(np.sqrt(np.mean((result.u[:, 0] - uex) ** 2))
                 / np.sqrt(np.mean(uex**2)))


def test_duct_stokes_converges_to_poiseuille():
    r6 = solve_duct(6, 12, length=2.0)
    r12 = solve_duct(12, 24, length=2.0)
    assert r6.converged and r12.converged
    e6, e12 = rel_l2(r6), rel_l2(r12)
    # ~O(h^2): halving h should cut the error by ~3-4x
    assert e12 < e6 / 2.5
    assert e12 < 0.12
    # mass defect (stabilization consistency error) also shrinks
    d6 = abs(r6.flux(3) - r6.flux(1))
    d12 = abs(r12.flux(3) - r12.flux(1))
    assert d12 < d6
    # transverse velocities stay small
    assert np.abs(r12.u[:, 1:]).max() < 0.05 * np.abs(r12.u[:, 0]).max()


def test_duct_uniform_inlet_develops():
    """Uniform plug inflow must develop toward the Poiseuille profile."""
    r = solve_duct(8, 24, length=3.0, inlet="uniform")
    assert r.converged
    mesh = r.mesh
    out = mesh.nodes_with_marker(3)
    ux = r.u[out, 0]
    uex = square_duct_profile(mesh.points[out, 1], mesh.points[out, 2]) \
        / square_duct_mean()
    # profile shape correlates strongly with the developed solution
    c = np.corrcoef(ux, uex)[0, 1]
    assert c > 0.99
