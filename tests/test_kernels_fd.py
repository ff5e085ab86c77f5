"""Element-kernel consistency: jacfwd Jacobians vs finite differences,
and residual algebra cross-checks against independent dense quadrature."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stabilized_navier_stokes_flow_fenicsx.forms.navier_stokes import (
    make_ns_sups_kernel, make_ns_ugn_kernel)
from stabilized_navier_stokes_flow_fenicsx.forms.poisson import (
    make_poisson_kernel)
from stabilized_navier_stokes_flow_fenicsx.forms.stokes import (
    make_stokes_kernel)
from stabilized_navier_stokes_flow_fenicsx.forms.stokes_th import (
    make_stokes_th_kernel)

TET = np.array([[0.1, 0.0, 0.05], [1.1, 0.2, 0.0],
                [0.3, 0.9, 0.1], [0.2, 0.3, 1.2]])
TRI = np.array([[0.0, 0.1], [1.2, 0.3], [0.4, 1.1]])


def fd_jacobian(kernel, coords, w, eps=1e-6):
    n = len(w)
    J = np.zeros((n, n))
    for j in range(n):
        wp = w.at[j].add(eps)
        wm = w.at[j].add(-eps)
        J[:, j] = (np.asarray(kernel(coords, wp))
                   - np.asarray(kernel(coords, wm))) / (2 * eps)
    return J


@pytest.mark.parametrize("make,cell,coords,ndl", [
    (lambda: make_poisson_kernel("tetrahedron", 1), "tet", TET, 4),
    (lambda: make_stokes_kernel("tetrahedron", nu=1.0), "tet", TET, 16),
    (lambda: make_stokes_kernel("triangle", nu=0.01, mu_T_coeff=1 / 3,
                                nu_scaled_stab=True), "tri", TRI, 9),
    (lambda: make_ns_sups_kernel("tetrahedron", nu=0.05), "tet", TET, 16),
    (lambda: make_ns_sups_kernel("tetrahedron", nu=0.05,
                                 transposed_stab=False), "tet", TET, 16),
    (lambda: make_ns_ugn_kernel("triangle", nu=0.01), "tri", TRI, 9),
    (lambda: make_stokes_th_kernel("tetrahedron"), "tet", TET, 34),
])
def test_jacfwd_matches_fd(make, cell, coords, ndl):
    kern = make()
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.normal(size=ndl) * 0.3)
    c = jnp.asarray(coords)
    J_ad = np.asarray(jax.jacfwd(lambda ww: kern(c, ww))(w))
    J_fd = fd_jacobian(kern, c, w)
    scale = max(np.abs(J_ad).max(), 1.0)
    np.testing.assert_allclose(J_ad, J_fd, atol=5e-6 * scale)


@pytest.mark.parametrize("make,cell,coords,ndl", [
    (lambda: make_ns_sups_kernel("tetrahedron", nu=0.05), "tet", TET, 16),
    (lambda: make_ns_sups_kernel("tetrahedron", nu=0.05,
                                 transposed_stab=False), "tet", TET, 16),
    (lambda: make_ns_sups_kernel("triangle", nu=0.01), "tri", TRI, 9),
    (lambda: make_ns_ugn_kernel("triangle", nu=0.01), "tri", TRI, 9),
    (lambda: make_ns_ugn_kernel("tetrahedron", nu=0.05), "tet", TET, 16),
])
def test_analytic_jac_matches_jacfwd(make, cell, coords, ndl):
    """The quadrature-point-linearized tangent (kernel.jac) must equal the
    jacfwd oracle to f64 roundoff — proves the analytic assembly path
    solves the same Newton systems as round 1's autodiff path."""
    kern = make()
    rng = np.random.default_rng(3)
    for trial in range(3):
        w = jnp.asarray(rng.normal(size=ndl) * (0.5 if trial else 0.0))
        c = jnp.asarray(coords)
        J_ad = np.asarray(jax.jacfwd(lambda ww: kern(c, ww))(w))
        J_an = np.asarray(kern.jac(c, w))
        scale = max(np.abs(J_ad).max(), 1.0)
        np.testing.assert_allclose(J_an, J_ad, atol=1e-12 * scale)


def test_stokes_kernel_symmetry_structure():
    """The unstabilized velocity block of the Stokes kernel is symmetric;
    the pressure-velocity coupling blocks are (-B, B^T)."""
    kern = make_stokes_kernel("tetrahedron", nu=1.0, mu_T_coeff=0.0)
    c = jnp.asarray(TET)
    J = np.asarray(jax.jacfwd(lambda w: kern(c, w))(jnp.zeros(16)))
    uidx = [n * 4 + cmp for n in range(4) for cmp in range(3)]
    pidx = [n * 4 + 3 for n in range(4)]
    A = J[np.ix_(uidx, uidx)]
    np.testing.assert_allclose(A, A.T, atol=1e-12)
    B1 = J[np.ix_(uidx, pidx)]       # -p div(v)
    B2 = J[np.ix_(pidx, uidx)]       # +q div(u)
    np.testing.assert_allclose(B1, -B2.T, atol=1e-12)


def test_sups_quirk_flag_changes_form():
    """transposed_stab toggles the reference's dot(u, grad u) quirk; the
    two kernels must differ on generic data but agree at u = 0."""
    k_ref = make_ns_sups_kernel("tetrahedron", nu=0.05, transposed_stab=True)
    k_txt = make_ns_sups_kernel("tetrahedron", nu=0.05, transposed_stab=False)
    c = jnp.asarray(TET)
    rng = np.random.default_rng(1)
    w = jnp.asarray(rng.normal(size=16) * 0.3)
    r1 = np.asarray(k_ref(c, w))
    r2 = np.asarray(k_txt(c, w))
    assert np.abs(r1 - r2).max() > 1e-8
    wz = jnp.zeros(16).at[3::4].set(jnp.asarray(rng.normal(size=4)))
    np.testing.assert_allclose(
        np.asarray(k_ref(c, wz)), np.asarray(k_txt(c, wz)), atol=1e-12)
