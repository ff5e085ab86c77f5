import numpy as np
import pytest

from stabilized_navier_stokes_flow_fenicsx.fem.elements import (
    element, quadrature)


@pytest.mark.parametrize("cell,deg", [
    ("interval", 1), ("triangle", 1), ("triangle", 2),
    ("tetrahedron", 1), ("tetrahedron", 2),
])
def test_partition_of_unity_and_kronecker(cell, deg):
    e = element(cell, deg)
    rng = np.random.default_rng(0)
    pts = rng.random((20, e.dim))
    pts /= pts.sum(axis=1, keepdims=True).clip(min=1.0) * 1.01  # keep in simplex
    vals, grads = e.tabulate(pts)
    assert vals.shape == (20, e.ndof)
    assert grads.shape == (20, e.ndof, e.dim)
    np.testing.assert_allclose(vals.sum(axis=1), 1.0, atol=1e-13)
    np.testing.assert_allclose(grads.sum(axis=1), 0.0, atol=1e-13)
    # Kronecker property at dof points
    v_at_dofs, _ = e.tabulate(e.dof_points)
    np.testing.assert_allclose(v_at_dofs, np.eye(e.ndof), atol=1e-13)


@pytest.mark.parametrize("cell,deg", [
    ("triangle", 1), ("triangle", 2), ("triangle", 3), ("triangle", 5),
    ("tetrahedron", 1), ("tetrahedron", 2), ("tetrahedron", 3),
    ("tetrahedron", 5),
])
def test_quadrature_exactness(cell, deg):
    qr = quadrature(cell, deg)
    dim = 2 if cell == "triangle" else 3
    vol = 0.5 if dim == 2 else 1.0 / 6.0
    np.testing.assert_allclose(qr.weights.sum(), vol, rtol=1e-13)
    # integrate all monomials of total degree <= deg exactly
    import itertools
    import math

    for alpha in itertools.product(range(deg + 1), repeat=dim):
        if sum(alpha) > deg:
            continue
        val = np.sum(qr.weights * np.prod(qr.points ** np.array(alpha), axis=1))
        # exact integral of x^a y^b (z^c) over unit simplex:
        # prod(a_i!) * 1 / (d + sum a_i)!  * ... formula:
        num = np.prod([math.factorial(a) for a in alpha])
        exact = num / math.factorial(sum(alpha) + dim)
        np.testing.assert_allclose(val, exact, rtol=2e-12,
                                   err_msg=f"{cell} deg={deg} alpha={alpha}")


def test_p2_gradients_fd():
    e = element("tetrahedron", 2)
    rng = np.random.default_rng(1)
    pts = rng.random((5, 3)) * 0.3
    _, grads = e.tabulate(pts)
    eps = 1e-6
    for d in range(3):
        dp = np.zeros(3)
        dp[d] = eps
        vp, _ = e.tabulate(pts + dp)
        vm, _ = e.tabulate(pts - dp)
        np.testing.assert_allclose(
            grads[:, :, d], (vp - vm) / (2 * eps), atol=1e-8)
