"""SoA element kernels == vmapped per-cell kernels (forms/soa.py).

The SoA path re-derives both stabilized forms from the E^T f E flux
formulation with an AD-built df/ds; these tests pin it against the
hand-derived per-cell kernels (which are themselves pinned against
jacfwd in tests/test_kernels_fd.py), closing the chain
SoA == per-cell == autodiff in f64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stabilized_navier_stokes_flow_fenicsx.forms.navier_stokes import (
    make_ns_sups_kernel, make_ns_ugn_kernel)
from stabilized_navier_stokes_flow_fenicsx.forms.soa import (
    make_sups_soa, make_ugn_soa)


def _random_cells(nc, seed=0):
    rng = np.random.default_rng(seed)
    # non-degenerate random tets: unit reference tet + jitter + affine
    ref = np.array([[0.0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    cells = []
    for _ in range(nc):
        A = np.eye(3) + 0.3 * rng.standard_normal((3, 3))
        b = rng.standard_normal(3)
        cells.append(ref @ A.T + b + 0.05 * rng.standard_normal((4, 3)))
    coords = np.stack(cells)                     # (nc, 4, 3)
    w = rng.standard_normal((nc, 16))
    return coords, w


def _to_soa(coords, w):
    coordsT = jnp.asarray(coords.transpose(1, 2, 0).reshape(12, -1))
    wT = jnp.asarray(w.T)                        # (16, nc)
    return coordsT, wT


@pytest.mark.parametrize("transposed", [True, False])
def test_sups_soa_residual_and_jac(transposed):
    coords, w = _random_cells(37, seed=1)
    kern = make_ns_sups_kernel("tetrahedron", nu=0.07,
                               transposed_stab=transposed)
    r_ref = jax.vmap(kern)(jnp.asarray(coords), jnp.asarray(w))
    J_ref = jax.vmap(kern.jac)(jnp.asarray(coords), jnp.asarray(w))

    res_soa, jac_soa = make_sups_soa("tetrahedron", transposed, 2)
    coordsT, wT = _to_soa(coords, w)
    r = res_soa(kern.params, coordsT, wT)        # (16, nc)
    J = jac_soa(kern.params, coordsT, wT)        # (16, 16, nc)

    np.testing.assert_allclose(np.asarray(r).T, np.asarray(r_ref),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.asarray(J).transpose(2, 0, 1),
                               np.asarray(J_ref), rtol=1e-11, atol=1e-12)


def test_sups_soa_traced_params_one_program(monkeypatch):
    """nu enters as a traced leaf: two Reynolds numbers must hit the
    same jitted executable (the kernel-cache economics the AoS path
    already has, utils/kernelbase.py)."""
    coords, w = _random_cells(8, seed=3)
    res_soa, _ = make_sups_soa("tetrahedron", True, 2)
    coordsT, wT = _to_soa(coords, w)
    jfn = jax.jit(res_soa)
    r1 = jfn((0.1, 36.0), coordsT, wT)
    n_before = jfn._cache_size()
    r2 = jfn((0.025, 36.0), coordsT, wT)
    assert jfn._cache_size() == n_before
    assert not np.allclose(np.asarray(r1), np.asarray(r2))


def test_ugn_soa_residual_and_jac():
    coords, w = _random_cells(23, seed=2)
    kern = make_ns_ugn_kernel("tetrahedron", nu=0.05)
    r_ref = jax.vmap(kern)(jnp.asarray(coords), jnp.asarray(w))
    J_ref = jax.vmap(kern.jac)(jnp.asarray(coords), jnp.asarray(w))

    res_soa, jac_soa = make_ugn_soa("tetrahedron", 2)
    coordsT, wT = _to_soa(coords, w)
    r = res_soa(kern.params, coordsT, wT)
    J = jac_soa(kern.params, coordsT, wT)

    np.testing.assert_allclose(np.asarray(r).T, np.asarray(r_ref),
                               rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(np.asarray(J).transpose(2, 0, 1),
                               np.asarray(J_ref), rtol=1e-11, atol=1e-12)
