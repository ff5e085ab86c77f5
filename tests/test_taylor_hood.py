"""Taylor-Hood duct Stokes (the reference's DuctStokesFlow element pair)."""

import numpy as np

from stabilized_navier_stokes_flow_fenicsx.apps.duct_stokes_th import (
    solve_duct_th)
from stabilized_navier_stokes_flow_fenicsx.utils.exact import (
    square_duct_mean, square_duct_profile)


def rel_err(r):
    uex = square_duct_profile(r.u_coords[:, 1], r.u_coords[:, 2]) \
        / square_duct_mean()
    return float(np.sqrt(np.mean((r.u[:, 0] - uex) ** 2))
                 / np.sqrt(np.mean(uex**2)))


def test_th_duct_converges():
    e4 = rel_err(solve_duct_th(4, 8, inlet="poiseuille"))
    e6 = rel_err(solve_duct_th(6, 12, inlet="poiseuille"))
    assert e6 < e4 / 1.8
    assert e6 < 0.06


def test_th_uniform_inlet_mass():
    r = solve_duct_th(4, 8, inlet="uniform")
    # unstabilized TH conserves mass much better than P1-P1:
    # compare outlet flux to inlet area (u_in = 1)
    mesh = r.mesh
    f = mesh.facets[mesh.facet_markers == 3]
    tp = mesh.points[f]
    ar = np.linalg.norm(np.cross(tp[:, 1] - tp[:, 0],
                                 tp[:, 2] - tp[:, 0]) / 2, axis=1)
    # exact P2 facet integral: area/3 * sum of edge-midpoint values
    en = r.space.V.edge_nodes
    key = {(min(a, b), max(a, b)): i for i, (a, b) in enumerate(en)}
    flux = 0.0
    for fac, a in zip(f, ar):
        mids = [mesh.n_nodes + key[(min(fac[i], fac[j]),
                                    max(fac[i], fac[j]))]
                for i, j in ((0, 1), (1, 2), (0, 2))]
        flux += a / 3 * sum(r.u[m, 0] for m in mids)
    assert abs(flux - 1.0) < 0.03


def test_minres_symmetric_indefinite():
    """minres (the documented MINRES alternative to the fieldsplit
    FGMRES production path) on a small symmetric indefinite saddle
    point, with an SPD block-diagonal preconditioner."""
    import jax.numpy as jnp

    from stabilized_navier_stokes_flow_fenicsx.solve.krylov import minres

    rng = np.random.default_rng(7)
    n, m = 24, 8
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0]
    A11 = Q @ np.diag(rng.uniform(1.0, 10.0, n)) @ Q.T     # SPD block
    B = rng.standard_normal((n, m))
    K = np.block([[A11, B], [B.T, np.zeros((m, m))]])      # indefinite
    x_exact = rng.standard_normal(n + m)
    b = K @ x_exact

    Kj = jnp.asarray(K)
    dinv = jnp.asarray(np.concatenate(
        [1.0 / np.diag(A11), np.ones(m)]))                 # SPD PC

    out = minres(lambda x: Kj @ x, jnp.asarray(b),
                 M=lambda x: dinv * x, rtol=1e-10)
    assert bool(out.converged), float(out.resnorm)
    err = float(np.linalg.norm(np.asarray(out.x) - x_exact)
                / np.linalg.norm(x_exact))
    assert err < 1e-7, err
