"""Double-float (two-f32) precision path: arithmetic, kernel, assembly,
and the iterative-refinement Newton reaching SNES-grade 1e-8 tolerances.

The f64 CPU build is the oracle: every df32 computation (components kept
f32 explicitly) is pinned against the same computation in plain f64, the
precision an f32 solve cannot reach alone (VERDICT round-1 item 4;
reference SNES tolerances NavierStokes/NavierStokesChannelFlow.py:281-283).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from stabilized_navier_stokes_flow_fenicsx.assemble.assembly import (
    assembler_for_mixed)
from stabilized_navier_stokes_flow_fenicsx.assemble.df_assembly import (
    DFResidual)
from stabilized_navier_stokes_flow_fenicsx.fem.bc import (
    DirichletBC, bc_mask, bc_vector, combine_bcs)
from stabilized_navier_stokes_flow_fenicsx.fem.space import (
    make_mixed_space)
from stabilized_navier_stokes_flow_fenicsx.forms.navier_stokes import (
    make_ns_sups_kernel)
from stabilized_navier_stokes_flow_fenicsx.forms.navier_stokes_df import (
    make_ns_sups_kernel_df, split64)
from stabilized_navier_stokes_flow_fenicsx.mesh.structured import (
    duct_mesh)
from stabilized_navier_stokes_flow_fenicsx.solve.driver import (
    refine_newton_bcsr, solve_newton_bcsr)
from stabilized_navier_stokes_flow_fenicsx.utils.dfloat import (
    DF, df, df_add, df_div, df_einsum, df_mul, df_norm, df_rsqrt, df_sqrt)
from stabilized_navier_stokes_flow_fenicsx.utils.exact import (
    square_duct_mean, square_duct_profile)


def _rand_df(rng, shape, scale=1.0):
    x64 = rng.standard_normal(shape) * scale
    return split64(x64), x64


def test_df_arithmetic_matches_f64():
    rng = np.random.default_rng(0)
    a, a64 = _rand_df(rng, (257,))
    b, b64 = _rand_df(rng, (257,))
    for got, want in [
        (df_add(a, b), a64 + b64),
        (df_mul(a, b), a64 * b64),
        (df_div(a, b), a64 / b64),
        (df_sqrt(df_mul(a, a)), np.abs(a64)),
        (df_rsqrt(df_mul(a, a) + df(1.0)), 1.0 / np.sqrt(a64**2 + 1.0)),
    ]:
        got64 = np.asarray(got.astype_f64())
        assert got.hi.dtype == jnp.float32
        np.testing.assert_allclose(got64, want, rtol=1e-12, atol=1e-12)


def test_df_einsum_matches_f64():
    rng = np.random.default_rng(1)
    q, a, k, i = 5, 4, 3, 3
    A, A64 = _rand_df(rng, (q, a, k))
    B, B64 = _rand_df(rng, (k, i))
    u, u64 = _rand_df(rng, (q, i))
    G, G64 = _rand_df(rng, (i, i))
    T, T64 = _rand_df(rng, (q, i, i))
    for spec, ops, ops64 in [
        ("qak,ki->qai", (A, B), (A64, B64)),
        ("qi,ij,qj->q", (u, G, u), (u64, G64, u64)),
        ("qii->q", (T,), (T64,)),
        ("ij,ij->", (G, G), (G64, G64)),
    ]:
        got = np.asarray(df_einsum(spec, *ops).astype_f64())
        want = np.einsum(spec, *ops64)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("transposed", [True, False])
def test_df_kernel_matches_f64_kernel(transposed):
    rng = np.random.default_rng(2)
    nu = 1.0 / 37.0
    k64 = make_ns_sups_kernel("tetrahedron", nu=nu, transposed_stab=transposed)
    kdf = make_ns_sups_kernel_df(
        "tetrahedron", nu=nu, transposed_stab=transposed)
    coords64 = np.array(
        [[0.0, 0.0, 0.0], [0.13, 0.02, 0.01],
         [0.03, 0.11, 0.02], [0.01, 0.03, 0.12]])
    w64 = rng.standard_normal(16)
    r64 = np.asarray(k64(jnp.asarray(coords64), jnp.asarray(w64)))
    rdf = kdf(split64(coords64), split64(w64))
    got = np.asarray(rdf.astype_f64())
    scale = np.max(np.abs(r64))
    np.testing.assert_allclose(got, r64, rtol=0, atol=2e-12 * scale)


def _duct_problem(dtype, n=3, Re=20.0):
    mesh = duct_mesh(n, 2 * n, length=2.0)
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
    mask64 = bc_mask(W.ndofs, bc)
    g64 = bc_vector(W.ndofs, bc)
    return W, asm, mask64, g64


def test_df_assembly_matches_f64_residual():
    W, asm64, mask64, g64 = _duct_problem(jnp.float64)
    kern64 = make_ns_sups_kernel("tetrahedron", nu=0.05)
    kdf = make_ns_sups_kernel_df("tetrahedron", nu=0.05)
    dfr = DFResidual(W, kdf)
    rng = np.random.default_rng(3)
    w64 = rng.standard_normal(W.ndofs)
    r64 = np.asarray(asm64.residual(kern64, jnp.asarray(w64)))
    rdf = dfr.raw(split64(w64))
    got = np.asarray(rdf.astype_f64())
    scale = np.max(np.abs(r64))
    np.testing.assert_allclose(got, r64, rtol=0, atol=5e-12 * scale)


def test_refine_reaches_1e8_and_matches_f64_solution():
    """The headline: f32 Newton floors ~1e-6; df refinement reaches 1e-8
    and the refined hi+lo iterate matches the f64 Newton solution to well
    under the L2 < 1e-6 parity bar (BASELINE.md)."""
    nu = 1.0 / 20.0
    kern = make_ns_sups_kernel("tetrahedron", nu=nu)
    kdf = make_ns_sups_kernel_df("tetrahedron", nu=nu)

    # --- f64 oracle solve
    W, asm64, mask64, g64 = _duct_problem(jnp.float64)
    m64 = jnp.asarray(mask64, jnp.float64)
    gg64 = jnp.asarray(g64, jnp.float64)
    out64 = solve_newton_bcsr(
        kern, asm64.ndofs, asm64.pattern.nnzb, asm64.pattern.bs,
        asm64.pattern.n_rows, asm64.arrays, m64, gg64,
        jnp.zeros(asm64.ndofs, jnp.float64),
        rtol=1e-12, atol=1e-12, max_it=30, ksp_rtol=1e-10)
    assert bool(out64.converged)
    x64 = np.asarray(out64.x)

    # --- f32 Newton (the default f32 configuration)
    W32, asm32, mask64_, g64_ = _duct_problem(jnp.float32)
    m32 = jnp.asarray(mask64_, jnp.float32)
    g32 = jnp.asarray(g64_, jnp.float32)
    out32 = solve_newton_bcsr(
        kern, asm32.ndofs, asm32.pattern.nnzb, asm32.pattern.bs,
        asm32.pattern.n_rows, asm32.arrays, m32, g32,
        jnp.zeros(asm32.ndofs, jnp.float32),
        rtol=1e-6, atol=1e-6, max_it=30, ksp_rtol=1e-4)
    n0 = float(jnp.linalg.norm(
        m32 * asm32.residual(kern, jnp.zeros(asm32.ndofs, jnp.float32))
        - (1.0 - m32) * g32))

    # --- df refinement to 1e-8
    dfr = DFResidual(W32, kdf)
    g_df = split64(g64_)
    out = refine_newton_bcsr(
        kern, kdf, asm32.ndofs, asm32.pattern.nnzb, asm32.pattern.bs,
        asm32.pattern.n_rows, asm32.arrays, dfr.dfa, m32,
        g_df.hi, g_df.lo, out32.x, jnp.asarray(n0, jnp.float32),
        rtol=1e-8, atol=0.0, max_it=12, ksp_rtol=1e-2)
    assert bool(out.converged), (
        f"resnorm {float(out.resnorm):.3e} vs tol {1e-8 * n0:.3e}, "
        f"history {np.asarray(out.history)}")

    x_ref = np.asarray(out.x_hi, np.float64) + np.asarray(out.x_lo, np.float64)
    rel = np.linalg.norm(x_ref - x64) / np.linalg.norm(x64)
    assert rel < 1e-6, rel
    # and the refinement genuinely moved past the f32 floor
    rel32 = np.linalg.norm(np.asarray(out32.x, np.float64) - x64) \
        / np.linalg.norm(x64)
    assert rel < rel32
