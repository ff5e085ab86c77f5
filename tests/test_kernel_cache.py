"""One compiled program per mesh across the Reynolds sweep.

The reference re-JITs its FFCx forms per UFL form instance, i.e. per
Reynolds number (run_all_RE.sh sweeps Re in {40,50,60,70}); rounds 1-2
inherited that shape by baking nu into the kernel closure, so every Re
rung recompiled every multi-minute XLA program.  ElementKernel
(utils/kernelbase.py) makes the physical parameters pytree leaves: these
tests pin that two kernels at different nu (a) share a treedef and the
same cached element functions, and (b) hit the already-compiled Newton
and refine executables — the jit cache grows by exactly one across a
whole nu ladder.
"""

import jax
import jax.numpy as jnp
import numpy as np

from stabilized_navier_stokes_flow_fenicsx.assemble.assembly import (
    assembler_for_mixed)
from stabilized_navier_stokes_flow_fenicsx.fem.bc import (
    DirichletBC, bc_mask, bc_vector, combine_bcs)
from stabilized_navier_stokes_flow_fenicsx.fem.space import (
    make_mixed_space)
from stabilized_navier_stokes_flow_fenicsx.forms.navier_stokes import (
    make_ns_sups_kernel, make_ns_ugn_kernel)
from stabilized_navier_stokes_flow_fenicsx.forms.navier_stokes_df import (
    make_ns_sups_kernel_df)
from stabilized_navier_stokes_flow_fenicsx.forms.stokes import (
    make_stokes_kernel)
from stabilized_navier_stokes_flow_fenicsx.forms.stokes_df import (
    make_stokes_kernel_df)
from stabilized_navier_stokes_flow_fenicsx.mesh.structured import (
    duct_mesh)
from stabilized_navier_stokes_flow_fenicsx.solve.driver import (
    solve_newton_bcsr)


def _treedef(k):
    return jax.tree_util.tree_structure(k)


def test_kernels_share_treedef_across_nu():
    """Different nu -> same treedef (leaves differ, structure+fns don't)."""
    pairs = [
        (make_ns_sups_kernel("tetrahedron", nu=1.0 / 40),
         make_ns_sups_kernel("tetrahedron", nu=1.0 / 70)),
        (make_ns_ugn_kernel("triangle", nu=1.0 / 100),
         make_ns_ugn_kernel("triangle", nu=1.0 / 400)),
        (make_stokes_kernel("tetrahedron", nu=1.0, mu_T_coeff=0.2),
         make_stokes_kernel("tetrahedron", nu=2.0, mu_T_coeff=0.2)),
        (make_ns_sups_kernel_df("tetrahedron", nu=1.0 / 40),
         make_ns_sups_kernel_df("tetrahedron", nu=1.0 / 70)),
        (make_stokes_kernel_df("tetrahedron", nu=1.0, mu_T_coeff=0.2),
         make_stokes_kernel_df("tetrahedron", nu=2.0, mu_T_coeff=0.2)),
    ]
    for ka, kb in pairs:
        assert _treedef(ka) == _treedef(kb)
    # structurally different kernels must NOT collide
    assert _treedef(make_ns_sups_kernel("tetrahedron", nu=0.1)) \
        != _treedef(make_stokes_kernel("tetrahedron", nu=0.1))


def test_kernel_values_track_nu():
    """The traced parameters actually change the numbers (no baked nu)."""
    rng = np.random.default_rng(0)
    coords = jnp.asarray(rng.random((4, 3)) + np.eye(4, 3) * 2.0)
    w = jnp.asarray(rng.standard_normal(16) * 0.1)
    k40 = make_ns_sups_kernel("tetrahedron", nu=1.0 / 40)
    k70 = make_ns_sups_kernel("tetrahedron", nu=1.0 / 70)
    r40 = np.asarray(k40(coords, w))
    r70 = np.asarray(k70(coords, w))
    assert not np.allclose(r40, r70)
    # and the pytree round-trip preserves behavior
    leaves, td = jax.tree_util.tree_flatten(k40)
    k40b = jax.tree_util.tree_unflatten(td, leaves)
    np.testing.assert_array_equal(np.asarray(k40b(coords, w)), r40)
    np.testing.assert_array_equal(
        np.asarray(k40b.jac(coords, w)), np.asarray(k40.jac(coords, w)))


def _duct_problem(dtype, n=3):
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
    iv[:, 0] = 1.0
    bc = combine_bcs([
        DirichletBC(vdofs(wall), np.zeros(3 * len(wall))),
        DirichletBC(vdofs(inlet), iv.ravel()),
        DirichletBC(W.pressure_dof(outlet), np.zeros(len(outlet))),
    ])
    mask = jnp.asarray(bc_mask(W.ndofs, bc), dtype)
    g = jnp.asarray(bc_vector(W.ndofs, bc), dtype)
    return W, asm, mask, g


def test_newton_program_reused_across_re_sweep():
    """solve_newton_bcsr compiles once for a whole Re ladder."""
    W, asm, mask, g = _duct_problem(jnp.float32)
    pat = asm.pattern

    def solve(nu):
        kern = make_ns_sups_kernel("tetrahedron", nu=nu)
        return solve_newton_bcsr(
            kern, asm.ndofs, pat.nnzb, pat.bs, pat.n_rows, asm.arrays,
            mask, g, jnp.zeros(asm.ndofs, jnp.float32),
            rtol=1e-5, atol=1e-5, max_it=20, ksp_rtol=1e-4)

    out = solve(1.0 / 10.0)
    assert bool(out.converged)
    size0 = solve_newton_bcsr._cache_size()
    for re in (20.0, 40.0, 70.0):
        out = solve(1.0 / re)
        assert bool(out.converged), re
    assert solve_newton_bcsr._cache_size() == size0, (
        "Re sweep recompiled the Newton program")
