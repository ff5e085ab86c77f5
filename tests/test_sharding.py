"""Multi-device element-sharded solves on the 8-device fake CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from stabilized_navier_stokes_flow_fenicsx.apps.lid_driven import (
    cavity_bcs, solve_lid_driven)
from stabilized_navier_stokes_flow_fenicsx.assemble.assembly import (
    assembler_for_mixed)
from stabilized_navier_stokes_flow_fenicsx.fem.bc import (
    bc_mask, bc_vector)
from stabilized_navier_stokes_flow_fenicsx.fem.space import (
    make_mixed_space)
from stabilized_navier_stokes_flow_fenicsx.forms.navier_stokes import (
    make_ns_ugn_kernel)
from stabilized_navier_stokes_flow_fenicsx.forms.stokes import (
    make_stokes_kernel)
from stabilized_navier_stokes_flow_fenicsx.mesh.structured import (
    unit_square_tri)
from stabilized_navier_stokes_flow_fenicsx.parallel.shard import (
    make_sharded_problem, sharded_newton)
from stabilized_navier_stokes_flow_fenicsx.solve.driver import (
    solve_linear_bcsr)


def test_sharded_newton_matches_single_device():
    assert len(jax.devices()) == 8
    n, Re = 12, 50.0
    mesh = unit_square_tri(n, n)
    W = make_mixed_space(mesh, 1, 1)
    asm = assembler_for_mixed(W)
    bc = cavity_bcs(mesh, W)
    mask = jnp.asarray(bc_mask(W.ndofs, bc))
    g = jnp.asarray(bc_vector(W.ndofs, bc))
    pat = asm.pattern

    sk = make_stokes_kernel("triangle", nu=1 / Re, mu_T_coeff=1 / 3,
                            nu_scaled_stab=True)
    sres = solve_linear_bcsr(sk, asm.ndofs, pat.nnzb, pat.bs, pat.n_rows,
                             1e-10, 50, asm.arrays, mask, g)

    nsk = make_ns_ugn_kernel("triangle", nu=1 / Re)

    # single-device reference
    from stabilized_navier_stokes_flow_fenicsx.solve.driver import (
        solve_newton_bcsr)
    ref = solve_newton_bcsr(nsk, asm.ndofs, pat.nnzb, pat.bs, pat.n_rows,
                            asm.arrays, mask, g, sres.x)
    assert bool(ref.converged)

    # 8-way element-sharded
    dev_mesh = Mesh(np.array(jax.devices()), ("cells",))
    prob = make_sharded_problem(asm, dev_mesh)
    sres_x = jnp.asarray(np.asarray(sres.x))
    out = sharded_newton(prob, nsk, mask, g, sres_x)
    assert bool(out.converged)
    err = np.linalg.norm(np.asarray(out.x) - np.asarray(ref.x)) \
        / np.linalg.norm(np.asarray(ref.x))
    assert err < 1e-8

    # ---- GSPMD row-partitioned variant (dof vectors NOT replicated) ----
    from stabilized_navier_stokes_flow_fenicsx.parallel.shard import (
        spmd_newton_bcsr)

    dof_mesh = Mesh(np.array(jax.devices()), ("dofs",))
    out2 = spmd_newton_bcsr(asm, nsk, mask, g, sres_x, dof_mesh)
    assert bool(out2.converged)
    x2 = np.asarray(out2.x)
    np.testing.assert_allclose(x2[asm.ndofs:], 0.0)   # padded rows pinned
    err2 = np.linalg.norm(x2[:asm.ndofs] - np.asarray(ref.x)) \
        / np.linalg.norm(np.asarray(ref.x))
    assert err2 < 1e-8
    # the solution vector is physically row-partitioned: each device
    # holds only ndofs_pad/8 entries (vector replication dropped — the
    # memory axis for >8-chip scaling)
    shard_rows = [s.data.shape[0] for s in out2.x.addressable_shards]
    assert len(shard_rows) == 8
    assert max(shard_rows) == x2.shape[0] // 8
