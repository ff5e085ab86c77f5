"""Gmsh .msh interop (mesh/mshio.py).

The reference consumes gmsh meshes via dolfinx.io.gmshio (reference
DFG_2D_Validation.py:28) and ships the .geo sources for its validation
meshes (dfg_pillar_2D.geo:95-99 physical groups).  gmsh itself is not
installable here, so these tests exercise the interop both ways:
a hand-written MSH 2.2 fixture (the format gmsh writes with
`gmsh -format msh2`), and a 4.1 write->read round-trip on the native
DFG cylinder-channel mesh — proving any externally meshed geometry
(including the reference's own dfg_pillar meshes) can be ingested and
solved on directly.
"""

import os
import tempfile

import numpy as np

from stabilized_navier_stokes_flow_fenicsx.mesh.mshio import (
    read_msh, write_msh)

# one unit square split into two triangles, bottom edge marked 7,
# left edge marked 9 (MSH 2.2 ASCII as gmsh writes it)
MSH22 = """$MeshFormat
2.2 0 8
$EndMeshFormat
$Nodes
4
1 0 0 0
2 1 0 0
3 1 1 0
4 0 1 0
$EndNodes
$Elements
4
1 1 2 7 1 1 2
2 1 2 9 4 4 1
3 2 2 1 6 1 2 3
4 2 2 1 6 1 3 4
$EndElements
"""


def test_read_msh22():
    with tempfile.NamedTemporaryFile(
            "w", suffix=".msh", delete=False) as f:
        f.write(MSH22)
        path = f.name
    try:
        mesh, cm = read_msh(path)
    finally:
        os.unlink(path)
    assert mesh.cell == "triangle"
    assert mesh.n_nodes == 4 and mesh.n_cells == 2
    assert mesh.gdim == 2                       # z trimmed
    assert np.allclose(mesh.cell_volumes().sum(), 1.0)
    assert cm is not None and set(cm) == {1}
    np.testing.assert_array_equal(
        mesh.nodes_with_marker(7), [0, 1])      # bottom edge
    np.testing.assert_array_equal(
        mesh.nodes_with_marker(9), [0, 3])      # left edge


def test_roundtrip_dfg2d_mesh_and_solve():
    """Write the native DFG mesh as MSH 4.1, read it back, and check the
    mesh is identical — so a solve on the imported mesh is bit-identical
    to a solve on the native one (matched-mesh cross-validation works)."""
    from stabilized_navier_stokes_flow_fenicsx.apps.dfg2d import (
        dfg2d_mesh)

    mesh = dfg2d_mesh(2.0)                      # tiny smoke scale
    with tempfile.NamedTemporaryFile(suffix=".msh", delete=False) as f:
        path = f.name
    try:
        write_msh(path, mesh)
        mesh2, _ = read_msh(path)
    finally:
        os.unlink(path)
    assert mesh2.cell == mesh.cell
    np.testing.assert_allclose(mesh2.points, mesh.points, atol=1e-15)
    np.testing.assert_array_equal(mesh2.cells, mesh.cells)
    # same facet sets per marker
    for m in np.unique(mesh.facet_markers):
        a = {tuple(f) for f in np.sort(mesh.facets_with_marker(m), 1)}
        b = {tuple(f) for f in np.sort(mesh2.facets_with_marker(m), 1)}
        assert a == b, f"marker {m} facet set changed in round-trip"


def test_roundtrip_3d():
    from stabilized_navier_stokes_flow_fenicsx.mesh.structured import (
        duct_mesh)

    mesh = duct_mesh(3, 5)
    with tempfile.NamedTemporaryFile(suffix=".msh", delete=False) as f:
        path = f.name
    try:
        write_msh(path, mesh)
        mesh2, _ = read_msh(path)
    finally:
        os.unlink(path)
    assert mesh2.cell == "tetrahedron"
    np.testing.assert_allclose(mesh2.points, mesh.points, atol=1e-15)
    np.testing.assert_array_equal(mesh2.cells, mesh.cells)
    assert np.isclose(mesh2.cell_volumes().sum(),
                      mesh.cell_volumes().sum())


def test_imported_mesh_solves():
    """Poisson solve on an imported MSH 2.2 mesh (structured square
    exported by hand) matches the solve on the in-memory original."""
    from stabilized_navier_stokes_flow_fenicsx.mesh.structured import (
        unit_square_tri)

    mesh = unit_square_tri(6, 6)
    with tempfile.NamedTemporaryFile(suffix=".msh", delete=False) as f:
        path = f.name
    try:
        write_msh(path, mesh)
        mesh2, _ = read_msh(path)
    finally:
        os.unlink(path)

    import jax.numpy as jnp

    from stabilized_navier_stokes_flow_fenicsx.assemble.assembly import (
        assembler_for_space)
    from stabilized_navier_stokes_flow_fenicsx.fem.bc import (
        DirichletBC, bc_mask, bc_vector)
    from stabilized_navier_stokes_flow_fenicsx.fem.space import (
        make_space)
    from stabilized_navier_stokes_flow_fenicsx.forms.poisson import (
        make_poisson_kernel)
    from stabilized_navier_stokes_flow_fenicsx.solve.driver import (
        solve_spd_cg)

    def solve(m):
        fs = make_space(m, 1)
        asm = assembler_for_space(fs)
        bnd = np.unique(np.concatenate(
            [np.nonzero(np.isclose(m.points[:, d], v))[0]
             for d in (0, 1) for v in (0.0, 1.0)]))
        bc = DirichletBC(bnd, np.zeros(len(bnd)))
        mask = jnp.asarray(bc_mask(fs.ndofs, bc))
        g = jnp.asarray(bc_vector(fs.ndofs, bc))
        k = make_poisson_kernel(m.cell, forcing=10.0)
        return np.asarray(solve_spd_cg(k, fs.ndofs, 1e-12,
                                       asm.arrays, mask, g).x)

    u1, u2 = solve(mesh), solve(mesh2)
    np.testing.assert_allclose(u1, u2, atol=1e-10)
