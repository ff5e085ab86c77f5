import numpy as np

from stabilized_navier_stokes_flow_fenicsx.mesh.core import (
    boundary_facets, mark_boundary_facets)
from stabilized_navier_stokes_flow_fenicsx.mesh.structured import (
    box_tet, duct_mesh, unit_square_tri)


def test_unit_square_tri():
    m = unit_square_tri(4, 4)
    assert m.n_cells == 32
    assert m.n_nodes == 25
    np.testing.assert_allclose(m.cell_volumes().sum(), 1.0, rtol=1e-14)
    bf = boundary_facets(m)
    assert bf.shape == (16, 2)


def test_box_tet_volume_and_conformity():
    m = box_tet((3, 2, 4), (0, -0.5, -0.5), (4.0, 0.5, 0.5))
    np.testing.assert_allclose(m.cell_volumes().sum(), 4.0, rtol=1e-13)
    assert (m.cell_volumes() > 0).all()
    # conforming: every interior facet shared by exactly 2 cells
    from stabilized_navier_stokes_flow_fenicsx.mesh.core import (
        facets_of_cells)
    fv, _ = facets_of_cells(m.cell, m.cells)
    _, counts = np.unique(fv, axis=0, return_counts=True)
    assert set(counts.tolist()) <= {1, 2}


def test_duct_markers():
    m = duct_mesh(4, 8, length=4.0)
    inlet = m.nodes_with_marker(1)
    outlet = m.nodes_with_marker(3)
    walls = m.nodes_with_marker(4)
    assert np.allclose(m.points[inlet, 0], 0.0)
    assert np.allclose(m.points[outlet, 0], 4.0)
    wp = m.points[walls]
    on_wall = (np.isclose(np.abs(wp[:, 1]), 0.5)
               | np.isclose(np.abs(wp[:, 2]), 0.5))
    assert on_wall.all()


def test_sizefield_no_degenerate_boundary_edges():
    """Regression (round 3): the adaptive loop resampler emitted a
    duplicate point at a rect corner when the walk landed within eps of
    the chain endpoint (_walk_chain's sliver guard was dead code) — the
    zero-length boundary edge made Delaunay edge recovery loop forever.
    Reproducer: the dfg2d sizefield at wake_factor=0.5."""
    from stabilized_navier_stokes_flow_fenicsx.apps.dfg2d import (
        dfg2d_mesh)

    m = dfg2d_mesh(0.5, 0.5, wake_factor=0.5, near_growth=0.25)
    assert m.n_nodes > 1000
    assert (m.cell_volumes() > 0).all()
