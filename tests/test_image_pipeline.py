"""Image -> contours -> meshes pipeline on synthetic annulus images."""

import numpy as np
import pytest

from stabilized_navier_stokes_flow_fenicsx.mesh.extrude import (
    extrude_channel, split_prisms)
from stabilized_navier_stokes_flow_fenicsx.mesh.image import (
    find_contours, get_contours, load_image, optimize_contour, rdp)
from stabilized_navier_stokes_flow_fenicsx.mesh.tri2d import (
    points_in_polygon, triangulate_cross_section, triangulate_polygon)
from stabilized_navier_stokes_flow_fenicsx.utils.testimg import (
    make_annulus_image)


@pytest.fixture(scope="module")
def circle_img(tmp_path_factory):
    p = tmp_path_factory.mktemp("img") / "circle.png"
    return make_annulus_image(str(p), "circle", size=400,
                              r_inner=0.2319, r_outer=0.3157)


def test_find_contours_circle(circle_img):
    g = load_image(circle_img)
    cs = get_contours(g)
    assert len(cs) == 2
    # contours[0] is the outer ring edge, [1] the inner
    r0 = np.hypot(cs[0][:, 0], cs[0][:, 1])
    r1 = np.hypot(cs[1][:, 0], cs[1][:, 1])
    assert r0.mean() > r1.mean()
    assert r0.std() < 0.01 and r1.std() < 0.01
    np.testing.assert_allclose(r0.mean(), 0.3157, atol=0.01)
    np.testing.assert_allclose(r1.mean(), 0.2319, atol=0.01)


def test_marching_squares_subpixel():
    # linear field: contour of x at 0.5 must be the exact line x = 0.5
    x = np.linspace(0, 1, 11)
    img = np.tile(x, (11, 1))
    cs = find_contours(img, 0.5)
    assert len(cs) == 1
    np.testing.assert_allclose(cs[0][:, 1], 5.0, atol=1e-12)


def test_rdp_collinear():
    pts = np.array([[0, 0], [0.5, 1e-6], [1, 0], [1, 1]], dtype=float)
    out = rdp(pts, 1e-3)
    assert len(out) == 3


def test_optimize_contour_smooths(circle_img):
    g = load_image(circle_img)
    cs = get_contours(g)
    c, lc = optimize_contour(cs[1])
    r = np.hypot(c[:, 0], c[:, 1])
    assert r.std() < 2e-3          # FFT low-pass kills pixel jaggies
    assert 0.01 < lc < 0.05


def test_cross_section_regions(circle_img):
    g = load_image(circle_img)
    cs = get_contours(g)
    co, _ = optimize_contour(cs[0], cutoff=0.15, mesh_lc_frac=0.01)
    ci, _ = optimize_contour(cs[1], cutoff=0.15, mesh_lc_frac=0.01)
    tri = triangulate_cross_section(ci[:, [1, 0]], co[:, [1, 0]], lc=0.05)
    areas = tri.mesh.cell_volumes()
    np.testing.assert_allclose(areas.sum(), 1.0, rtol=1e-12)
    a_inner = areas[tri.regions == 2].sum()
    np.testing.assert_allclose(a_inner, np.pi * 0.2319**2, rtol=0.02)


def test_extrusion_volume_and_markers(circle_img):
    g = load_image(circle_img)
    cs = get_contours(g)
    co, _ = optimize_contour(cs[0], cutoff=0.15, mesh_lc_frac=0.01)
    ci, _ = optimize_contour(cs[1], cutoff=0.15, mesh_lc_frac=0.01)
    inner = ci[:, [1, 0]]
    tri = triangulate_cross_section(inner, co[:, [1, 0]], lc=0.08)
    msh = extrude_channel(tri, inner, lc=0.08)
    band = tri.mesh.cell_volumes()[tri.regions == 1].sum()
    np.testing.assert_allclose(
        msh.cell_volumes().sum(), 4.0 - 0.5 * band, rtol=1e-12)
    assert set(np.unique(msh.facet_markers)) == {1, 2, 3, 4}
    # inlet_1 area == inner region area
    f1 = msh.facets[msh.facet_markers == 1]
    tp = msh.points[f1]
    a1 = np.linalg.norm(
        np.cross(tp[:, 1] - tp[:, 0], tp[:, 2] - tp[:, 0]) / 2, axis=1).sum()
    np.testing.assert_allclose(
        a1, tri.mesh.cell_volumes()[tri.regions == 2].sum(), rtol=1e-10)


def test_split_prisms_conforming():
    # two stacked prisms sharing a quad face must produce matching tets
    prisms = np.array([[0, 1, 2, 3, 4, 5], [3, 4, 5, 6, 7, 8]])
    tets = split_prisms(prisms)
    assert tets.shape == (6, 4)
    # every shared-face diagonal consistent: collect faces, none crossed
    from stabilized_navier_stokes_flow_fenicsx.mesh.core import (
        facets_of_cells)
    fv, _ = facets_of_cells("tetrahedron", tets.astype(np.int32))
    _, counts = np.unique(fv, axis=0, return_counts=True)
    assert set(counts.tolist()) <= {1, 2}


def test_point_in_polygon():
    loop = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=float)
    pts = np.array([[0.5, 0.5], [1.5, 0.5], [-0.1, 0.2], [0.99, 0.01]])
    np.testing.assert_array_equal(
        points_in_polygon(pts, loop), [True, False, False, True])
