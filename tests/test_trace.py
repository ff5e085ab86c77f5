"""Streamtracer unit tests: locator correctness, RK45 accuracy, events."""

import numpy as np
import jax.numpy as jnp

from stabilized_navier_stokes_flow_fenicsx.fem.interpolate import (
    build_locator, device_locator, interpolate_p1_np, locate_np)
from stabilized_navier_stokes_flow_fenicsx.mesh.structured import (
    box_tet, duct_mesh, unit_square_tri)
from stabilized_navier_stokes_flow_fenicsx.trace.alpha_shape import (
    alpha_shape_polygon, expand_bbox)
from stabilized_navier_stokes_flow_fenicsx.trace.streamtrace import (
    TraceConfigDevice, trace_particles)


def test_locator_finds_points():
    mesh = box_tet((5, 5, 5), (0, 0, 0), (1, 1, 1))
    loc = build_locator(mesh)
    rng = np.random.default_rng(0)
    q = rng.random((200, 3)) * 0.999 + 5e-4
    cell, bary = locate_np(loc, q)
    assert (cell >= 0).all()
    # barycentric reconstruction returns the query point
    verts = mesh.points[mesh.cells[cell]]
    rec = np.einsum("nv,nvd->nd", bary, verts)
    np.testing.assert_allclose(rec, q, atol=1e-12)
    # points outside -> -1
    cell_out, _ = locate_np(loc, np.array([[2.0, 0.5, 0.5]]))
    assert cell_out[0] == -1


def test_interpolate_linear_exact():
    mesh = unit_square_tri(7, 9)
    vals = 2.0 * mesh.points[:, 0] - 3.0 * mesh.points[:, 1] + 0.25
    rng = np.random.default_rng(1)
    q = rng.random((50, 2))
    out = interpolate_p1_np(mesh, vals, q)
    np.testing.assert_allclose(out, 2 * q[:, 0] - 3 * q[:, 1] + 0.25,
                               atol=1e-12)


def test_trace_uniform_field_hits_plane():
    """Uniform u = (1, 0, 0): particles hit the x = 3.7 plane exactly."""
    mesh = duct_mesh(4, 16, length=4.0)
    loc = build_locator(mesh)
    dloc = device_locator(loc)
    u = np.zeros((mesh.n_nodes, 3))
    u[:, 0] = 1.0
    seeds = np.array([[0.0, 0.1, -0.2], [0.0, -0.3, 0.3]])
    cfg = TraceConfigDevice(x_stop=3.7, stop_direction=1)
    end = np.asarray(trace_particles(cfg, dloc, jnp.asarray(u),
                                     jnp.asarray(seeds)))
    np.testing.assert_allclose(end[:, 0], 3.7, atol=1e-3)
    np.testing.assert_allclose(end[:, 1:], seeds[:, 1:], atol=1e-9)


def test_trace_reverse_field():
    """reverse=True integrates the negated field back to x = 0.13."""
    mesh = duct_mesh(4, 16, length=4.0)
    dloc = device_locator(build_locator(mesh))
    u = np.zeros((mesh.n_nodes, 3))
    u[:, 0] = 2.0
    seeds = np.array([[3.9, 0.0, 0.0]])
    cfg = TraceConfigDevice(x_stop=0.13, stop_direction=-1)
    end = np.asarray(trace_particles(cfg, dloc, jnp.asarray(u),
                                     jnp.asarray(seeds), True))
    np.testing.assert_allclose(end[0, 0], 0.13, atol=1e-3)


def test_trace_rotation_accuracy():
    """Rigid rotation in (y, z): radius is conserved by adaptive RK45."""
    mesh = duct_mesh(10, 4, length=1.0)
    dloc = device_locator(build_locator(mesh))
    pts = mesh.points
    u = np.stack([np.zeros(len(pts)), -pts[:, 2], pts[:, 1]], axis=1)
    seeds = np.array([[0.5, 0.3, 0.0]])
    cfg = TraceConfigDevice(t_max=5.0, x_stop=100.0, rtol=1e-8, atol=1e-10)
    end = np.asarray(trace_particles(cfg, dloc, jnp.asarray(u),
                                     jnp.asarray(seeds)))
    r_end = np.hypot(end[0, 1], end[0, 2])
    # P1 interpolation of a linear field is exact; RK45 keeps the radius
    np.testing.assert_allclose(r_end, 0.3, rtol=1e-5)


def test_trace_speed_event_stops():
    """Zero velocity region: the speed event terminates immediately."""
    mesh = duct_mesh(4, 8, length=4.0)
    dloc = device_locator(build_locator(mesh))
    u = np.zeros((mesh.n_nodes, 3))
    seeds = np.array([[1.0, 0.0, 0.0]])
    cfg = TraceConfigDevice()
    end = np.asarray(trace_particles(cfg, dloc, jnp.asarray(u),
                                     jnp.asarray(seeds)))
    np.testing.assert_allclose(end[0], seeds[0], atol=1e-9)


def _small_channel(tmp_path, lc=0.12):
    from stabilized_navier_stokes_flow_fenicsx.mesh.extrude import (
        extrude_channel)
    from stabilized_navier_stokes_flow_fenicsx.mesh.image import (
        get_contours, load_image, optimize_contour)
    from stabilized_navier_stokes_flow_fenicsx.mesh.tri2d import (
        triangulate_cross_section)
    from stabilized_navier_stokes_flow_fenicsx.utils.testimg import (
        make_annulus_image)

    img = str(tmp_path / "c.png")
    make_annulus_image(img, "circle", size=300)
    g = load_image(img)
    cs = get_contours(g)
    co, _ = optimize_contour(cs[0], cutoff=0.15, mesh_lc_frac=0.01)
    ci, _ = optimize_contour(cs[1], cutoff=0.15, mesh_lc_frac=0.01)
    inner = ci[:, [1, 0]]
    tri = triangulate_cross_section(inner, co[:, [1, 0]], lc=lc)
    return extrude_channel(tri, inner, lc=lc, compact=False)


def test_layered_locator_matches_general(tmp_path):
    """LayeredDeviceLocator (extrusion-recovered) agrees with the general
    grid locator: same containment and identical interpolated values."""
    import jax

    from stabilized_navier_stokes_flow_fenicsx.fem.interpolate import (
        build_layered_locator, locate_device, locate_device_layered)

    mesh = _small_channel(tmp_path)
    lay = build_layered_locator(mesh)
    assert lay is not None
    gen = device_locator(build_locator(mesh))
    rng = np.random.default_rng(3)
    q = np.stack([rng.uniform(0.05, 3.95, 400),
                  rng.uniform(-0.6, 0.6, 400),
                  rng.uniform(-0.6, 0.6, 400)], axis=1)
    # strictly-interior points only (tol-boundary points may legally
    # resolve to different neighbor cells)
    cg, bg = jax.vmap(lambda p: locate_device(gen, p, -1e-9))(
        jnp.asarray(q))
    cl, bl = jax.vmap(lambda p: locate_device_layered(lay, p, -1e-9))(
        jnp.asarray(q))
    cg, cl = np.asarray(cg), np.asarray(cl)
    interior = cg >= 0
    assert interior.sum() > 100
    np.testing.assert_array_equal(cl[interior] >= 0,
                                  np.ones(interior.sum(), bool))
    # value agreement: interpolate a linear field through both
    vals = (2.0 * mesh.points[:, 0] - 0.7 * mesh.points[:, 1]
            + 0.3 * mesh.points[:, 2])
    for c, b in ((cg, np.asarray(bg)), (cl, np.asarray(bl))):
        got = np.einsum("nv,nv->n", b[interior],
                        vals[mesh.cells[c[interior]]])
        want = (2.0 * q[interior, 0] - 0.7 * q[interior, 1]
                + 0.3 * q[interior, 2])
        np.testing.assert_allclose(got, want, atol=1e-5)
    # outside the channel -> -1 on both
    qo = np.array([[2.0, 5.0, 5.0], [-1.0, 0.0, 0.0]])
    co_l, _ = jax.vmap(lambda p: locate_device_layered(lay, p))(
        jnp.asarray(qo))
    assert (np.asarray(co_l) == -1).all()


def test_layered_locator_survives_xdmf_roundtrip(tmp_path):
    """Extrusion recovery works on a mesh re-read from XDMF — the
    product trace path (InletBatchScript re-reads from disk)."""
    from stabilized_navier_stokes_flow_fenicsx.fem.interpolate import (
        LayeredDeviceLocator, build_trace_locator)
    from stabilized_navier_stokes_flow_fenicsx.io.xdmf import (
        read_xdmf_function, write_xdmf_function)

    mesh = _small_channel(tmp_path)
    u = np.zeros((mesh.n_nodes, 3))
    u[:, 0] = 1.0
    write_xdmf_function(str(tmp_path / "V"), mesh, u, "Velocity")
    mesh_r, u_r = read_xdmf_function(str(tmp_path / "V"), "Velocity")
    dloc = build_trace_locator(mesh_r)
    assert isinstance(dloc, LayeredDeviceLocator)
    # and the tracer runs on it end to end
    seeds = np.array([[0.0, 0.05, 0.0], [0.0, -0.05, 0.1]])
    cfg = TraceConfigDevice(x_stop=3.7, stop_direction=1)
    end = np.asarray(trace_particles(cfg, dloc, jnp.asarray(u_r),
                                     jnp.asarray(seeds)))
    np.testing.assert_allclose(end[:, 0], 3.7, atol=1e-3)


def test_alpha_shape_circle():
    rng = np.random.default_rng(2)
    th = rng.uniform(0, 2 * np.pi, 500)
    r = 0.3 * np.sqrt(rng.uniform(0, 1, 500))
    pts = np.stack([r * np.cos(th), r * np.sin(th)], axis=1)
    poly = alpha_shape_polygon(pts, alpha=0.2)
    rad = np.hypot(poly[:, 0], poly[:, 1])
    assert rad.max() <= 0.31
    assert rad.min() > 0.15          # boundary hugs the disk edge


def test_expand_bbox_reference_quirk():
    x = np.array([-0.3, 0.0, 0.4])
    y = np.array([0.1, 0.2, 0.5])    # min/max same sign branch
    minx, maxx, miny, maxy = expand_bbox(x, y, blurr=0.2)
    np.testing.assert_allclose([minx, maxx], [-0.36, 0.48], atol=1e-14)
    np.testing.assert_allclose([miny, maxy], [0.08, 0.6], atol=1e-14)
