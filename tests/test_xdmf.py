"""XDMF I/O with raw binary heavy data (io/xdmf.py), on a small mesh."""

import os
import xml.etree.ElementTree as ET

import numpy as np
import pytest

from stabilized_navier_stokes_flow_fenicsx.io.xdmf import (
    XdmfTimeSeries, read_xdmf_function, read_xdmf_series,
    write_xdmf_function)
from stabilized_navier_stokes_flow_fenicsx.mesh.structured import duct_mesh


@pytest.fixture(scope="module")
def mesh():
    return duct_mesh(3, 4, length=2.0)


@pytest.mark.parametrize("vs", [1, 3])
def test_xdmf_function_roundtrip(tmp_path, mesh, vs):
    vals = np.random.default_rng(vs).standard_normal((mesh.n_nodes, vs))
    if vs == 1:
        vals = vals[:, 0]
    base = str(tmp_path / "Re10ChannelVelocity")
    write_xdmf_function(base, mesh, vals, "Velocity")
    m2, v2 = read_xdmf_function(base, "Velocity")
    np.testing.assert_array_equal(m2.cells, mesh.cells)
    np.testing.assert_array_equal(m2.points, mesh.points)
    np.testing.assert_array_equal(v2, vals)
    # heavy data: raw little-endian binary files beside the .xdmf
    items = ET.parse(base + ".xdmf").getroot().iter("DataItem")
    for item in items:
        assert item.get("Format") == "Binary"
        assert item.get("Endian") == "Little"
        assert os.path.exists(os.path.join(str(tmp_path), item.text))
    raw = np.fromfile(base + "_Velocity_0.bin", "<f8")
    np.testing.assert_array_equal(raw, np.ravel(vals))


def test_xdmf_series_roundtrip(tmp_path, mesh):
    u = np.random.default_rng(0).standard_normal((mesh.n_nodes, 3))
    base = str(tmp_path / "series")
    with XdmfTimeSeries(base, mesh, "Velocity") as ts:
        for k, t in enumerate((0.0, 0.25, 1.5)):
            ts.append((k + 1) * u, t)
    m, vals, times = read_xdmf_series(base, "Velocity")
    assert vals.shape == (3, mesh.n_nodes, 3)
    np.testing.assert_array_equal(times, [0.0, 0.25, 1.5])
    np.testing.assert_array_equal(vals[2], 3 * u)
    np.testing.assert_array_equal(m.cells, mesh.cells)
    _, v0 = read_xdmf_function(base, "Velocity")
    np.testing.assert_array_equal(v0, u)
