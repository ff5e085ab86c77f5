"""XDMF solution I/O with raw binary heavy data (ParaView-compatible).

Replaces ``dolfinx.io.XDMFFile`` writes (reference
NavierStokes/NavierStokesChannelFlow.py:316-346: two files per run,
functions named "Pressure"/"Velocity") and the h5py + adios4dolfinx
re-read path (reference streamtrace.py:58-130).  The heavy data are
XDMF ``Format="Binary"`` DataItems: raw little-endian arrays in files
beside the ``.xdmf`` (int64 topology, float64 geometry and values),
which ParaView's XDMF reader loads.  The reader parses the XML and
follows its DataItems, so the solution files double as checkpoints:
solve and streamtrace can run as separate jobs exactly like the
reference (streamtrace.py:667-690).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Tuple

import numpy as np

from ..mesh.core import SimplexMesh

_TOPOLOGY_TYPE = {"triangle": "Triangle", "tetrahedron": "Tetrahedron"}
_NUMBER_TYPE = {np.dtype("<i8"): ("Int", 8), np.dtype("<f8"): ("Float", 8)}

_HEADER = """<?xml version="1.0"?>
<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>
<Xdmf Version="3.0">
  <Domain>
"""
_FOOTER = """  </Domain>
</Xdmf>
"""


def _write_raw(path: str, arr: np.ndarray, dtype: str) -> np.ndarray:
    arr = np.ascontiguousarray(arr, dtype=np.dtype(dtype))
    arr.tofile(path)
    return arr


def _data_item(arr: np.ndarray, fname: str) -> str:
    ntype, prec = _NUMBER_TYPE[arr.dtype]
    dims = " ".join(str(d) for d in arr.shape)
    return (f'<DataItem Dimensions="{dims}" NumberType="{ntype}" '
            f'Precision="{prec}" Endian="Little" Format="Binary">'
            f'{fname}</DataItem>')


def _as_columns(values: np.ndarray) -> np.ndarray:
    values = np.asarray(values, dtype=np.float64)
    return values[:, None] if values.ndim == 1 else values


def _mesh_xml(basename: str, mesh: SimplexMesh) -> str:
    """Write the mesh's topology/geometry files; return their XML."""
    stem = os.path.basename(basename)
    topo = _write_raw(basename + "_topology.bin", mesh.cells, "<i8")
    geom = _write_raw(basename + "_geometry.bin", mesh.points, "<f8")
    return (f'<Topology TopologyType="{_TOPOLOGY_TYPE[mesh.cell]}" '
            f'NumberOfElements="{mesh.n_cells}" '
            f'NodesPerElement="{mesh.cells.shape[1]}">'
            f'{_data_item(topo, stem + "_topology.bin")}</Topology>'
            f'<Geometry GeometryType="{"XYZ" if mesh.gdim == 3 else "XY"}">'
            f'{_data_item(geom, stem + "_geometry.bin")}</Geometry>')


def _attribute(basename: str, name: str, values: np.ndarray,
               step: int) -> str:
    fname = f"{basename}_{name}_{step}.bin"
    vals = _write_raw(fname, values, "<f8")
    atype = "Vector" if vals.shape[1] > 1 else "Scalar"
    return (f'<Attribute Name="{name}" AttributeType="{atype}" '
            f'Center="Node">{_data_item(vals, os.path.basename(fname))}'
            '</Attribute>')


def write_xdmf_function(
    basename: str,
    mesh: SimplexMesh,
    values: np.ndarray,
    name: str,
) -> str:
    """Write <basename>.xdmf and its raw data files with one nodal
    function."""
    grid = (f'    <Grid Name="mesh" GridType="Uniform">'
            f'{_mesh_xml(basename, mesh)}'
            f'{_attribute(basename, name, _as_columns(values), 0)}'
            '</Grid>\n')
    with open(basename + ".xdmf", "w") as f:
        f.write(_HEADER + grid + _FOOTER)
    return basename + ".xdmf"


def _read_item(item: ET.Element, folder: str) -> np.ndarray:
    if item.get("Format") != "Binary":
        raise ValueError(f"unsupported DataItem format {item.get('Format')}")
    ntype = item.get("NumberType", "Float")
    prec = int(item.get("Precision", "4"))
    endian = ">" if item.get("Endian") == "Big" else "<"
    dtype = np.dtype(f"{endian}{'i' if ntype == 'Int' else 'f'}{prec}")
    shape = tuple(int(d) for d in item.get("Dimensions").split())
    arr = np.fromfile(os.path.join(folder, item.text.strip()), dtype=dtype)
    return arr.reshape(shape)


def _read_grid(grid: ET.Element, folder: str, name: str):
    topo = _read_item(grid.find("Topology/DataItem"), folder)
    geom = _read_item(grid.find("Geometry/DataItem"), folder)
    for attr in grid.iter("Attribute"):
        if attr.get("Name") == name:
            vals = _read_item(attr.find("DataItem"), folder)
            break
    else:
        raise KeyError(f"no attribute {name!r} in the XDMF grid")
    cell = "tetrahedron" if topo.shape[1] == 4 else "triangle"
    mesh = SimplexMesh(cell, geom.astype(np.float64), topo.astype(np.int32))
    return mesh, vals.astype(np.float64)


def _uniform_grids(basename: str):
    root = ET.parse(basename + ".xdmf").getroot()
    return [g for g in root.iter("Grid") if g.get("GridType") == "Uniform"]


def read_xdmf_function(basename: str, name: str
                       ) -> Tuple[SimplexMesh, np.ndarray]:
    """Read (mesh, nodal values) back — the reference's
    read_mesh_and_function (streamtrace.py:58-130), minus the MPI
    redistribution dance (single address space).  On a time series this
    reads step 0."""
    folder = os.path.dirname(os.path.abspath(basename))
    mesh, vals = _read_grid(_uniform_grids(basename)[0], folder, name)
    if vals.shape[1] == 1:
        vals = vals[:, 0]
    return mesh, vals


class XdmfTimeSeries:
    """ParaView-animatable temporal collection (one mesh, many steps).

    The reference writes single snapshots only; this covers the
    time-series/animation use its users reach for ParaView for
    (continuation histories, Re sweeps on one mesh).  Steps share the
    mesh files; each append writes ``<basename>_<name>_<i>.bin`` and
    rewrites the small XML index, so the file set stays valid (and
    re-readable as a checkpoint via ``read_xdmf_function`` step 0)
    after every step — crash-safe like the reference's write-then-trace
    flow."""

    def __init__(self, basename: str, mesh: SimplexMesh, name: str):
        self.basename = basename
        self.name = name
        self._mesh_xml = _mesh_xml(basename, mesh)
        self._grids = []

    def append(self, values: np.ndarray, t: float) -> None:
        step = len(self._grids)
        attr = _attribute(self.basename, self.name, _as_columns(values),
                          step)
        self._grids.append(
            f'      <Grid Name="t{step}" GridType="Uniform">'
            f'<Time Value="{float(t)!r}"/>{self._mesh_xml}{attr}</Grid>\n')
        with open(self.basename + ".xdmf", "w") as f:
            f.write(_HEADER
                    + f'    <Grid Name="{self.name}_series" '
                    'GridType="Collection" CollectionType="Temporal">\n'
                    + "".join(self._grids) + "    </Grid>\n" + _FOOTER)

    def close(self) -> None:
        """Nothing stays open between appends; kept for the context
        manager protocol."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_xdmf_series(basename: str, name: str
                     ) -> Tuple[SimplexMesh, np.ndarray, np.ndarray]:
    """Read (mesh, values (nt, nn, vs), times) from a series file."""
    folder = os.path.dirname(os.path.abspath(basename))
    grids = _uniform_grids(basename)
    mesh, _ = _read_grid(grids[0], folder, name)
    vals = np.stack([_read_grid(g, folder, name)[1] for g in grids])
    times = np.asarray([float(g.find("Time").get("Value")) for g in grids])
    return mesh, vals, times
