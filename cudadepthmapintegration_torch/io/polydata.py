"""VTK XML PolyData (.vtp) read/write and StructuredGrid (.vts) write.

Replaces ``vtkXMLPolyDataWriter``/``vtkXMLPolyDataReader``
(``Reconstruction/main.cxx:184-189``, ``Coloration/main.cxx:77-90``) and
``vtkXMLStructuredGridWriter`` (``Reconstruction/main.cxx:192-198``).
"""

from __future__ import annotations

import numpy as np

from .vtkxml import VtkXmlWriter, decode_data_array, parse_vtk_xml

__all__ = ["PolyData", "read_vtp", "write_vtp", "read_vts", "write_vts"]


class PolyData:
    """Triangle-mesh container: (N, 3) float points, (M, 3) int32 triangles,
    and named per-point arrays."""

    def __init__(self, points: np.ndarray, triangles: np.ndarray):
        self.points = np.asarray(points, dtype=np.float64).reshape(-1, 3)
        self.triangles = np.asarray(triangles, dtype=np.int64).reshape(-1, 3)
        self.point_data: dict[str, np.ndarray] = {}
        # Name of the active-scalars point array (VTK attribute semantics);
        # written/read as the PointData Scalars="..." XML attribute.
        self.active_scalars: str | None = None

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.triangles.shape[0]


def read_vtp(path: str) -> PolyData:
    root, ctx = parse_vtk_xml(path)
    pd = root.find("PolyData")
    if pd is None:
        raise ValueError(f"{path} is not a PolyData VTKFile")
    piece = pd.find("Piece")
    pts_elem = piece.find("Points").find("DataArray")
    points = decode_data_array(pts_elem, ctx).reshape(-1, 3)
    polys = piece.find("Polys")
    triangles = np.zeros((0, 3), dtype=np.int64)
    if polys is not None:
        arrays = {da.get("Name"): da for da in polys.findall("DataArray")}
        connectivity = decode_data_array(arrays["connectivity"], ctx).astype(np.int64)
        offsets = decode_data_array(arrays["offsets"], ctx).astype(np.int64)
        # Split general polygons; keep triangles (the contour output is tris).
        tris = []
        start = 0
        for off in offsets:
            cell = connectivity[start:off]
            if len(cell) == 3:
                tris.append(cell)
            elif len(cell) > 3:  # fan-triangulate
                for i in range(1, len(cell) - 1):
                    tris.append(np.array([cell[0], cell[i], cell[i + 1]]))
            start = off
        if tris:
            triangles = np.stack(tris)
    out = PolyData(points, triangles)
    pdata = piece.find("PointData")
    if pdata is not None:
        for da in pdata.findall("DataArray"):
            out.point_data[da.get("Name")] = decode_data_array(da, ctx)
        out.active_scalars = pdata.get("Scalars")
    return out


def write_vtp(path: str, mesh: PolyData, compress: bool = False) -> None:
    w = VtkXmlWriter(compress=compress)
    n_pts = mesh.num_points
    n_tris = mesh.num_triangles
    # Mark active attributes like vtkXMLPolyDataWriter does.
    pd_attrs = ' Normals="Normals"' if "Normals" in mesh.point_data else ""
    active_scalars = getattr(mesh, "active_scalars", None)
    if active_scalars and active_scalars in mesh.point_data:
        pd_attrs += f' Scalars="{active_scalars}"'
    body = [
        "  <PolyData>\n",
        f'    <Piece NumberOfPoints="{n_pts}" NumberOfVerts="0" NumberOfLines="0" '
        f'NumberOfStrips="0" NumberOfPolys="{n_tris}">\n',
        f"      <PointData{pd_attrs}>\n",
    ]
    for name, arr in mesh.point_data.items():
        body.append(w.data_array_xml(arr, name=name, indent="        "))
    body.append("      </PointData>\n      <Points>\n")
    body.append(
        w.data_array_xml(
            mesh.points.astype(np.float32), name="Points", indent="        "
        )
    )
    body.append("      </Points>\n      <Polys>\n")
    conn = mesh.triangles.astype(np.int64).reshape(-1)
    offs = (np.arange(1, n_tris + 1, dtype=np.int64)) * 3
    body.append(w.data_array_xml(conn, name="connectivity", indent="        "))
    body.append(w.data_array_xml(offs, name="offsets", indent="        "))
    body.append("      </Polys>\n    </Piece>\n  </PolyData>\n")
    w.write(path, "PolyData", "".join(body))


def read_vts(path: str):
    """Read a StructuredGrid: returns (points (nz, ny, nx, 3), point_arrays,
    cell_arrays) — the inverse of :func:`write_vts`."""
    root, ctx = parse_vtk_xml(path)
    sg = root.find("StructuredGrid")
    if sg is None:
        raise ValueError(f"{path} is not a StructuredGrid VTKFile")
    extent = [int(v) for v in sg.get("WholeExtent").split()]
    nx = extent[1] - extent[0] + 1
    ny = extent[3] - extent[2] + 1
    nz = extent[5] - extent[4] + 1
    piece = sg.find("Piece")
    pts = decode_data_array(piece.find("Points").find("DataArray"), ctx)
    points = np.asarray(pts, np.float64).reshape(nz, ny, nx, 3)
    point_arrays: dict[str, np.ndarray] = {}
    cell_arrays: dict[str, np.ndarray] = {}
    for section, store in (("PointData", point_arrays), ("CellData", cell_arrays)):
        sec = piece.find(section)
        if sec is None:
            continue
        for da in sec.findall("DataArray"):
            store[da.get("Name")] = decode_data_array(da, ctx)
    return points, point_arrays, cell_arrays


def write_vts(
    path: str,
    points_zyx3: np.ndarray,
    point_arrays: dict[str, np.ndarray] | None = None,
    cell_arrays: dict[str, np.ndarray] | None = None,
    compress: bool = False,
) -> None:
    """Write a structured grid: ``points_zyx3`` has shape (nz, ny, nx, 3) in
    world coordinates (grid-matrix already applied, matching the transform at
    ``Reconstruction/main.cxx:191-198``)."""
    nz, ny, nx, _ = points_zyx3.shape
    w = VtkXmlWriter(compress=compress)
    extent = f"0 {nx - 1} 0 {ny - 1} 0 {nz - 1}"
    body = [
        f'  <StructuredGrid WholeExtent="{extent}">\n',
        f'    <Piece Extent="{extent}">\n',
        "      <PointData>\n",
    ]
    for name, arr in (point_arrays or {}).items():
        body.append(w.data_array_xml(arr, name=name, indent="        "))
    body.append("      </PointData>\n      <CellData>\n")
    for name, arr in (cell_arrays or {}).items():
        body.append(w.data_array_xml(arr, name=name, indent="        "))
    body.append("      </CellData>\n      <Points>\n")
    body.append(
        w.data_array_xml(
            points_zyx3.reshape(-1, 3).astype(np.float32),
            name="Points",
            indent="        ",
        )
    )
    body.append("      </Points>\n    </Piece>\n  </StructuredGrid>\n")
    w.write(path, "StructuredGrid", "".join(body))
