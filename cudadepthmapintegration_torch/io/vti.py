"""VTK XML ImageData (.vti) read/write for depth maps and volumes.

Replaces ``vtkXMLImageDataReader`` usage at
``Sources/ReconstructionData.cxx:223-229``. Depth-map .vti files carry point
arrays named ``"Depths"`` (Float64), ``"Best Cost Values"`` (Float64) and
``"Color"`` (UInt8 x3) (``Reconstruction/CudaReconstruction.cu:247-251``,
``Sources/ReconstructionData.cxx:94-95,143-146``).

VTK image data is stored bottom-up (x fastest, then y, then z) — the origin is
the bottom-left pixel (``CudaReconstruction.cu:141-149``). :func:`read_depth_map`
flips rows once at load so in-memory images are top-down ``(H, W)``.
"""

from __future__ import annotations

import numpy as np

from ..core.camera import Camera
from ..core.view import DepthMapView
from .vtkxml import VtkXmlWriter, decode_data_array, parse_vtk_xml

__all__ = ["ImageData", "read_vti", "write_vti", "read_depth_map", "write_depth_map_vti"]


class ImageData:
    """A minimal vtkImageData stand-in: extent + spacing/origin + named arrays."""

    def __init__(self, dims, origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0)):
        self.dims = tuple(int(d) for d in dims)  # point dims (nx, ny, nz)
        self.origin = tuple(float(v) for v in origin)
        self.spacing = tuple(float(v) for v in spacing)
        self.point_data: dict[str, np.ndarray] = {}
        self.cell_data: dict[str, np.ndarray] = {}

    @property
    def num_points(self) -> int:
        nx, ny, nz = self.dims
        return nx * ny * nz

    @property
    def num_cells(self) -> int:
        nx, ny, nz = self.dims
        return max(nx - 1, 1) * max(ny - 1, 1) * max(nz - 1, 1)


def read_vti(path: str) -> ImageData:
    root, ctx = parse_vtk_xml(path)
    image = root.find("ImageData")
    if image is None:
        raise ValueError(f"{path} is not an ImageData VTKFile")
    extent = [int(v) for v in image.get("WholeExtent").split()]
    dims = (
        extent[1] - extent[0] + 1,
        extent[3] - extent[2] + 1,
        extent[5] - extent[4] + 1,
    )
    origin = tuple(float(v) for v in image.get("Origin", "0 0 0").split())
    spacing = tuple(float(v) for v in image.get("Spacing", "1 1 1").split())
    out = ImageData(dims, origin, spacing)
    piece = image.find("Piece")
    for section, store in (("PointData", out.point_data), ("CellData", out.cell_data)):
        sec = piece.find(section) if piece is not None else None
        if sec is None:
            continue
        for da in sec.findall("DataArray"):
            store[da.get("Name")] = decode_data_array(da, ctx)
    return out


def write_vti(path: str, image: ImageData, compress: bool = False) -> None:
    w = VtkXmlWriter(compress=compress)
    nx, ny, nz = image.dims
    extent = f"0 {nx - 1} 0 {ny - 1} 0 {nz - 1}"
    body = [
        f'  <ImageData WholeExtent="{extent}" '
        f'Origin="{image.origin[0]} {image.origin[1]} {image.origin[2]}" '
        f'Spacing="{image.spacing[0]} {image.spacing[1]} {image.spacing[2]}">\n',
        f'    <Piece Extent="{extent}">\n',
    ]
    for section, arrays in (
        ("PointData", image.point_data),
        ("CellData", image.cell_data),
    ):
        body.append(f"      <{section}>\n")
        for name, arr in arrays.items():
            body.append(w.data_array_xml(arr, name=name, indent="        "))
        body.append(f"      </{section}>\n")
    body.append("    </Piece>\n  </ImageData>\n")
    w.write(path, "ImageData", "".join(body))


def _rows_bottom_up_to_top_down(flat: np.ndarray, h: int, w: int, ncomp: int):
    """VTI point order is bottom-up; flip to top-down screen order."""
    if ncomp == 1:
        return flat.reshape(h, w)[::-1].copy()
    return flat.reshape(h, w, ncomp)[::-1].copy()


def read_depth_map(path: str, camera: Camera | None = None) -> DepthMapView:
    """Load a depth-map .vti into a :class:`DepthMapView` (rows top-down)."""
    img = read_vti(path)
    nx, ny, nz = img.dims
    if nz != 1:
        raise ValueError(f"depth map must be a 2-D image, got dims {img.dims}")
    if "Depths" not in img.point_data:
        raise ValueError(f"no 'Depths' point array in {path}")
    depth = _rows_bottom_up_to_top_down(
        img.point_data["Depths"].astype(np.float64), ny, nx, 1
    )
    color = None
    if "Color" in img.point_data:
        color = _rows_bottom_up_to_top_down(
            img.point_data["Color"].astype(np.uint8), ny, nx, 3
        )
    cost = None
    if "Best Cost Values" in img.point_data:
        cost = _rows_bottom_up_to_top_down(
            img.point_data["Best Cost Values"].astype(np.float64), ny, nx, 1
        )
    cam = camera if camera is not None else Camera(np.eye(3), np.eye(4))
    return DepthMapView(depth=depth, camera=cam, color=color, best_cost=cost, name=str(path))


def write_depth_map_vti(
    path: str,
    depth: np.ndarray,
    color: np.ndarray | None = None,
    best_cost: np.ndarray | None = None,
    compress: bool = False,
) -> None:
    """Write a top-down (H, W) depth image (+ optional color/cost) as a .vti
    with the reference's array names and bottom-up row order."""
    h, w = depth.shape
    img = ImageData((w, h, 1))
    img.point_data["Depths"] = depth[::-1].astype(np.float64).reshape(-1)
    if best_cost is not None:
        img.point_data["Best Cost Values"] = (
            best_cost[::-1].astype(np.float64).reshape(-1)
        )
    if color is not None:
        img.point_data["Color"] = color[::-1].astype(np.uint8).reshape(-1, 3)
    write_vti(path, img, compress=compress)
