"""File I/O: KRTD cameras, list files, VTK XML formats, MetaImage, npz,
TUM RGB-D and ScanNet ``.sens`` sequences."""

from .dataset import DepthMapDataset, load_view, save_view_npz
from .krtd import read_krtd, write_krtd
from .listfile import extract_all_file_paths
from .mha import read_mha, write_mha
from .polydata import PolyData, read_vtp, read_vts, write_vtp, write_vts
from .scannet import ScanNetSensDataset
from .tum import TUMDataset, TUMIntrinsics, quaternion_to_rotation
from .vti import ImageData, read_depth_map, read_vti, write_depth_map_vti, write_vti

__all__ = [
    "DepthMapDataset",
    "ImageData",
    "PolyData",
    "ScanNetSensDataset",
    "TUMDataset",
    "TUMIntrinsics",
    "extract_all_file_paths",
    "load_view",
    "quaternion_to_rotation",
    "read_depth_map",
    "read_krtd",
    "read_mha",
    "read_vti",
    "read_vtp",
    "read_vts",
    "save_view_npz",
    "write_depth_map_vti",
    "write_krtd",
    "write_mha",
    "write_vti",
    "write_vtp",
    "write_vts",
]
