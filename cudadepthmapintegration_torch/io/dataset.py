"""Depth-map dataset loading: list files -> DepthMapView sequence.

Combines the list-file resolver (``Sources/Helper.h:60-100``), the KRTD parser
(``Sources/Helper.h:105-168``) and the VTI reader into the equivalent of the
reference's per-view ``ReconstructionData(vti, krtd)`` construction
(``Sources/ReconstructionData.cxx:55-78``). Also accepts ``.npz`` views
natively (keys: depth, k, rt, optional color/best_cost) for a fast,
VTK-free interchange format.
"""

from __future__ import annotations

import os
from collections.abc import Iterator, Sequence

import numpy as np

from ..core.camera import Camera
from ..core.view import DepthMapView
from .krtd import read_krtd
from .listfile import extract_all_file_paths
from .vti import read_depth_map

__all__ = ["load_view", "DepthMapDataset", "save_view_npz"]


def save_view_npz(path: str, view: DepthMapView) -> None:
    arrays = {"depth": view.depth, "k": view.camera.k, "rt": view.camera.rt}
    if view.color is not None:
        arrays["color"] = view.color
    if view.best_cost is not None:
        arrays["best_cost"] = view.best_cost
    np.savez_compressed(path, **arrays)


def _load_view_npz(path: str) -> DepthMapView:
    with np.load(path) as z:
        return DepthMapView(
            depth=z["depth"].astype(np.float64),
            camera=Camera(k=z["k"], rt=z["rt"]),
            color=z["color"] if "color" in z else None,
            best_cost=z["best_cost"] if "best_cost" in z else None,
            name=str(path),
        )


def load_view(depth_path: str, krtd_path: str | None = None) -> DepthMapView:
    if depth_path.endswith(".npz"):
        view = _load_view_npz(depth_path)
        if krtd_path is not None:
            view.camera = read_krtd(krtd_path)
        return view
    camera = read_krtd(krtd_path) if krtd_path is not None else None
    return read_depth_map(depth_path, camera=camera)


class DepthMapDataset(Sequence):
    """Lazy sequence of views resolved from a vti list + krtd list.

    Views are read from disk on access, mirroring the reference's streaming
    loop, which re-reads each view inside the hot loop
    (``CudaReconstruction.cu:343-347``); callers batch/prefetch above this.
    """

    def __init__(self, vti_list_path: str, krtd_list_path: str):
        self.depth_paths = extract_all_file_paths(vti_list_path)
        self.krtd_paths = extract_all_file_paths(krtd_list_path)
        if len(self.depth_paths) == 0:
            raise ValueError(f"no depth maps listed in {vti_list_path}")
        if len(self.krtd_paths) < len(self.depth_paths):
            # Reference errors with "not enough krtd file for each vti file"
            # (Coloration/MeshColoration.cxx:60-63).
            raise ValueError(
                f"not enough krtd files ({len(self.krtd_paths)}) for "
                f"{len(self.depth_paths)} depth maps"
            )

    def __len__(self) -> int:
        return len(self.depth_paths)

    def __getitem__(self, i: int) -> DepthMapView:
        if isinstance(i, slice):
            raise TypeError("slicing not supported; index individually")
        return load_view(self.depth_paths[i], self.krtd_paths[i])

    def __iter__(self) -> Iterator[DepthMapView]:
        for i in range(len(self)):
            yield self[i]

    def camera(self, i: int) -> Camera:
        """Camera from the krtd file alone (no depth-map decode) — cheap
        rig-geometry access for ``parallel.rig.rig_cameras``."""
        return read_krtd(self.krtd_paths[i])

    def cameras(self) -> list[Camera]:
        return [self.camera(i) for i in range(len(self))]

    @staticmethod
    def from_folder(
        data_folder: str,
        depth_map_file: str = "vtiList.txt",
        krt_file: str = "kList.txt",
    ) -> "DepthMapDataset":
        """Reference CLI convention: dataFolder/vtiList.txt + dataFolder/kList.txt
        (``Reconstruction/main.cxx:128-131``)."""
        return DepthMapDataset(
            os.path.join(data_folder, depth_map_file),
            os.path.join(data_folder, krt_file),
        )
