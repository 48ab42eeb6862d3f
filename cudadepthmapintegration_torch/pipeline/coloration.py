"""Coloration pipeline: mesh in -> colorized mesh out.

Equivalent of ``Coloration/main.cxx:69-100`` + ``MeshColoration``: read a
.vtp mesh, project every vertex into every view, attach mean/median/count
point arrays, write the result.
"""

from __future__ import annotations

import dataclasses

from ..io.dataset import DepthMapDataset
from ..io.polydata import PolyData, read_vtp, write_vtp
from ..ops.coloration import colorize_mesh
from ..utils.log import Log

__all__ = ["ColorationConfig", "ColorationPipeline"]


@dataclasses.dataclass
class ColorationConfig:
    vti_list: str  # file listing depth-map paths
    krtd_list: str  # file listing camera paths
    z_test: bool = False  # opt-in visibility fix (reference has none)
    dtype: str = "float32"
    device: str = "cuda"  # where the gather and the reductions run
    # Reference numerator parity (MeshColoration.cxx:176-178).
    compat_int_mean: bool = False
    # Opt-in per-view occlusion test (world units; reference has none).
    occlusion_tol: float | None = None


class ColorationPipeline:
    def __init__(self, config: ColorationConfig, log: Log | None = None):
        self.config = config
        self.log = log or Log(verbose=False)

    def load_views(self):
        """Preload all views, as the reference does
        (``Coloration/MeshColoration.cxx:65-71``)."""
        dataset = DepthMapDataset(self.config.vti_list, self.config.krtd_list)
        return list(dataset)

    def run_on_mesh(self, mesh: PolyData) -> PolyData:
        views = self.load_views()
        with self.log.phase("Process coloration"):
            return colorize_mesh(
                mesh,
                views,
                z_test=self.config.z_test,
                dtype=self.config.dtype,
                compat_int_mean=self.config.compat_int_mean,
                occlusion_tol=self.config.occlusion_tol,
                device=self.config.device,
            )

    def run(self, input_path: str, output_path: str) -> PolyData:
        with self.log.phase("Read input"):
            mesh = read_vtp(input_path)
        out = self.run_on_mesh(mesh)
        with self.log.phase("Write output image"):
            write_vtp(output_path, out)
        return out
