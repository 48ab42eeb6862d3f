"""cudadepthmapintegration_torch — depth-map fusion on PyTorch and CUDA.

The PyTorch port of ``cudadepthmapintegration_tpu``: truncated
signed-distance ray-potential fusion of calibrated depth maps into a dense
voxel grid or, frame by frame, a sparse block grid; isosurface extraction
(marching cubes) and mesh coloration. The layout mirrors the JAX package
module for module. Plain tensor code is PyTorch; the hot loops (dense
integration, coloration gather, sparse per-frame update) are CUDA kernels
written for Hopper (``csrc/``), built at first use, with a plain PyTorch
version beside each that serves CPU tensors. The package never imports JAX.
"""

__version__ = "0.1.0"

from .core import Camera, DepthMapView, RayPotential, VoxelGrid

__all__ = ["Camera", "DepthMapView", "RayPotential", "VoxelGrid", "__version__"]
