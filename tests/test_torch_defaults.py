"""The port's library entry points run on the card unless asked for the CPU.

Each entry point's ``device`` defaults to ``"cuda"``. Without a card the
first allocation raises torch's error instead of running on the CPU: there
is no fallback. Whether this machine has a card is decided inside each test.
"""

import inspect

import numpy as np
import pytest
import torch

from cudadepthmapintegration_torch import interop
from cudadepthmapintegration_torch.core import RayPotential, VoxelGrid
from cudadepthmapintegration_torch.ops.coloration import colorize_mesh, colorize_points
from cudadepthmapintegration_torch.ops.integrate import TSDFIntegrator
from cudadepthmapintegration_torch.ops.sparse_grid import SparseTSDFGrid
from cudadepthmapintegration_torch.testing import orbit_cameras, render_sphere_view

ENTRY_POINTS = {
    "TSDFIntegrator": TSDFIntegrator.__init__,
    "colorize_points": colorize_points,
    "colorize_mesh": colorize_mesh,
    "SparseTSDFGrid": SparseTSDFGrid.__init__,
    "SparseTSDFGrid.load": SparseTSDFGrid.load,
    "interop.sparse_grid_from": interop.sparse_grid_from,
}

PARAMS = RayPotential(thick=0.1, rho=0.8, eta=0.03, delta=0.3)
GRID = VoxelGrid(dims=(5, 4, 3), origin=(0.0, 0.0, 0.0), spacing=(1.0, 1.0, 1.0))
NO_CARD = (AssertionError, RuntimeError)  # CPU-only build; CUDA build, no device


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_device_defaults_to_cuda(name):
    param = inspect.signature(ENTRY_POINTS[name]).parameters["device"]
    assert param.default == "cuda"


def test_integrator_reset_without_a_device_uses_the_card():
    integ = TSDFIntegrator(GRID, PARAMS)
    if torch.cuda.is_available():
        assert integ.reset().volume.device.type == "cuda"
        return
    with pytest.raises(NO_CARD):
        integ.reset()
    assert integ.volume is None  # nothing was made on the CPU instead


def test_sparse_grid_without_a_device_uses_the_card():
    if torch.cuda.is_available():
        assert SparseTSDFGrid(voxel_size=0.1, params=PARAMS).pool.is_cuda
        return
    with pytest.raises(NO_CARD):
        SparseTSDFGrid(voxel_size=0.1, params=PARAMS)


def test_colorize_points_without_a_device_uses_the_card():
    cam = orbit_cameras(1, 4.0, focal=40.0, width=32, image_height=24)[0]
    views = [render_sphere_view(cam, 32, 24, radius=1.0)]
    points = np.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], np.float32)
    if torch.cuda.is_available():
        assert colorize_points(points, views)[2].shape == (2,)
        return
    with pytest.raises(NO_CARD):
        colorize_points(points, views)
