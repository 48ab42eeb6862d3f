"""The port's ``ReconstructionFilter`` against its integrator, the JAX filter
and the float64 oracle.

The scene is 40 views of 24x18 written to disk, so the filter fuses two
batches (32 + 8). Tolerances, and why:

* against the port's ``TSDFIntegrator`` fed the same batches: **bit for
  bit** (the filter is that integrator behind the VTK-style setters);
* against the JAX filter with ``set_backend("pallas")`` in interpreter mode:
  **1e-3**, as in tests/test_torch_pipeline.py: the Pallas plan relabels
  grid axes per orientation group on an orbit rig and adds the groups in
  sorted order;
* against the float64 oracle: the pixel-flip budget, at most 2e-4 of the
  voxels off by more than 1e-3 (docs/PARITY.md).
"""

import numpy as np
import pytest
import torch

import cudadepthmapintegration_tpu.kernels.integrate_pallas as KP
from cudadepthmapintegration_torch.core import RayPotential, VoxelGrid
from cudadepthmapintegration_torch.io import DepthMapDataset
from cudadepthmapintegration_torch.ops import TSDFIntegrator, integrate_views_oracle
from cudadepthmapintegration_torch.pipeline import ReconstructionFilter
from cudadepthmapintegration_tpu.io import write_depth_map_vti, write_krtd
from cudadepthmapintegration_tpu.pipeline import ReconstructionFilter as JaxFilter
from cudadepthmapintegration_tpu.testing import sphere_scene

N_VIEWS = 40
DIMS, ORIGIN, SPACING = (17, 15, 13), (-1.6, -1.4, -1.2), (0.2, 0.2, 0.2)
PARAMS = dict(rho=0.8, thick=0.1, eta=0.03, delta=0.3)
THRESH = 0.5
NO_CARD = (AssertionError, RuntimeError)  # CPU-only build; CUDA build, no device
# A rotation about z and a shift: the filter accepts any 4x4 grid matrix.
ROT = np.array([[0.0, -1.0, 0.0, 0.1], [1.0, 0.0, 0.0, -0.2],
                [0.0, 0.0, 1.0, 0.3], [0.0, 0.0, 0.0, 1.0]])


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    folder = tmp_path_factory.mktemp("filter_scene")
    views = sphere_scene(n_views=N_VIEWS, width=24, height=18, focal=22.0)
    for i, v in enumerate(views):
        write_depth_map_vti(str(folder / f"f{i:02d}.vti"), v.depth, v.color, v.best_cost)
        write_krtd(str(folder / f"f{i:02d}.krtd"), v.camera)
    (folder / "vtiList.txt").write_text("".join(f"f{i:02d}.vti\n" for i in range(N_VIEWS)))
    (folder / "kList.txt").write_text("".join(f"f{i:02d}.krtd\n" for i in range(N_VIEWS)))
    return folder


def configured(cls, folder, matrix=None):
    f = (
        cls()
        .set_ray_potential_rho(PARAMS["rho"])
        .set_ray_potential_thickness(PARAMS["thick"])
        .set_ray_potential_eta(PARAMS["eta"])
        .set_ray_potential_delta(PARAMS["delta"])
        .set_threshold_best_cost(THRESH)
        .set_file_path_vti(str(folder / "vtiList.txt"))
        .set_file_path_krtd(str(folder / "kList.txt"))
    )
    if matrix is not None:
        f.set_grid_matrix(matrix)
    return f.set_input_grid(dims=DIMS, origin=ORIGIN, spacing=SPACING)


def integrator_volume(folder, matrix=np.eye(4)):
    grid = VoxelGrid(dims=DIMS, origin=ORIGIN, spacing=SPACING, matrix=matrix)
    views = list(DepthMapDataset(str(folder / "vtiList.txt"), str(folder / "kList.txt")))
    integ = TSDFIntegrator(grid, RayPotential(**PARAMS), device="cpu").reset()
    integ.integrate(views[:32], THRESH).integrate(views[32:], THRESH)
    assert integ.volume_sweeps == 2
    return integ.result()


@pytest.fixture(scope="module")
def port_volume(scene):
    f = configured(ReconstructionFilter, scene).set_device("cpu").update()
    assert f.get_execution_time() > 0
    return f.get_output_volume()


def test_filter_equals_integrator_bitwise(scene, port_volume):
    exp = integrator_volume(scene)
    assert port_volume.dtype == np.float32 and port_volume.shape == (12, 14, 16)
    assert np.abs(port_volume).max() > 0.5
    np.testing.assert_array_equal(port_volume.view(np.int32), exp.view(np.int32))


def test_filter_matches_jax_pallas_filter(scene, port_volume):
    KP.INTERPRET = True
    jax_filter = configured(JaxFilter, scene).set_backend("pallas").update()
    np.testing.assert_allclose(port_volume, jax_filter.get_output_volume(), rtol=0, atol=1e-3)


def test_filter_within_oracle_flip_budget(scene, port_volume):
    grid = VoxelGrid(dims=DIMS, origin=ORIGIN, spacing=SPACING)
    views = list(DepthMapDataset(str(scene / "vtiList.txt"), str(scene / "kList.txt")))
    oracle = integrate_views_oracle(grid, views, RayPotential(**PARAMS),
                                    threshold_best_cost=THRESH)
    assert float((np.abs(port_volume - oracle) > 1e-3).mean()) <= 2e-4


def test_filter_takes_any_grid_matrix(scene):
    vol = configured(ReconstructionFilter, scene, ROT).set_device("cpu").update().get_output_volume()
    exp = integrator_volume(scene, ROT)
    np.testing.assert_array_equal(vol.view(np.int32), exp.view(np.int32))


def test_filter_delta_below_thick_is_accepted(scene):
    # The CLI refuses delta < thick (main.cxx:270-276); the filter does not.
    f = configured(ReconstructionFilter, scene).set_ray_potential_delta(0.05)
    assert f.set_device("cpu").update().get_output_volume().shape == (12, 14, 16)


def test_filter_error_when_paths_missing():
    f = ReconstructionFilter().set_ray_potential_rho(0.8).set_device("cpu")
    with pytest.raises(ValueError, match="^Error, some inputs have not been set.$"):
        f.update()


def test_filter_error_when_grid_missing(scene):
    f = (ReconstructionFilter().set_ray_potential_rho(0.8).set_device("cpu")
         .set_file_path_vti(str(scene / "vtiList.txt"))
         .set_file_path_krtd(str(scene / "kList.txt")))
    with pytest.raises(ValueError, match="^input grid has not been set$"):
        f.update()


def test_filter_error_when_potential_unset(scene):
    f = (ReconstructionFilter().set_device("cpu")
         .set_file_path_vti(str(scene / "vtiList.txt"))
         .set_file_path_krtd(str(scene / "kList.txt"))
         .set_input_grid(dims=(9, 9, 9), origin=(0, 0, 0), spacing=(1, 1, 1)))
    with pytest.raises(
        ValueError, match="^Error : Ray potential Rho or Thickness or both have not been set$"
    ):
        f.update()


def test_filter_outputs_before_update():
    f = ReconstructionFilter()
    assert f.get_execution_time() == -1.0
    with pytest.raises(RuntimeError, match="call update"):
        f.get_output_volume()


def test_filter_defaults_to_the_card(scene):
    f = configured(ReconstructionFilter, scene)
    if torch.cuda.is_available():
        assert f.update().get_output_volume().shape == (12, 14, 16)
        return
    with pytest.raises(NO_CARD):
        f.update()
    assert f.get_execution_time() == -1.0  # nothing ran on the CPU instead
