"""The port's integration on random geometry: ``random_scene`` of
tests/test_fuzz_parity.py (random grids, cameras of random rotation and
placement, random maps with holes, random ray parameters), on the same
seeds as that file. Tolerances, and why:

* **1e-9** at float64 against the JAX package's float64 oracle, which
  projects each voxel centre through the matrices in another order (the
  JAX package's own tolerance, tests/test_fuzz_parity.py);
* **1e-3** at float32 against the JAX package's Pallas kernel in interpreter
  mode: the Pallas plan relabels the grid axes per orientation group, so its
  table sum associates differently, by an ulp; no voxel may be off by more
  (the flip budget, 2e-4 of the voxels, rounds to none at these sizes), and
  the same against the oracle;
* **bit for bit, in int32 view**, between the CUDA kernel's order of
  evaluation written in plain torch (``kernel_order_fuse`` of
  tests/test_torch_integrate.py, on the tables ``stage_tables`` lays out)
  and the plain version, also from a volume of -0.0.

``chip_smoke.py`` meets the CUDA kernel with four of these scenes, made by
the port's copy of the generator (``scripts/fuzz_extended.random_scene``),
held here to ``random_scene``, draw for draw.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import cudadepthmapintegration_tpu.kernels.integrate_pallas as KP
from cudadepthmapintegration_torch import interop
from cudadepthmapintegration_torch.kernels.integrate_cuda import (
    integrate_views_torch,
    stage_tables,
)
from cudadepthmapintegration_torch.ops.integrate import TSDFIntegrator, projection_tables
from cudadepthmapintegration_torch.scripts import fuzz_extended
from cudadepthmapintegration_tpu.ops import integrate_views_oracle
from test_fuzz_parity import random_scene
from test_torch_integrate import KZ, NEG_ZERO, kernel_order_fuse

KP.INTERPRET = True

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOAT64_SEEDS = [1, 2, 3, 4, 5]
PALLAS_SEEDS = [11, 12, 13]
ALL_SEEDS = FLOAT64_SEEDS + PALLAS_SEEDS + [21, 22]


def port_scene(seed):
    grid, views, params = random_scene(seed)
    return grid, views, params, (interop.grid_from(grid), interop.views_from(views),
                                 interop.params_from(params))


def port_fuse(port, dtype):
    grid, views, params = port
    return TSDFIntegrator(grid, params, dtype=dtype, device="cpu").reset().integrate(views).result()


def off_frac(a, b):
    return float((np.abs(a - b) > 1e-3).mean())


@pytest.mark.parametrize("seed", FLOAT64_SEEDS)
def test_plain_float64_matches_oracle_fuzzed(seed):
    grid, views, params, port = port_scene(seed)
    got = port_fuse(port, torch.float64)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, integrate_views_oracle(grid, views, params), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("seed", PALLAS_SEEDS)
def test_plain_float32_matches_pallas_fuzzed(seed):
    grid, views, params, port = port_scene(seed)
    got = port_fuse(port, torch.float32)
    pallas = np.asarray(KP.integrate_views_oriented(
        np.zeros(grid.volume_shape, np.float32), grid, views, params))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-3)
    oracle = integrate_views_oracle(grid, views, params)
    assert off_frac(got, oracle) <= 2e-4
    assert np.abs(oracle).max() > 0.5  # the views reach the grid


@pytest.mark.parametrize("initial", [0.0, -0.0])
@pytest.mark.parametrize("seed", ALL_SEEDS)
def test_kernel_order_bitwise_fuzzed(seed, initial):
    _, _, _, (grid, views, params) = port_scene(seed)
    t = projection_tables(grid, views, np.float32)
    tables = [torch.from_numpy(a) for a in (t.tx, t.ty, t.tz, t.tc)]
    depths = torch.from_numpy(np.stack([v.depth for v in views]).astype(np.float32))
    volume = torch.full(grid.volume_shape, initial)
    exp = integrate_views_torch(volume.clone(), *tables, depths, params)
    got = kernel_order_fuse(volume.clone(), *stage_tables(*tables), depths, params, KZ)
    assert torch.equal(got.view(torch.int32), exp.view(torch.int32))
    assert not (got.view(torch.int32) == NEG_ZERO).any()


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("seed", [1, 11, 12, 13])
def test_chip_smoke_scenes_are_random_scenes(seed):
    """``chip_smoke.py`` makes its fuzz scenes with the port's
    ``scripts/fuzz_extended.random_scene``, which must draw as the JAX
    package's ``random_scene`` does."""
    smoke = chip_smoke()
    assert seed in smoke.FUZZ_SEEDS
    grid, views, params = fuzz_extended.random_scene(seed)
    exp_grid, exp_views, exp_params = random_scene(seed)
    assert grid.dims == tuple(exp_grid.dims)
    np.testing.assert_array_equal(grid.origin, exp_grid.origin)
    np.testing.assert_array_equal(grid.spacing, exp_grid.spacing)
    assert params.astuple() == exp_params.astuple()
    assert len(views) == len(exp_views)
    for got, exp in zip(views, exp_views):
        np.testing.assert_array_equal(got.depth, exp.depth)
        np.testing.assert_array_equal(got.camera.k, exp.camera.k)
        np.testing.assert_array_equal(got.camera.rt, exp.camera.rt)
