"""Rows 3–6 of the TPU kernel table against the port, on the CPU.

The JAX package's ``pallas_integrate`` has four more kernel bodies beside
the two the port's integrate kernel was first held to: ``windows`` (the
windowed gather), ``rowselw`` (windowed band sweep), ``rowseld`` (dynamic
two-band staging) and ``rowsel3m`` (the row-select kernel with a miss
counter, re-dispatching the exact mode on a miss). All compute the same
function, and the port has one kernel for all of them. Here each runs in
interpreter mode, with the depth-map VMEM budget shrunk as
tests/test_pallas_kernel.py does so that the band modes really stage
several 8-row bands, and each must equal the port's plain version
``integrate_views_torch`` **bit for bit** on the identity rig of
tests/test_torch_integrate.py (views that keep the grid's own axes, so
both sides sum ``ty + (tx + (tz + tc))`` and add views in the given order).
"""

import numpy as np
import pytest
import torch

import cudadepthmapintegration_tpu.kernels.integrate_pallas as KP
from cudadepthmapintegration_torch import interop
from cudadepthmapintegration_torch.kernels.integrate_cuda import integrate_views_torch
from cudadepthmapintegration_tpu.core import RayPotential, VoxelGrid
from cudadepthmapintegration_tpu.ops.integrate import projection_tables
from cudadepthmapintegration_tpu.testing import look_at_camera, render_sphere_view

KP.INTERPRET = True

PARAMS = RayPotential(thick=0.1, rho=0.8, eta=0.03, delta=0.3)

# mode -> depth-map VMEM budget in bytes (None: the default), the budgets
# of tests/test_pallas_kernel.py that make the band modes stage 8-row bands.
MODES = {
    "windows": None,
    "rowselw": 2 * 8 * 256 * 4,
    "rowsel3w": 2 * 8 * 256 * 4,
    "rowseld": 4 * 8 * 256 * 4,
    "rowsel3d": 4 * 8 * 256 * 4,
    "rowselm": None,
    "rowsel3m": None,
}


def identity_rig(n, width=96, height=48, seed=11):
    """n views with eyes on the -y side (small jitter): every one keeps the
    grid's own axis order (tests/test_torch_integrate.py)."""
    rng = np.random.default_rng(seed)
    views = []
    for _ in range(n):
        eye = (float(rng.uniform(-0.5, 0.5)), -4.0 + float(rng.uniform(-0.3, 0.3)),
               float(rng.uniform(-0.5, 0.5)))
        cam = look_at_camera(eye, (0.0, 0.0, 0.0), focal=55.0, width=width, height=height)
        views.append(render_sphere_view(cam, width, height))
    assert {KP.best_axis_permutation(v.camera.rt[:3, :3]) for v in views} == {(2, 1, 0)}
    return views


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pallas_mode_bitwise_vs_port(mode):
    grid = VoxelGrid(dims=(17, 17, 17), origin=(-1.6,) * 3, spacing=(0.2,) * 3)
    views = identity_rig(4)
    t = projection_tables(grid, views, np.float32)
    depths = np.stack([v.depth for v in views]).astype(np.float32)
    cz, cy, cx = grid.volume_shape
    # The functional entry takes a lane-padded volume; padded x cells get a
    # poisoned table (never valid) and are cut off below.
    tx = KP._pad_table_invalid(t.tx, 128)
    old = KP.DEPTH_VMEM_BUDGET
    if MODES[mode] is not None:
        KP.DEPTH_VMEM_BUDGET = MODES[mode]
    try:
        exp = np.asarray(KP.pallas_integrate(
            np.zeros((cz, cy, 128), np.float32), tx, t.ty, t.tz, t.tc, depths,
            PARAMS.thick, PARAMS.rho, PARAMS.eta, PARAMS.delta, mode=mode,
        ))[:, :, :cx]
    finally:
        KP.DEPTH_VMEM_BUDGET = old
    got = integrate_views_torch(
        torch.zeros(grid.volume_shape),
        *(torch.from_numpy(a) for a in (t.tx, t.ty, t.tz, t.tc, depths)),
        interop.params_from(PARAMS),
    ).numpy()
    assert np.abs(exp).max() > 0.5  # the scene reaches the grid
    np.testing.assert_array_equal(got, exp)
