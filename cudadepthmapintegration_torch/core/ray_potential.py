"""Truncated signed-distance ray-potential profile.

Exact semantics of ``rayPotential`` in
``Reconstruction/CudaReconstruction.cu:104-120``, with
``diff = real_distance - depth`` (voxel's camera-space z minus the depth-map
value):

* ``|diff| >  delta``:  ``0`` if diff > 0 (voxel far behind the surface),
  else ``-eta * rho`` (voxel well in front, empty-space vote);
* ``delta >= |diff| > thick``:  ``rho * sign(diff)``;
* ``|diff| <= thick``:  ``(rho / thick) * diff`` (linear ramp through 0).

Validation rules come from the CLI (``Reconstruction/main.cxx:270-276``):
``delta >= thick`` and ``0 <= eta <= 1``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["RayPotential", "ray_potential_np", "ray_potential_torch"]


@dataclasses.dataclass(frozen=True)
class RayPotential:
    """TSDF ray-potential parameters (thick, rho, eta, delta)."""

    thick: float = 2.0
    rho: float = 0.8
    eta: float = 0.03
    delta: float = 0.3

    def validate(self) -> "RayPotential":
        """CLI-equivalent validation (``Reconstruction/main.cxx:270-276``)."""
        if self.delta < self.thick:
            raise ValueError(
                f"rayDelta ({self.delta}) must be >= rayThick ({self.thick})"
            )
        if not (0.0 <= self.eta <= 1.0):
            raise ValueError(f"rayEta ({self.eta}) must be within [0, 1]")
        if self.thick <= 0:
            raise ValueError(f"rayThick ({self.thick}) must be > 0")
        return self

    def astuple(self) -> tuple[float, float, float, float]:
        return (self.thick, self.rho, self.eta, self.delta)

    def scalars(self) -> dict[str, float]:
        """The five constants the potential uses, each formed in double on
        the host: ``rho / thick`` and ``-eta * rho`` are products of Python
        floats, rounded once when they meet the compute dtype (as Python
        scalars do in the JAX kernel)."""
        return dict(
            thick=float(self.thick),
            rho=float(self.rho),
            delta=float(self.delta),
            rho_over_thick=float(self.rho) / float(self.thick),
            neg_eta_rho=-float(self.eta) * float(self.rho),
        )


def ray_potential_np(
    real_distance: np.ndarray, depth: np.ndarray, p: RayPotential
) -> np.ndarray:
    """float64 NumPy oracle of ``rayPotential`` (CudaReconstruction.cu:104-120)."""
    diff = np.asarray(real_distance, dtype=np.float64) - np.asarray(
        depth, dtype=np.float64
    )
    a = np.abs(diff)
    sign = np.sign(diff)
    far = np.where(diff > 0, 0.0, -p.eta * p.rho)
    shell = p.rho * sign
    ramp = (p.rho / p.thick) * diff
    return np.where(a > p.delta, far, np.where(a > p.thick, shell, ramp))


def ray_potential_torch(
    real_distance: torch.Tensor, depth: torch.Tensor, p: RayPotential
) -> torch.Tensor:
    """Torch counterpart of ``ray_potential_jnp``: a branch-free ``where``
    chain in the dtype of ``real_distance``. Every parameter is rounded once
    from its double value into that dtype before it meets a tensor."""
    s = {
        k: torch.tensor(v, dtype=real_distance.dtype, device=real_distance.device)
        for k, v in p.scalars().items()
    }
    diff = real_distance - depth
    a = torch.abs(diff)
    far = torch.where(diff > 0, torch.zeros_like(diff), s["neg_eta_rho"])
    shell = s["rho"] * torch.sign(diff)
    ramp = s["rho_over_thick"] * diff
    return torch.where(
        a > s["delta"], far, torch.where(a > s["thick"], shell, ramp)
    )
