"""Surface (climate) boundary models (port of
``pism_tpu/coupler/surface.py``: the data types, the base class the PDD
model builds on, the stateless ``FunctionSurface`` of the verification
setups and the spatially uniform ``Uniform``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch


class SurfaceInputs(NamedTuple):
    smb: torch.Tensor          # surface mass balance [m/s ice equivalent]
    temperature: torch.Tensor  # ice surface temperature [K]
    melt: Optional[torch.Tensor] = None          # m/s ice equivalent
    runoff: Optional[torch.Tensor] = None        # m/s (melt - refreeze)
    accumulation: Optional[torch.Tensor] = None  # m/s (snowfall)


class SurfaceCarry(NamedTuple):
    """Model-state fields threaded through stateful surface models: the PDD
    snow/firn bookkeeping depths (and an albedo slot the PDD passes on)."""

    snow: Optional[torch.Tensor] = None    # m ice equivalent
    firn: Optional[torch.Tensor] = None    # m ice equivalent
    albedo: Optional[torch.Tensor] = None  # 1


class SurfaceModel:
    """Base interface (PISM ``surface::SurfaceModel``): ``model(geometry, t)``
    is the stateless climatology; a stateful model also integrates
    ``update(geometry, t, dt, carry)`` over [t, t+dt]."""

    stateful = False

    def __call__(self, geometry, t) -> SurfaceInputs:
        raise NotImplementedError

    def update(self, geometry, t, dt, carry: SurfaceCarry):
        return self(geometry, t), carry

    def max_timestep(self, t) -> float:
        return float("inf")


@dataclass
class FunctionSurface(SurfaceModel):
    """Wraps fn(geometry, t) -> (smb, temperature); used by the verification
    setups (EISMINT II's radially symmetric climate)."""

    fn: Callable

    def __call__(self, geometry, t) -> SurfaceInputs:
        smb, temp = self.fn(geometry, t)
        return SurfaceInputs(smb, temp)


@dataclass
class Uniform(SurfaceModel):
    """Spatially uniform, constant in time."""

    smb: float = 0.0          # m/s ice equivalent
    temperature: float = 263.15

    def __call__(self, geometry, t) -> SurfaceInputs:
        H = geometry.ice_thickness
        return SurfaceInputs(smb=torch.full_like(H, self.smb),
                             temperature=torch.full_like(H, self.temperature))
