"""Surface (climate) boundary models (port of
``pism_tpu/coupler/surface.py``: the data types, the base class the PDD
model builds on, the stateless ``FunctionSurface`` of the verification
setups, ``Uniform``, ``Simple``, ``Given`` and the ``DeltaT`` modifier)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..util.forcing import TimeStack


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


@dataclass
class Simple(SurfaceModel):
    """PISM ``-surface simple``: SMB = the atmosphere's precipitation, ice
    surface temperature = its mean-annual air temperature."""

    atmosphere: object          # AtmosphereModel

    def __call__(self, geometry, t) -> SurfaceInputs:
        a = self.atmosphere(geometry, t)
        return SurfaceInputs(a.precipitation, a.temperature)


@dataclass
class PIK(SurfaceModel):
    """PISM ``-surface pik``: SMB = the atmosphere's precipitation; the ice
    surface temperature from the Martin et al. (2011, TC) Antarctic
    parameterization T_s [K] = 273.15 + 30 - 0.0075 h - 0.68775 |lat|
    (h the surface elevation [m], lat in degrees), capped at the melting
    point."""

    atmosphere: object
    latitude: torch.Tensor      # degrees (negative in the south)

    def __call__(self, geometry, t) -> SurfaceInputs:
        a = self.atmosphere(geometry, t)
        h = geometry.ice_surface_elevation
        lat = torch.abs(self.latitude.to(h.dtype))
        T = 273.15 + 30.0 - 0.0075 * h - 0.68775 * lat
        return SurfaceInputs(a.precipitation, torch.clamp(T, max=273.15))


@dataclass
class Given(SurfaceModel, TimeStack):
    """Prescribed fields (PISM ``-surface given``): single slices or
    ``(Nt, My, Mx)`` stacks with a ``times`` axis [s]; SMB (a "time: mean"
    flux) piecewise-constant, temperature piecewise-linear; ``period`` > 0
    cycles the series."""

    smb_field: torch.Tensor
    temperature_field: torch.Tensor
    times: Optional[np.ndarray] = None    # (Nt,) [s], sorted
    period: float = 0.0                   # [s]; > 0 cycles the series

    def __call__(self, geometry, t) -> SurfaceInputs:
        return SurfaceInputs(
            self._constant(self.smb_field, t, self.smb_field.dtype),
            self._linear(self.temperature_field, t,
                         self.temperature_field.dtype))


@dataclass
class DeltaT(SurfaceModel):
    """PISM ``-surface ...,delta_T``: a scalar ice-surface-temperature
    offset ``offset(t)`` [K] (a host callable) on an inner model, stateful
    when the inner model is (the PDD's carry passes through)."""

    inner: SurfaceModel
    offset: Callable            # t -> K

    @property
    def stateful(self) -> bool:
        return bool(getattr(self.inner, "stateful", False))

    def _transform(self, s: SurfaceInputs, t) -> SurfaceInputs:
        return s._replace(temperature=s.temperature + self.offset(t))

    def __call__(self, geometry, t) -> SurfaceInputs:
        return self._transform(self.inner(geometry, t), t)

    def update(self, geometry, t, dt, carry: SurfaceCarry):
        s, carry = self.inner.update(geometry, t, dt, carry)
        return self._transform(s, t), carry

    def max_timestep(self, t) -> float:
        return self.inner.max_timestep(t)
