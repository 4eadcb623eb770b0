"""Atmosphere boundary models (port of ``pism_tpu/coupler/atmosphere.py``:
``Uniform``, ``Given``, ``SeariseGreenland``, ``PIK`` and the scalar
modifiers ``DeltaT`` and ``DeltaP``): near-surface air temperature [K] and
precipitation [m/s ice equivalent] from geometry and model time.

Model time is a host float; ``Given``'s time stack is a
``util.forcing.TimeStack``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..util.forcing import TimeStack


class AtmosphereInputs(NamedTuple):
    temperature: torch.Tensor       # mean-annual near-surface air temp [K]
    temperature_july: torch.Tensor  # mean summer temp [K]
    precipitation: torch.Tensor     # [m/s ice equivalent]


class AtmosphereModel:
    def __call__(self, geometry, t) -> AtmosphereInputs:
        raise NotImplementedError


@dataclass
class Uniform(AtmosphereModel):
    temperature: float = 263.15
    temperature_july: Optional[float] = None
    precipitation: float = 0.0  # m/s ice equivalent

    def __call__(self, geometry, t) -> AtmosphereInputs:
        H = geometry.ice_thickness
        Tj = self.temperature_july if self.temperature_july is not None \
            else self.temperature
        return AtmosphereInputs(torch.full_like(H, self.temperature),
                                torch.full_like(H, Tj),
                                torch.full_like(H, self.precipitation))


@dataclass
class Given(AtmosphereModel, TimeStack):
    """Prescribed fields (PISM ``-atmosphere given``): single slices or
    ``(Nt, My, Mx)`` stacks with a ``times`` axis [s]. Air temperature is
    piecewise-linear in time, precipitation (a "time: mean" flux)
    piecewise-constant; ``period`` > 0 cycles the series. With a time axis
    ``temperature_july`` stays the instantaneous temperature, so the PDD's
    cosine cycle drops out."""

    temperature: torch.Tensor
    precipitation: torch.Tensor
    temperature_july: Optional[torch.Tensor] = None
    times: Optional[np.ndarray] = None    # (Nt,) [s], sorted
    period: float = 0.0                   # [s]; > 0 cycles the series

    def __call__(self, geometry, t) -> AtmosphereInputs:
        dt_ = geometry.ice_thickness.dtype
        Ta = self._linear(self.temperature, t, dt_)
        Tj = Ta if self.temperature_july is None \
            else self.temperature_july.to(dt_)
        return AtmosphereInputs(Ta, Tj,
                                self._constant(self.precipitation, t, dt_))


@dataclass
class SeariseGreenland(AtmosphereModel):
    """Fausto et al. (2009) Greenland temperature parameterization (PISM
    ``atmosphere::SeariseGreenland``):
      T_ma  = d_ma + gamma_ma h + c_ma lat + kappa_ma lon
      T_jul = d_mj + gamma_mj h + c_mj lat + kappa_mj lon
    with h = max(surface elevation, 0); precipitation is supplied."""

    latitude: torch.Tensor      # degrees N
    longitude: torch.Tensor     # degrees E
    precipitation: torch.Tensor  # m/s ice equivalent
    config: object = None       # coefficients from atmosphere.fausto_air_temp.*

    def __post_init__(self):
        if self.config is not None:
            self._coef = {k: self.config.get_number(
                "atmosphere.fausto_air_temp." + k)
                for k in ("d_ma", "gamma_ma", "c_ma", "kappa_ma",
                          "d_mj", "gamma_mj", "c_mj", "kappa_mj")}
        else:
            self._coef = dict(d_ma=314.98, gamma_ma=-6.309e-3, c_ma=-0.7189,
                              kappa_ma=-0.0672, d_mj=287.85, gamma_mj=-5.426e-3,
                              c_mj=-0.1585, kappa_mj=0.0518)

    def __call__(self, geometry, t) -> AtmosphereInputs:
        dt_ = geometry.ice_thickness.dtype
        h = torch.clamp(geometry.ice_surface_elevation, min=0.0)
        lat = self.latitude.to(dt_)
        lon = self.longitude.to(dt_)
        c = self._coef
        T_ma = c["d_ma"] + c["gamma_ma"] * h + c["c_ma"] * lat \
            + c["kappa_ma"] * lon
        T_jul = c["d_mj"] + c["gamma_mj"] * h + c["c_mj"] * lat \
            + c["kappa_mj"] * lon
        return AtmosphereInputs(T_ma, T_jul, self.precipitation.to(dt_))


@dataclass
class PIK(AtmosphereModel):
    """PISM ``-atmosphere pik``: Antarctic air temperature from surface
    elevation h and latitude.

    ``parameterization``:
    - ``martin`` (default): mean-annual temperature of Martin et al. (2011)
      eq. 1, T_ma = 273.15 + 34.46 - 0.00914 h - 0.68775 |lat|; the summer
      temperature is the annual one;
    - ``martin_huybrechts_dewolde``: Martin's mean-annual temperature and
      the Huybrechts & de Wolde (1999) summer temperature
      T_s = 273.15 + 16.81 - 0.00692 h - 0.27937 |lat|.

    Precipitation is supplied (PISM reads it from the input file)."""

    latitude: torch.Tensor       # degrees (negative south)
    precipitation: torch.Tensor  # m/s ice equivalent
    parameterization: str = "martin"

    def __call__(self, geometry, t) -> AtmosphereInputs:
        dt_ = geometry.ice_thickness.dtype
        h = torch.clamp(geometry.ice_surface_elevation, min=0.0)
        lat = torch.abs(self.latitude.to(dt_))
        T_ma = 273.15 + 34.46 - 0.00914 * h - 0.68775 * lat
        if self.parameterization == "martin_huybrechts_dewolde":
            T_s = 273.15 + 16.81 - 0.00692 * h - 0.27937 * lat
        else:
            T_s = T_ma
        return AtmosphereInputs(T_ma, T_s, self.precipitation.to(dt_))


@dataclass
class DeltaT(AtmosphereModel):
    """Scalar temperature offset (PISM ``-atmosphere ...,delta_T``):
    ``offset(t)`` is a host callable of model time, K
    (``util.forcing.ScalarForcing``)."""

    inner: AtmosphereModel
    offset: Callable

    def __call__(self, geometry, t) -> AtmosphereInputs:
        a = self.inner(geometry, t)
        dT = self.offset(t)
        return AtmosphereInputs(a.temperature + dT, a.temperature_july + dT,
                                a.precipitation)


@dataclass
class DeltaP(AtmosphereModel):
    """Scalar precipitation offset (PISM ``-atmosphere ...,delta_P``),
    m s-1 ice equivalent."""

    inner: AtmosphereModel
    offset: Callable

    def __call__(self, geometry, t) -> AtmosphereInputs:
        a = self.inner(geometry, t)
        return AtmosphereInputs(a.temperature, a.temperature_july,
                                a.precipitation + self.offset(t))
