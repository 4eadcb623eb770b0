"""Atmosphere boundary models (port of ``pism_tpu/coupler/atmosphere.py``,
``SeariseGreenland`` only): near-surface air temperature [K] and
precipitation [m/s ice equivalent] from geometry and model time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch


class AtmosphereInputs(NamedTuple):
    temperature: torch.Tensor       # mean-annual near-surface air temp [K]
    temperature_july: torch.Tensor  # mean summer temp [K]
    precipitation: torch.Tensor     # [m/s ice equivalent]


class AtmosphereModel:
    def __call__(self, geometry, t) -> AtmosphereInputs:
        raise NotImplementedError


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
