"""Ocean boundary models (port of ``pism_tpu/coupler/ocean.py``:
``OceanInputs``, the ``OceanModel`` base, ``Constant``, ``PIK`` and the
``DeltaT`` modifier; PICO is ``pico.py``): the sub-shelf melt rate [m/s
ice equivalent, + = melt] and the shelf-base temperature [K]."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch


class OceanInputs(NamedTuple):
    shelf_base_melt: torch.Tensor         # m/s ice equivalent (+ = melt)
    shelf_base_temperature: torch.Tensor  # K at the ice-shelf base


class OceanModel:
    def __call__(self, geometry, t):
        """The melt rate only (what ``IceModel`` consumes); ``inputs``
        gives both fields."""
        return self.inputs(geometry, t).shelf_base_melt

    def inputs(self, geometry, t) -> OceanInputs:
        raise NotImplementedError

    def water_column_pressure(self, geometry, t):
        """None: the hydrostatic default (the melange back-pressure
        modifiers that raise it are not ported)."""
        return None

    @staticmethod
    def _draft(geometry):
        """Ice draft (depth of the shelf base below sea level), >= 0."""
        return torch.clamp(geometry.sea_level - (geometry.ice_surface_elevation
                                                 - geometry.ice_thickness),
                           min=0.0)


@dataclass
class Constant(OceanModel):
    """PISM ``-ocean constant``: melt from a constant heat flux into the
    shelf base (or a prescribed rate)."""

    config: object = None
    melt_rate: Optional[float] = None   # m/s ice equivalent; overrides flux

    def __post_init__(self):
        cfg = self.config
        self.rho_i = cfg.get_number("constants.ice.density")
        self.L = cfg.get_number("constants.fresh_water.latent_heat_of_fusion")
        self.heat_flux = cfg.get_number("ocean.sub_shelf_heat_flux_into_ice")
        if self.melt_rate is None:
            self.melt_rate = cfg.get_number("ocean.constant.melt_rate", "m s-1")

    def _melt(self, H):
        return torch.full_like(H, self.melt_rate
                               + self.heat_flux / (self.rho_i * self.L))

    def inputs(self, geometry, t) -> OceanInputs:
        H = geometry.ice_thickness
        # pressure-melting temperature at the shelf base
        T = 273.15 - 7.9e-8 * (self.rho_i * 9.81 * torch.clamp(H, min=0.0))
        return OceanInputs(self._melt(H), T)


@dataclass
class PIK(OceanModel):
    """PISM ``-ocean pik`` (Martin et al. 2011): melt proportional to the
    pressure-melting-point depression at the shelf draft."""

    config: object = None

    def __post_init__(self):
        cfg = self.config
        self.rho_i = cfg.get_number("constants.ice.density")
        self.rho_w = cfg.get_number("constants.sea_water.density")
        self.c_w = cfg.get_number("constants.sea_water.specific_heat_capacity")
        self.L = cfg.get_number("constants.fresh_water.latent_heat_of_fusion")
        self.melt_factor = cfg.get_number("ocean.pik_melt_factor")
        self.S_ocean = cfg.get_number("constants.sea_water.salinity")
        self.T_ocean = 271.15  # PISM: -2 degC ambient

    def inputs(self, geometry, t) -> OceanInputs:
        draft = self._draft(geometry)
        # potential temperature above the in-situ freezing point at the
        # draft (Beckmann-Goosse freezing point)
        T_f = 273.15 - 0.0575 * self.S_ocean + 0.0832e-2 \
            - 7.64e-4 * draft
        dT = torch.clamp(self.T_ocean - T_f, min=0.0)
        gamma_T = 1e-4
        melt = (self.melt_factor * self.rho_w * self.c_w * gamma_T
                / (self.rho_i * self.L)) * dT
        return OceanInputs(melt, T_f)


@dataclass
class DeltaT(OceanModel):
    """PISM ``-ocean ...,delta_T``: a scalar offset ``offset(t)`` [K] (a
    host callable of model time) on the inner model's shelf-base
    temperature; the melt passes through (the JAX modifier's melt
    sensitivity, which its factory leaves at 0, is not carried)."""

    inner: OceanModel
    offset: Callable                  # t -> K

    def inputs(self, geometry, t) -> OceanInputs:
        o = self.inner.inputs(geometry, t)
        return OceanInputs(o.shelf_base_melt,
                           o.shelf_base_temperature + self.offset(t))
