"""Ocean boundary models (port of ``pism_tpu/coupler/ocean.py``,
``Constant`` only): the sub-shelf melt rate [m/s ice equivalent]."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class Constant:
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

    def __call__(self, geometry, t):
        """Sub-shelf melt rate field."""
        H = geometry.ice_thickness
        return torch.full_like(H, self.melt_rate
                               + self.heat_flux / (self.rho_i * self.L))
