"""Subglacial hydrology (port of ``pism_tpu/physics/hydrology.py``,
``NullTransport`` only): the till-water-layer ODE
dW_till/dt = (rho_i/rho_w) m_b - C, clipped to [0, W_max], no transport.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import state as S
from ..config import require


@dataclass
class NullTransport:
    """PISM ``hydrology::NullTransport``."""

    grid: object
    config: object

    def __post_init__(self):
        cfg = self.config
        require(cfg, "hydrology.model", ("null", ""))
        require(cfg, "hydrology.surface_input.file", ("",))
        require(cfg, "hydrology.surface_input_from_runoff", (False,))
        self.W_max = cfg.get_number("hydrology.tillwat_max")
        self.C = cfg.get_number("hydrology.tillwat_decay_rate", "m s-1")
        self.rho_i = cfg.get_number("constants.ice.density")
        self.rho_w = cfg.get_number("constants.fresh_water.density")
        self.decay_grounded_only = cfg.get_flag(
            "hydrology.tillwat_decay_rate_grounded_only")
        self.add_to_till = cfg.get_flag(
            "hydrology.add_water_input_to_till_storage")
        self._dt_max = cfg.get_number("hydrology.maximum_time_step", "seconds")

    def max_timestep(self):
        """hydrology.maximum_time_step (<= 0 disables)."""
        return self._dt_max if self._dt_max > 0.0 else None

    def step(self, state: S.ModelState, dt) -> S.ModelState:
        W = state.tillwat
        if W is None:
            W = torch.zeros_like(state.geometry.ice_thickness)
        if self.add_to_till and state.basal_melt_rate is not None:
            inflow = (self.rho_i / self.rho_w) * state.basal_melt_rate
        else:
            inflow = torch.zeros_like(W)
        mask = state.geometry.cell_type
        decay = self.C
        if self.decay_grounded_only:
            decay = torch.where(S.grounded_ice(mask), torch.full_like(W, self.C),
                                0.0)
        W = torch.clamp(W + dt * (inflow - decay), 0.0, self.W_max)
        # no till water under floating ice or ocean
        W = torch.where(S.ocean(mask), 0.0, W)
        return state.replace(tillwat=W)
