"""Bedrock thermal unit (port of ``pism_tpu/model/btu.py``; PISM
``BTU_Full``, ``BTU_Minimal``): heat conduction in a bedrock layer of
thickness ``grid.Lbz`` on ``grid.Mbz`` levels below the ice, solved
implicitly per column by the batched Thomas solver of ``util/tridiag.py``.
Top boundary: Dirichlet at the ice's basal temperature; bottom: Neumann
geothermal flux. The unit's output is the conductive flux at the bedrock
top, which replaces the geothermal flux as the lower boundary condition of
the ice's enthalpy solve. Without a bedrock layer (``grid.Mbz = 1`` or
``grid.Lbz = 0``) the minimal unit passes the geothermal flux through.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..util.tridiag import solve_batched


@dataclass
class BTUMinimal:
    """No bedrock layer: passes the geothermal flux straight through."""

    grid: object
    config: object

    def init_temperature(self, T_base, geothermal):
        return None

    def step(self, bedrock_T, T_base_ice, geothermal, dt):
        """(bedrock temperature, heat flux into the ice base): the flux is
        the geothermal flux itself."""
        return bedrock_T, geothermal


@dataclass
class BTUFull:
    grid: object
    config: object

    def __post_init__(self):
        cfg = self.config
        self.k = cfg.get_number("energy.bedrock_thermal.conductivity")
        rho = cfg.get_number("energy.bedrock_thermal.density")
        c = cfg.get_number("energy.bedrock_thermal.specific_heat_capacity")
        self.kappa = self.k / (rho * c)
        zb = np.asarray(self.grid.zb)          # -Lbz .. 0
        self.dz = float(zb[1] - zb[0])
        self.Mbz = self.grid.Mbz

    def init_temperature(self, T_base, geothermal):
        """Steady conductive profile: T(z) = T_top + (G/k)(0 - z);
        ``geothermal`` a tensor of T_base's shape or a float."""
        zb = torch.as_tensor(np.asarray(self.grid.zb), dtype=T_base.dtype,
                             device=T_base.device)
        G = torch.as_tensor(geothermal, dtype=T_base.dtype,
                            device=T_base.device)
        return T_base[..., None] + (G / self.k)[..., None] * (0.0 - zb)

    def step(self, bedrock_T, T_base_ice, geothermal, dt):
        """Advance the bedrock temperature by ``dt``; returns (T_new, the
        upward conductive flux at the top, -k dT/dz there).

        bedrock_T: (My, Mx, Mbz), level 0 at z = -Lbz, level Mbz-1 at z = 0.
        """
        dz = self.dz
        r = dt * self.kappa / dz ** 2
        a = torch.full_like(bedrock_T, -r)
        c = torch.full_like(bedrock_T, -r)
        b = 1.0 + 2.0 * r + torch.zeros_like(bedrock_T)
        d = bedrock_T.clone()
        # bottom (k = 0): Neumann geothermal upward flux q = -k dT/dz = G,
        # so T_0 - T_1 = G dz / k (warmer below)
        b[..., 0] = 1.0
        c[..., 0] = -1.0
        d[..., 0] = geothermal * dz / self.k
        # top (k = Mbz - 1): Dirichlet at the ice's basal temperature
        a[..., -1] = 0.0
        b[..., -1] = 1.0
        d[..., -1] = T_base_ice
        T_new = solve_batched(a, b, c, d)
        flux_top = -self.k * (T_new[..., -1] - T_new[..., -2]) / dz
        return T_new, flux_top


def btu_from_config(grid, config):
    if grid.Mbz > 1 and grid.Lbz > 0:
        return BTUFull(grid=grid, config=config)
    return BTUMinimal(grid=grid, config=config)
