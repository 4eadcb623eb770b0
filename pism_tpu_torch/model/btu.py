"""Bedrock thermal unit (port of ``pism_tpu/model/btu.py``, ``BTUMinimal``
only: with no bedrock layer, ``grid.Mbz = 1``, the geothermal flux passes
straight through to the ice's basal boundary)."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class BTUMinimal:
    """No bedrock layer: passes the geothermal flux straight through."""

    grid: object
    config: object

    def step(self, bedrock_T, T_base_ice, geothermal, dt):
        """(bedrock temperature, heat flux into the ice base): the flux is
        the geothermal flux itself."""
        return bedrock_T, geothermal


def btu_from_config(grid, config):
    if grid.Mbz > 1 and grid.Lbz > 0:
        raise NotImplementedError(
            "a bedrock thermal layer (grid.Mbz > 1) is not implemented in "
            "pism_tpu_torch")
    return BTUMinimal(grid=grid, config=config)
