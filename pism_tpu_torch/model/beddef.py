"""Bed deformation (port of ``pism_tpu/model/beddef.py``): pointwise
isostasy (``bed_deformation.model = iso``, PISM ``bed::PointwiseIsostasy``),
the bed model of verification test H. ``lc`` and ``given`` raise
``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass

from .. import state as S
from ..config import require


@dataclass
class PointwiseIsostasy:
    """db = -(rho_i / rho_r) (H - H_ref)."""

    grid: object
    config: object

    def __post_init__(self):
        cfg = self.config
        self.f = cfg.get_number("constants.ice.density") / \
            cfg.get_number("bed_deformation.lithosphere_density")

    def step(self, state: S.ModelState, dt, t=None) -> S.ModelState:
        g = state.geometry
        bed = state.bed_reference - self.f * (g.ice_thickness
                                              - state.bed_load_reference)
        return state.replace(geometry=g.replace(bed_elevation=bed))

    def initialize(self, state: S.ModelState) -> S.ModelState:
        return state.replace(
            bed_reference=state.geometry.bed_elevation,
            bed_load_reference=state.geometry.ice_thickness)


def bed_deformation_from_config(grid, config):
    require(config, "bed_deformation.model", ("none", "", "iso"))
    if config.get_string("bed_deformation.model") == "iso":
        return PointwiseIsostasy(grid=grid, config=config)
    return None
