"""Sea-level models (port of ``pism_tpu/coupler/sealevel.py``: ``Constant``
and the scalar ``DeltaSL`` modifier; PISM ``src/coupler/ocean/sea_level/``):
the sea-level field of the flotation criterion, evaluated before the stress
balance of each step. The scalar offset is a host callable of model time
(``util.forcing.ScalarForcing``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable


class SeaLevelModel:
    def __call__(self, geometry, t):
        raise NotImplementedError


@dataclass
class Constant(SeaLevelModel):
    value: float = 0.0

    def __call__(self, geometry, t):
        H = geometry.ice_thickness
        return H.new_full(H.shape, self.value)


@dataclass
class DeltaSL(SeaLevelModel):
    """Scalar offset on an inner model (PISM ``-sea_level ...,delta_sl``)."""

    inner: SeaLevelModel
    offset: Callable    # t -> meters

    def __call__(self, geometry, t):
        return self.inner(geometry, t) + self.offset(t)
