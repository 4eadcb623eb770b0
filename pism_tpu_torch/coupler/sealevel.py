"""Sea-level models (port of ``pism_tpu/coupler/sealevel.py``: ``Constant``,
the scalar ``DeltaSL`` modifier and the 2D ``DeltaSL2D``; PISM
``src/coupler/ocean/sea_level/``): the sea-level field of the flotation
criterion, evaluated before the stress balance of each step. The scalar
offset is a host callable of model time (``util.forcing.ScalarForcing``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch


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


@dataclass
class DeltaSL2D(SeaLevelModel):
    """PISM ``delta_sl_2d``: a 2D offset field, or a ``(T, My, Mx)`` stack
    with ``times`` [s] interpolated linearly in time and held at the ends.
    The frame is formed in float64, as the JAX package's float64 weight
    promotes it, and the sum is cast by the caller."""

    inner: SeaLevelModel
    offset_field: torch.Tensor
    times: Optional[np.ndarray] = None
    period: float = 0.0   # [s]; > 0 cycles (sea_level.delta_sl_2d.periodic)

    def __call__(self, geometry, t):
        f = self.offset_field
        if f.ndim == 3 and self.times is None:
            raise ValueError(
                "DeltaSL2D: offset_field has a time axis (T, My, Mx) but "
                "no `times` coordinates were given")
        if self.times is None or f.ndim == 2:
            return self.inner(geometry, t) + f
        ts = np.asarray(self.times, np.float64)
        if self.period > 0.0:
            t = ts[0] + np.mod(t - ts[0], self.period)
        tq = min(max(t, ts[0]), ts[-1])
        k = int(np.clip(np.searchsorted(ts, tq, side="right") - 1,
                        0, ts.shape[0] - 2))
        w = (tq - ts[k]) / max(ts[k + 1] - ts[k], 1e-30)
        frame = (1.0 - w) * f[k].double() + w * f[k + 1].double()
        return self.inner(geometry, t) + frame
