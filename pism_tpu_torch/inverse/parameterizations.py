"""Design-variable parameterizations (port of
``pism_tpu/inverse/parameterizations.py``, PISM's
``IPDesignVariableParameterization`` family): the optimizer works on a
dimensionless design variable ``zeta`` and the physical variable (tau_c or
hardness B) is ``value = F(zeta)``:

- ``ident``:  value = scale * zeta                      (unconstrained)
- ``square``: value = scale * zeta^2                    (nonnegative)
- ``exp``:    value = scale * exp(zeta)                 (positive,
  log-preconditioned)
- ``trunc``:  value = scale * (zeta + sqrt(zeta^2 + 4 eps^2)) / 2
  (a smooth positive truncation of ident)

The maps are torch operations, so autograd differentiates through
:meth:`Parameterization.value`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Parameterization:
    kind: str = "exp"       # ident | square | exp | trunc
    scale: float = 1.0      # typical magnitude of the physical variable
    eps: float = 1.0e-2     # trunc smoothing width (dimensionless)

    def value(self, zeta):
        """Physical variable from the design variable (F)."""
        if self.kind == "ident":
            return self.scale * zeta
        if self.kind == "square":
            return self.scale * zeta ** 2
        if self.kind == "exp":
            return self.scale * torch.exp(zeta)
        if self.kind == "trunc":
            return self.scale * 0.5 * (zeta +
                                       torch.sqrt(zeta ** 2 + 4 * self.eps ** 2))
        raise ValueError(f"unknown parameterization {self.kind!r} "
                         "(ident | square | exp | trunc)")

    def design(self, value):
        """Design variable from the physical variable (F^-1), to seed the
        optimization from an initial tau_c or B; ``value`` a tensor (a
        Python number becomes a float64 one)."""
        v = (value if torch.is_tensor(value)
             else torch.as_tensor(value, dtype=torch.float64)) / self.scale
        if self.kind == "ident":
            return v
        if self.kind == "square":
            return torch.sqrt(torch.clamp(v, min=0.0))
        if self.kind == "exp":
            return torch.log(torch.clamp(v, min=1e-30))
        if self.kind == "trunc":
            # invert v = (z + sqrt(z^2 + 4 eps^2))/2  =>  z = v - eps^2 / v
            v = torch.clamp(v, min=1e-12)
            return v - self.eps ** 2 / v
        raise ValueError(f"unknown parameterization {self.kind!r}")


def from_config(config, design_variable: str = "tauc") -> Parameterization:
    """From ``inverse.design.param``; the scale is the geometric mean of
    ``inverse.ssa.tauc_min/max`` (or ``hardav_min/max``)."""
    kind = config.get_string("inverse.design.param")
    name = "tauc" if design_variable == "tauc" else "hardav"
    scale = math.sqrt(config.get_number(f"inverse.ssa.{name}_min") *
                      config.get_number(f"inverse.ssa.{name}_max"))
    return Parameterization(kind=kind, scale=scale)
