"""Ice age transport (port of ``pism_tpu/model/age.py``; PISM
``AgeModel``/``AgeColumnSystem``):

    dA/dt + u A_x + v A_y + w A_z = 1,

horizontal advection explicit first-order upwind, vertical advection
implicit upwind per column: a bidiagonal system per column, all columns
solved at once by ``util/tridiag.solve_batched``. Levels above the ice
surface hold new ice (age 0); ice-free columns are 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import state as S
from ..ops.sia3d import SIA3D
from ..ops.stencils import Shifter
from ..util.tridiag import solve_batched


@dataclass
class AgeModel:
    grid: object
    config: object

    def __post_init__(self):
        self.sh = Shifter(self.grid)
        self.z_np = np.asarray(self.grid.z)

    def step(self, state: S.ModelState, sia3: SIA3D, dt: float) -> torch.Tensor:
        """The age after a step of ``dt`` seconds (a host float in the
        field dtype) under the 3D velocities ``sia3``."""
        A = state.age
        H = state.geometry.ice_thickness
        grid, sh = self.grid, self.sh
        z = torch.as_tensor(self.z_np, dtype=A.dtype, device=A.device)
        dz = torch.as_tensor(np.diff(self.z_np), dtype=A.dtype,
                             device=A.device)
        Hc = H[..., None]

        u, v, w = sia3.u, sia3.v, sia3.w
        dAdx_up = torch.where(u >= 0.0, (A - sh(A, 0, -1)) / grid.dx,
                              (sh(A, 0, 1) - A) / grid.dx)
        dAdy_up = torch.where(v >= 0.0, (A - sh(A, -1, 0)) / grid.dy,
                              (sh(A, 1, 0) - A) / grid.dy)
        rhs = A + dt * (1.0 - u * dAdx_up - v * dAdy_up)

        dz_l = torch.cat([dz[:1], dz])
        dz_u = torch.cat([dz, dz[-1:]])
        a = -dt * torch.clamp(w, min=0.0) / dz_l
        c = dt * torch.clamp(w, max=0.0) / dz_u
        b = 1.0 - a - c

        # surface and above: new ice has age 0; the base needs no extra row
        # (the upwind scheme takes w ~ 0 or melting there)
        is_air = z > Hc
        a = torch.where(is_air, 0.0, a)
        c = torch.where(is_air, 0.0, c)
        b = torch.where(is_air, 1.0, b)
        d = torch.where(is_air, 0.0, rhs)

        A_new = solve_batched(a, b, c, d)
        icy = S.icy(state.geometry.cell_type)
        return torch.where(icy[..., None], torch.clamp(A_new, min=0.0), 0.0)
