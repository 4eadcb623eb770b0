"""Schoof (2003) bed roughness parameterization, the "bed smoother" (port of
``pism_tpu/ops/bedsmoother.py``).

The SIA sees a smoothed bed b_s (moving-window average of the bed), and
its diffusivity is multiplied by theta = <(1 - b~/H)^(-(n+2)/n)>^(-n) in
[0, 1], evaluated through a 4th-order Taylor expansion with the moments
C2, C3, C4 of the residual relief b~ = b - b_s. Window sums at the domain
edge use the shrunken window (the mean over the cells that exist).
Fields may carry leading member dims (an ensemble's ``(B, My, Mx)``): each
member's bed is smoothed on its own, its theta from its own thickness.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class SmoothedBed(NamedTuple):
    bed: torch.Tensor      # smoothed bed b_s [m]
    maxtl: torch.Tensor    # max of (b - b_s) over the window [m]
    C2: torch.Tensor       # <b~^2> [m^2]
    C3: torch.Tensor       # <b~^3> [m^3]
    C4: torch.Tensor       # <b~^4> [m^4]


def _images(a):
    """``a`` (..., My, Mx) as a batch of one-channel images."""
    return a.reshape(-1, 1, *a.shape[-2:])


def _window_mean(a, ny: int, nx: int):
    return F.avg_pool2d(_images(a), (2 * ny + 1, 2 * nx + 1), stride=1,
                        padding=(ny, nx),
                        count_include_pad=False).reshape(a.shape)


def preprocess_bed(bed, dx: float, dy: float, smoothing_range: float
                   ) -> SmoothedBed:
    """Smooth the bed and precompute the residual-topography moments.
    ``smoothing_range``: half-width of the averaging window [m]."""
    nx = max(int(math.ceil(smoothing_range / dx)), 1)
    ny = max(int(math.ceil(smoothing_range / dy)), 1)
    b_s = _window_mean(bed, ny, nx)
    tl = bed - b_s   # residual ("topographic local") relief
    maxtl = F.max_pool2d(_images(tl), (2 * ny + 1, 2 * nx + 1), stride=1,
                         padding=(ny, nx)).reshape(tl.shape)
    return SmoothedBed(bed=b_s, maxtl=torch.clamp(maxtl, min=0.0),
                       C2=_window_mean(tl ** 2, ny, nx),
                       C3=_window_mean(tl ** 3, ny, nx),
                       C4=_window_mean(tl ** 4, ny, nx))


def theta(smooth: SmoothedBed, H, n: float = 3.0):
    """Roughness multiplier for the SIA diffusivity, in [0, 1]; H is the ice
    thickness relative to the smoothed bed."""
    p = (n + 2.0) / n
    lim = 2.0 * smooth.maxtl  # expansion validity limit (needs H > relief)
    Hs = torch.maximum(H, lim + 1.0)
    k2 = p * (p + 1.0) / 2.0
    k3 = p * (p + 1.0) * (p + 2.0) / 6.0
    k4 = p * (p + 1.0) * (p + 2.0) * (p + 3.0) / 24.0
    omega = (1.0 + k2 * smooth.C2 / Hs ** 2 + k3 * smooth.C3 / Hs ** 3
             + k4 * smooth.C4 / Hs ** 4)
    th = torch.clamp(omega ** (-n), 0.0, 1.0)
    # thin ice over tall bumps: taper to zero; no relief (lim == 0) means
    # theta is exactly 1 for any H
    taper = torch.clamp(H / torch.clamp(lim, min=1e-9), 0.0, 1.0)
    return torch.where(H < lim, th * taper, th).to(H.dtype)
