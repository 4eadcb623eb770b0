"""Computational grid.

The reference (PISM ``src/util/Grid.cc``) wraps a PETSc 2D DMDA: each MPI
rank owns an (x, y) patch with ghost width 1-2; vertical levels are unequally
spaced and never decomposed. Here the grid is a *static, hashable* host-side
description; fields are whole torch tensors of shape ``(My, Mx)`` or
``(My, Mx, Mz)`` on one device. A copy of ``pism_tpu/grid.py`` (numpy
only), so that both packages build identical grids.

Array index convention: axis 0 = y (rows), axis 1 = x (columns), axis 2 = z
(base -> surface), matching PISM's ``(i, j)`` loops transposed to C order.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np


def vertical_levels(Mz: int, Lz: float, spacing: str = "quadratic",
                    lam: float = 4.0) -> np.ndarray:
    """Ice vertical levels z[0]=0 (base) .. z[Mz-1]=Lz (top of domain).

    Quadratic spacing concentrates resolution near the base (where shear and
    enthalpy gradients live): z(zeta) = Lz * (zeta/lam) * (1 + (lam-1)*zeta),
    matching PISM's ``grid.ice_vertical_spacing = quadratic`` with
    ``grid.lambda = lam``.
    """
    zeta = np.linspace(0.0, 1.0, Mz)
    if spacing == "equal":
        z = Lz * zeta
    elif spacing == "quadratic":
        z = Lz * (zeta / lam) * (1.0 + (lam - 1.0) * zeta)
    else:
        raise ValueError(f"unknown vertical spacing {spacing!r}")
    z[0], z[-1] = 0.0, Lz
    return z


@dataclass(frozen=True)
class Grid:
    """Static grid description (hashable)."""

    Mx: int
    My: int
    Lx: float  # half-width [m]; x spans [x0-Lx, x0+Lx]
    Ly: float
    Mz: int = 1
    Lz: float = 0.0
    x0: float = 0.0
    y0: float = 0.0
    vertical_spacing: str = "quadratic"
    lam: float = 4.0
    periodicity: str = "none"  # none | x | y | xy
    # bedrock thermal layer (z in [-Lbz, 0])
    Mbz: int = 1
    Lbz: float = 0.0
    #: reference grid.registration: "corner" puts grid points at the cell
    #: corners including +-L (dx = 2L/(M-1), the historical default here);
    #: "center" tiles [-L, L] with M cells and puts points at their centers
    #: (dx = 2L/M), PISM's bootstrap default
    registration: str = "corner"

    @property
    def dx(self) -> float:
        if self.registration == "center":
            return 2.0 * self.Lx / self.Mx
        return 2.0 * self.Lx / (self.Mx - 1)

    @property
    def dy(self) -> float:
        if self.registration == "center":
            return 2.0 * self.Ly / self.My
        return 2.0 * self.Ly / (self.My - 1)

    @functools.cached_property
    def x(self) -> np.ndarray:
        if self.registration == "center":
            return self.x0 - self.Lx + (np.arange(self.Mx) + 0.5) * self.dx
        return self.x0 + np.linspace(-self.Lx, self.Lx, self.Mx)

    @functools.cached_property
    def y(self) -> np.ndarray:
        if self.registration == "center":
            return self.y0 - self.Ly + (np.arange(self.My) + 0.5) * self.dy
        return self.y0 + np.linspace(-self.Ly, self.Ly, self.My)

    @functools.cached_property
    def z(self) -> np.ndarray:
        if self.Mz <= 1:
            return np.zeros(max(self.Mz, 1))
        return vertical_levels(self.Mz, self.Lz, self.vertical_spacing, self.lam)

    @functools.cached_property
    def zb(self) -> np.ndarray:
        """Bedrock levels, -Lbz .. 0."""
        if self.Mbz <= 1:
            return np.zeros(1)
        return np.linspace(-self.Lbz, 0.0, self.Mbz)

    @functools.cached_property
    def dz(self) -> np.ndarray:
        """Layer spacings dz[k] = z[k+1]-z[k] (length Mz-1)."""
        return np.diff(self.z)

    @property
    def periodic_x(self) -> bool:
        return self.periodicity in ("x", "xy")

    @property
    def periodic_y(self) -> bool:
        return self.periodicity in ("y", "xy")

    @property
    def shape2(self):
        return (self.My, self.Mx)

    @property
    def shape3(self):
        return (self.My, self.Mx, self.Mz)

    def cell_area(self) -> float:
        return self.dx * self.dy

    @functools.cached_property
    def radius(self) -> np.ndarray:
        """Distance from (x0, y0), shape (My, Mx). Used by EISMINT setups."""
        X, Y = np.meshgrid(self.x - self.x0, self.y - self.y0)
        return np.sqrt(X ** 2 + Y ** 2)

    @staticmethod
    def from_config(config) -> "Grid":
        return Grid(
            Mx=config.get_int("grid.Mx"),
            My=config.get_int("grid.My"),
            Lx=config.get_number("grid.Lx"),
            Ly=config.get_number("grid.Ly"),
            Mz=config.get_int("grid.Mz"),
            Lz=config.get_number("grid.Lz"),
            vertical_spacing=config.get_string("grid.ice_vertical_spacing"),
            lam=config.get_number("grid.lambda"),
            periodicity=config.get_string("grid.periodicity"),
            Mbz=config.get_int("grid.Mbz"),
            Lbz=config.get_number("grid.Lbz"),
        )
