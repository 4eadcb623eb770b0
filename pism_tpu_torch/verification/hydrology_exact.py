"""Exact radial steady state of the routing hydrology model (test-P role;
a numpy copy of ``pism_tpu/verification/hydrology_exact.py``).

PISM verifies its hydrology against the radially symmetric "almost exact"
solution of Bueler & van Pelt (2015) (``pismv`` test P, reference
``src/verification/tests/exactTestP.cc`` — code not copied).  The same
role is covered here for the :class:`~pism_tpu_torch.physics.hydrology.Routing`
model, whose hydraulic potential ``psi = rho_w g b + rho_i g H`` does not
depend on the water layer W, so the radial steady state is CLOSED FORM:

    steady mass balance:   (1/r) d(r q)/dr = m_w   =>   q(r) = Q(r)/r,
        Q(r) = integral_0^r m_w(s) s ds,
    flux law:              q = k W^alpha |psi'|^(beta-1)
    =>                     W(r) = [ q(r) / (k |psi'(r)|^(beta-1)) ]^(1/alpha)

with ``m_w`` the water input (ice-equivalent basal melt times
``rho_i/rho_w``).  Geometry: a parabolic ice cap of radius ``R_i`` on a
uniformly sloping bed (so the potential gradient never vanishes and water
exits outward into an ocean ring that acts as the W = 0 sink).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..util.units import SEC_PER_YEAR


@dataclass(frozen=True)
class RoutingSteady:
    H0: float = 1000.0            # dome thickness [m]
    R_i: float = 20.0e3           # ice margin radius [m]
    b1: float = 100.0             # bed drop over R_i [m]
    melt: float = 0.05 / SEC_PER_YEAR   # basal melt [m/s ice equivalent]
    k: float = 1.0e-2             # hydraulic conductivity
    alpha: float = 1.25
    beta: float = 1.5
    rho_i: float = 910.0
    rho_w: float = 1000.0
    g: float = 9.81

    def thickness(self, r):
        r = np.abs(np.asarray(r, dtype=np.float64))
        return np.where(r < self.R_i,
                        self.H0 * (1.0 - (r / self.R_i) ** 2), 0.0)

    def bed(self, r, depth_ocean=200.0):
        """Uniform slope under the ice; drops below sea level outside so the
        outer ring is ocean (the routing sink)."""
        r = np.abs(np.asarray(r, dtype=np.float64))
        b = -self.b1 * r / self.R_i
        return np.where(r < 1.45 * self.R_i, b, b - depth_ocean)

    def water_input(self, r):
        """m_w: water-equivalent input where there is ice."""
        r = np.abs(np.asarray(r, dtype=np.float64))
        return np.where(r < self.R_i,
                        (self.rho_i / self.rho_w) * self.melt, 0.0)

    def psi_gradient(self, r):
        """d(psi)/dr = rho_w g b' + rho_i g H' (negative: outward flow)."""
        r = np.abs(np.asarray(r, dtype=np.float64))
        bp = -self.b1 / self.R_i
        Hp = np.where(r < self.R_i, -2.0 * self.H0 * r / self.R_i ** 2, 0.0)
        return self.rho_w * self.g * bp + self.rho_i * self.g * Hp

    def flux(self, r):
        """Steady radial water flux q(r) = Q(r)/r [m^2/s]."""
        r = np.maximum(np.abs(np.asarray(r, dtype=np.float64)), 1.0)
        m = (self.rho_i / self.rho_w) * self.melt
        Q = m * np.minimum(r, self.R_i) ** 2 / 2.0
        return Q / r

    def water_thickness(self, r):
        """Exact steady W(r) from the closed-form flux relation."""
        q = self.flux(r)
        gp = np.abs(self.psi_gradient(r))
        return (q / (self.k * gp ** (self.beta - 1.0))) ** (1.0 / self.alpha)
