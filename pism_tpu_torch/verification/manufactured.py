"""Manufactured-solution verification of the thermo-coupled SIA (port of
``pism_tpu/verification/manufactured.py``; the role of PISM's verification
tests F and G, Bueler et al. 2007).

Closed-form fields H(r) and T(r, z) define the exact radial flux

    q_r(r) = -2 (rho g)^n |s'(r)|^(n-1) s'(r)
             * int_0^H A(T(r, z)) (H - z)^(n+1) dz

with the z-integral by fixed-order Gauss-Legendre quadrature (nodes from
numpy), and the steady compensatory mass balance is the exact divergence

    M_c(r) = (1/r) d(r q_r)/dr        (radial symmetry)

by automatic differentiation (``torch.func.grad`` here, ``jax.grad`` in the
JAX package), exact to quadrature and rounding. Fed (M_c, T) and started
at the exact H, the model's drift is the discretization error of the
coupled diffusivity and transport. Test G adds a time-periodic wobble to H
with the compensatory dH/dt.

Fields are float64 on ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

SPY = 3.15569259747e7


@dataclass
class ManufacturedThermoSIA:
    """Test-F-like steady dome with a prescribed temperature field.

    H(r) = H0 (1 - (r/L)^p)^q for r < L; T(r, z) warms toward the base with
    a Gaussian radial modulation. The softness is Paterson-Budd on the
    pressure-adjusted temperature, the model's "pb" law.
    """

    H0: float = 3000.0          # m, center thickness
    L: float = 600e3            # m, margin radius
    p: float = 2.0
    q: float = 1.0
    Ts: float = 243.15          # K, surface temperature
    dTb: float = 25.0           # K, basal warming at the center
    n: float = 3.0
    rho: float = 910.0
    g: float = 9.81
    # Paterson-Budd two-branch Arrhenius on the pressure-adjusted
    # temperature (the model's "pb" flow law)
    A_cold: float = 3.610e-13   # Pa^-3 s^-1
    A_warm: float = 1.730e3
    Q_cold: float = 6.0e4       # J/mol
    Q_warm: float = 13.9e4
    T_critical: float = 263.15
    R: float = 8.31441
    beta_cc: float = 7.9e-8     # Clausius-Clapeyron [K/Pa]
    p_air: float = 101325.0
    nz_quad: int = 64

    def thickness(self, r):
        x = torch.clamp(torch.abs(r) / self.L, 0.0, 1.0)
        return self.H0 * (1.0 - x ** self.p) ** self.q

    def temperature(self, r, z):
        """T(r, z): the surface value plus a basal warming that decays with
        height and radius."""
        H = self.thickness(r)
        zeta = torch.clamp(z / torch.clamp(H, min=1.0), 0.0, 1.0)
        radial = torch.exp(-(r / (0.6 * self.L)) ** 2)
        return self.Ts + self.dTb * radial * (1.0 - zeta) ** 2

    def softness(self, T, depth):
        """Paterson-Budd softness on T_pa = T + beta_cc p."""
        p = self.p_air + self.rho * self.g * torch.clamp(depth, min=0.0)
        T_pa = T + self.beta_cc * p
        cold = T_pa < self.T_critical
        # a 0-dim tensor keeps T's dtype (two Python floats would give
        # torch's default float32)
        A = torch.where(cold, T_pa.new_tensor(self.A_cold), self.A_warm)
        Q = torch.where(cold, T_pa.new_tensor(self.Q_cold), self.Q_warm)
        return A * torch.exp(-Q / (self.R * T_pa))

    # -- exact flux and compensatory mass balance --------------------------
    def _gauss(self, device):
        x, w = np.polynomial.legendre.leggauss(self.nz_quad)
        return (torch.as_tensor(0.5 * (x + 1.0), device=device),
                torch.as_tensor(0.5 * w, device=device))

    def flux(self, r):
        """Exact radial volume flux q_r(r) [m^2/s] at a 0-dim tensor r."""
        zeta, w = self._gauss(r.device)
        H = self.thickness(r)
        dsdr = torch.func.grad(self.thickness)(r)   # flat bed: s = H
        z = zeta * H
        K = H * torch.sum(w * self.softness(self.temperature(r, z), H - z)
                          * (H - z) ** (self.n + 1.0))
        D = 2.0 * (self.rho * self.g) ** self.n \
            * torch.abs(dsdr) ** (self.n - 1.0) * K
        return -D * dsdr

    def compensatory_smb(self, r):
        """M_c(r) = (1/r) d(r q_r)/dr at a 0-dim tensor r."""
        r = torch.clamp(torch.abs(r), min=1e-3)
        dq = torch.func.grad(lambda rr: rr * self.flux(rr))(r)
        return dq / r

    # -- model-facing fields ------------------------------------------------
    def setup(self, grid, config, device="cuda"):
        """(initial state, surface model) for IceModel: the exact H, the
        enthalpy of the exact T, the compensatory SMB as the climate."""
        from ..coupler.surface import FunctionSurface
        from ..physics.enthalpy_converter import EnthalpyConverter
        from ..state import ModelState, new_geometry

        device = torch.device(device)
        r2d = torch.as_tensor(grid.radius, dtype=torch.float64, device=device)
        H = self.thickness(r2d)
        geometry = new_geometry(H, torch.zeros_like(H))

        EC = EnthalpyConverter.from_config(config)
        z = torch.as_tensor(grid.z, dtype=torch.float64, device=device)
        T3 = self.temperature(r2d[..., None], z[None, None, :])
        depth = torch.clamp(H[..., None] - z[None, None, :], min=0.0)
        p3 = EC.pressure(depth)
        E = EC.enthalpy(torch.minimum(T3, EC.melting_temperature(p3)),
                        torch.zeros_like(T3), p3)

        vv = torch.func.vmap(torch.func.vmap(self.compensatory_smb))
        Mc = torch.where(r2d < 0.999 * self.L, vv(r2d), -0.1 / SPY)
        Ts2d = self.temperature(r2d, H)

        def climate(geometry, t):
            dt_ = geometry.ice_thickness.dtype
            return Mc.to(dt_), Ts2d.to(dt_)

        return ModelState(geometry=geometry, enthalpy=E), \
            FunctionSurface(climate)


@dataclass
class ManufacturedThermoSIAPeriodic(ManufacturedThermoSIA):
    """Test-G role: the steady dome with a time-periodic thickness wobble,

        H(t, r) = H_F(r) * (1 + a sin(2 pi t / Tp) exp(-(r / sigma)^2)),

    and the compensatory mass balance of the time-dependent problem,

        M_c(t, r) = dH/dt + (1/r) d(r q_r(t, r))/dr,

    both terms by automatic differentiation. The temperature stays the
    base class's steady T(r, z), so the prescribed enthalpy stays exact
    while the flux integral sees the oscillating geometry. After a whole
    number of periods the exact solution is the initial state again.
    """

    amplitude: float = 0.1          # relative wobble at the dome
    period: float = 1000.0 * SPY    # s
    sigma_frac: float = 0.4         # radial extent of the wobble / L

    def thickness_t(self, t, r):
        wob = self.amplitude * torch.sin(2.0 * math.pi * t / self.period) \
            * torch.exp(-(r / (self.sigma_frac * self.L)) ** 2)
        return self.thickness(r) * (1.0 + wob)

    def flux_t(self, t, r):
        """Exact radial flux at time t (0-dim tensors t, r)."""
        zeta, w = self._gauss(r.device)
        H = self.thickness_t(t, r)
        dsdr = torch.func.grad(self.thickness_t, argnums=1)(t, r)
        z = zeta * H
        # T frozen at the steady field (see the class docstring)
        K = H * torch.sum(w * self.softness(self.temperature(r, z), H - z)
                          * torch.clamp(H - z, min=0.0) ** (self.n + 1.0))
        D = 2.0 * (self.rho * self.g) ** self.n \
            * torch.abs(dsdr) ** (self.n - 1.0) * K
        return -D * dsdr

    def compensatory_smb_t(self, t, r):
        """M_c(t, r) = dH/dt + div q at 0-dim tensors t, r."""
        r = torch.clamp(torch.abs(r), min=1e-3)
        dHdt = torch.func.grad(self.thickness_t, argnums=0)(t, r)
        dq = torch.func.grad(lambda rr: rr * self.flux_t(t, rr))(r)
        return dHdt + dq / r

    def setup(self, grid, config, device="cuda"):
        """The initial state at t = 0 (the steady dome) and a climate whose
        compensatory SMB is evaluated at each call's time."""
        from ..coupler.surface import FunctionSurface

        state, _ = ManufacturedThermoSIA.setup(self, grid, config, device)
        r2d = torch.as_tensor(grid.radius, dtype=torch.float64,
                              device=torch.device(device))
        Ts2d = self.temperature(r2d, self.thickness(r2d))
        mc_grid = torch.func.vmap(
            torch.func.vmap(self.compensatory_smb_t, (None, 0)), (None, 0))

        def climate(geometry, t):
            dt_ = geometry.ice_thickness.dtype
            tt = torch.tensor(float(t), dtype=r2d.dtype, device=r2d.device)
            Mc = torch.where(r2d < 0.999 * self.L, mc_grid(tt, r2d),
                             -0.1 / SPY)
            return Mc.to(dt_), Ts2d.to(dt_)

        return state, FunctionSurface(climate)
