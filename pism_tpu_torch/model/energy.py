"""Polythermal enthalpy conservation (port of ``pism_tpu/model/energy.py``):
per column an implicit advection-conduction solve for specific enthalpy E
with temperate-ice drainage and a basal melt-rate budget. All columns are
solved at once by the batched Thomas solver.

    dE/dt + u E_x + v E_y + w E_z = (kappa(E) E_z)_z + Phi / rho

Horizontal advection is explicit first-order upwind; vertical advection
and conduction are implicit. Basal boundary: cold grounded base ->
Neumann (geothermal + friction heating); temperate or floating base ->
Dirichlet at E_s(p_b) with the melt rate from the flux imbalance.

On an ensemble's member axis (``lead = 1``: E ``(B, My, Mx, Mz)``) the time
step is a host float or a per-member tensor of the field dtype shaped
``(B, 1, 1)``; each column's solve is its own, so a member computes what a
run of it alone computes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import state as S
from ..config import require
from ..ops.sia3d import SIA3D
from ..ops.stencils import Shifter
from ..physics.enthalpy_converter import EnthalpyConverter
from ..util.tridiag import solve_batched


class EnergyStepResult(NamedTuple):
    enthalpy: torch.Tensor
    basal_melt_rate: torch.Tensor


@dataclass
class EnergyModel:
    grid: object
    config: object
    EC: EnthalpyConverter
    lead: int = 0    # leading member dims of the fields

    def __post_init__(self):
        cfg = self.config
        require(cfg, "energy.model", ("enthalpy",))
        require(cfg, "energy.ch_warming.enabled", (False,))
        require(cfg, "energy.temperature_dependent_conductivity", (False,))
        self.rho = cfg.get_number("constants.ice.density")
        self.c_i = cfg.get_number("constants.ice.specific_heat_capacity")
        self.k_i = cfg.get_number("constants.ice.thermal_conductivity")
        self.L = cfg.get_number("constants.fresh_water.latent_heat_of_fusion")
        self.kappa_cold = self.k_i / (self.rho * self.c_i)   # m^2/s
        self.temperate_ratio = cfg.get_number(
            "energy.enthalpy.temperate_ice_thermal_conductivity_ratio")
        self.drain_rate = cfg.get_number("energy.drainage_maximum_rate", "s-1")
        self.bulge_max = cfg.get_number("energy.enthalpy.cold_bulge_max")
        self.drain_target = cfg.get_number("energy.drainage_target_water_fraction")
        self.basal_melt_max = cfg.get_number("energy.basal_melt.max", "m s-1")
        self.sh = Shifter(self.grid, self.lead)

    def step(self, state: S.ModelState, sia3: SIA3D, surface_T, dt,
             geothermal_flux, frictional_heating=None,
             tillwat=None) -> EnergyStepResult:
        """Advance enthalpy by dt (a host float, or per member a tensor of
        the field dtype shaped to the 2D fields). surface_T: ice surface
        temperature [K]; geothermal_flux [W/m^2]; frictional_heating:
        tau_b . u_b [W/m^2]."""
        EC, grid, sh = self.EC, self.grid, self.sh
        E = state.enthalpy
        H = state.geometry.ice_thickness
        mask = state.geometry.cell_type
        z_np = np.asarray(grid.z)
        z = torch.as_tensor(z_np, dtype=E.dtype, device=E.device)
        dz = torch.as_tensor(np.diff(z_np), dtype=E.dtype, device=E.device)
        z1 = torch.tensor(z_np[1], dtype=E.dtype).item()   # host, no sync
        Hc = H[..., None]
        dt3 = dt[..., None] if torch.is_tensor(dt) else dt   # for 3D fields

        G = geothermal_flux
        if frictional_heating is not None:
            G = G + frictional_heating

        # -- boundary values ------------------------------------------------
        T_sfc = torch.clamp(surface_T, max=EC.T_melting)
        E_sfc = EC.enthalpy(T_sfc, 0.0, EC.pressure(0.0))
        p_base = EC.pressure(H)
        Es_base = EC.enthalpy(EC.melting_temperature(p_base), 0.0, p_base)

        floating = S.floating_ice(mask)
        icy = S.icy(mask)
        base_temperate = (E[..., 0] >= Es_base) | floating

        # -- explicit horizontal advection (first-order upwind) -------------
        u, v = sia3.u, sia3.v
        dEdx_up = torch.where(u >= 0.0, (E - sh(E, 0, -1)) / grid.dx,
                              (sh(E, 0, 1) - E) / grid.dx)
        dEdy_up = torch.where(v >= 0.0, (E - sh(E, -1, 0)) / grid.dy,
                              (sh(E, 1, 0) - E) / grid.dy)
        rhs_adv = -(u * dEdx_up + v * dEdy_up)

        # -- conduction coefficients (lagged diffusivity) --------------------
        depth = torch.clamp(Hc - z, min=0.0)
        p3 = EC.pressure(depth)
        temperate3 = E >= EC.enthalpy_cts(p3)
        kappa = torch.where(temperate3,
                            torch.full_like(E, self.kappa_cold * self.temperate_ratio),
                            self.kappa_cold)
        kap_m = 0.5 * (kappa[..., 1:] + kappa[..., :-1])      # at interfaces

        dz_l = torch.cat([dz[:1], dz])                        # dz below level k
        dz_u = torch.cat([dz, dz[-1:]])                       # dz above level k
        # partial top layer: the Dirichlet surface value sits at z = H
        z_next = torch.cat([z[1:], z[-1:] + dz[-1]])
        is_sfc_layer = (z <= Hc) & (z_next > Hc)
        dz_u3 = torch.where(is_sfc_layer,
                            torch.maximum(Hc - z, 0.05 * dz_u), dz_u)
        dz_l3 = torch.broadcast_to(dz_l, dz_u3.shape)
        dz_c = 0.5 * (dz_l3 + dz_u3)

        kap_below = torch.cat([kap_m[..., :1], kap_m], dim=-1)
        kap_above = torch.cat([kap_m, kap_m[..., -1:]], dim=-1)

        w = sia3.w
        w_pos = torch.clamp(w, min=0.0)
        w_neg = torch.clamp(w, max=0.0)

        a = dt3 * (-kap_below / (dz_l3 * dz_c) - w_pos / dz_l3)
        c = dt3 * (-kap_above / (dz_u3 * dz_c) + w_neg / dz_u3)
        b = 1.0 - a - c
        d = E + dt3 * (sia3.strain_heating / self.rho + rhs_adv)

        # -- air rows (levels above the ice surface): E = E_sfc --------------
        is_air = z > Hc
        a = torch.where(is_air, 0.0, a)
        c = torch.where(is_air, 0.0, c)
        b = torch.where(is_air, 1.0, b)
        d = torch.where(is_air, E_sfc[..., None], d)

        # -- basal row: Neumann (cold grounded) E0 - E1 = G dz0 c_i / k_i ----
        dirichlet = base_temperate
        a[..., 0] = 0.0
        b[..., 0] = 1.0
        c[..., 0] = torch.where(dirichlet, 0.0, -1.0).to(E.dtype)
        d[..., 0] = torch.where(dirichlet, Es_base,
                                G * dz[0] * self.c_i / self.k_i)

        E_new = solve_batched(a, b, c, d)

        # -- cold-bulge limiter ---------------------------------------------
        E_new = torch.maximum(E_new, E_sfc[..., None] - self.bulge_max)

        # -- thin/ice-free columns: surface-value column ---------------------
        thin = H < max(z1, 1.0)
        E_new = torch.where((thin | ~icy)[..., None], E_sfc[..., None], E_new)

        # -- drainage of excess liquid water --------------------------------
        omega = EC.water_fraction(E_new, p3)
        excess = torch.clamp(omega - self.drain_target, min=0.0)
        drained = torch.clamp(excess, max=S.dt_scale(self.drain_rate, dt3))
        E_new = E_new - drained * self.L
        mid_drain = 0.5 * (drained[..., 1:] + drained[..., :-1])
        # the reference adds two boolean arrays, which JAX evaluates as a
        # logical or: the weight is 0.5 wherever either level is in the ice
        in_ice_mid = 0.5 * ((z[:-1] < Hc) | (z[1:] < Hc)).to(E.dtype)
        drain_flux = S.dt_divide(
            torch.sum(mid_drain * in_ice_mid * dz, dim=-1), dt)

        # -- basal melt budget (grounded) ------------------------------------
        q_ice = -(kap_m[..., 0] * self.rho) * (E_new[..., 1] - E_new[..., 0]) \
            / dz[0]
        M_b = torch.where(base_temperate & ~floating,
                          (G - q_ice) / (self.rho * self.L), 0.0)
        if tillwat is None:
            M_b = torch.clamp(M_b, min=0.0)
        else:
            M_b = torch.where(tillwat > 0.0, M_b, torch.clamp(M_b, min=0.0))
        M_b = torch.where(icy & ~floating, M_b + drain_flux, 0.0)
        if self.basal_melt_max > 0.0:
            M_b = torch.clamp(M_b, -self.basal_melt_max, self.basal_melt_max)
        return EnergyStepResult(enthalpy=E_new, basal_melt_rate=M_b)


def bootstrap_enthalpy(grid, EC: EnthalpyConverter, thickness, surface_T,
                       smb=None, geothermal=0.042, k_i=2.10,
                       heuristic: str = "smb", rho=910.0, c_i=2009.0):
    """Initial 3D enthalpy guess (PISM ``src/energy/utilities.cc`` bootstrap
    profiles, selected by ``bootstrapping.temperature_heuristic``):

    - ``"smb"`` with an SMB field: the Robin (1955) advective-conductive
      steady profile T(z) = T_s + (G/k)(sqrt(pi)/2) q [erf(H/q) - erf(z/q)]
      with q = sqrt(2 kappa H / a) and a the accumulation rate [m/s];
    - ``"quartic_guess"``, or no SMB (as ``IceModel.prepare_state`` calls
      it): the conduction-only profile T(z) = T_s + (G/k)(H - z).

    Both are capped at the pressure-melting point. ``geothermal`` is a
    number or a 2D field."""
    H = thickness
    z = torch.as_tensor(grid.z, dtype=H.dtype, device=H.device)
    Hc = H[..., None]
    depth = torch.clamp(Hc - z, min=0.0)
    G = geothermal[..., None] if torch.is_tensor(geothermal) else geothermal
    Ts = surface_T[..., None]
    if heuristic == "smb" and smb is not None:
        kappa = k_i / (rho * c_i)
        a = torch.clamp(smb[..., None], min=1e-12)   # m/s
        q = torch.sqrt(2.0 * kappa * torch.clamp(Hc, min=1.0) / a)
        zz = torch.clamp(Hc - depth, min=0.0)        # height above the base
        T = Ts + (G / k_i) * (math.sqrt(math.pi) / 2.0) * q \
            * (torch.special.erf(Hc / q) - torch.special.erf(zz / q))
    else:
        T = Ts + G / k_i * depth
    p = EC.pressure(depth)
    T = torch.minimum(T, EC.melting_temperature(p))
    return EC.enthalpy(T, 0.0, p)
