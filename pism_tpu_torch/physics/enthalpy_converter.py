"""Enthalpy <-> (temperature, liquid water fraction) conversions (port of
``pism_tpu/physics/enthalpy_converter.py``, the default converter only).

Cold ice has E < E_s(p) with T = T_ref + E/c_i, temperate ice has
omega = (E - E_s)/L. All methods are elementwise on tensors (or floats).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def _clamp_min0(x):
    return torch.clamp(x, min=0.0) if torch.is_tensor(x) else max(x, 0.0)


@dataclass(frozen=True)
class EnthalpyConverter:
    T_melting: float = 273.15       # melting point at 1 atm [K]
    T_ref: float = 223.15           # reference temperature [K]
    c_i: float = 2009.0             # specific heat of ice [J/(kg K)]
    c_w: float = 4170.0             # specific heat of water
    L0: float = 3.34e5              # latent heat of fusion [J/kg]
    beta: float = 7.9e-8            # Clausius-Clapeyron [K/Pa]
    rho_i: float = 910.0
    g: float = 9.81
    p_air: float = 101325.0

    @classmethod
    def from_config(cls, config) -> "EnthalpyConverter":
        return cls(
            T_melting=config.get_number("constants.fresh_water.melting_point_temperature"),
            T_ref=config.get_number("energy.enthalpy.reference_temperature"),
            c_i=config.get_number("constants.ice.specific_heat_capacity"),
            c_w=config.get_number("constants.fresh_water.specific_heat_capacity"),
            L0=config.get_number("constants.fresh_water.latent_heat_of_fusion"),
            beta=config.get_number("constants.ice.beta_Clausius_Clapeyron"),
            rho_i=config.get_number("constants.ice.density"),
            g=config.get_number("constants.standard_gravity"),
        )

    def pressure(self, depth):
        """Hydrostatic ice pressure at given depth below the surface."""
        return self.p_air + self.rho_i * self.g * _clamp_min0(depth)

    def melting_temperature(self, p):
        return self.T_melting - self.beta * p

    def enthalpy_cts(self, p):
        """E_s(p): enthalpy at the cold-temperate transition surface."""
        return self.c_i * (self.melting_temperature(p) - self.T_ref)

    def temperature(self, E, p):
        Es = self.enthalpy_cts(p)
        T_cold = self.T_ref + E / self.c_i
        return torch.where(E < Es, T_cold, self.melting_temperature(p))

    def pressure_adjusted_temperature(self, E, p):
        """T_pa = T - T_m(p) + T_melting (what flow laws consume)."""
        return self.temperature(E, p) - self.melting_temperature(p) + self.T_melting

    def water_fraction(self, E, p):
        Es = self.enthalpy_cts(p)
        return torch.clamp((E - Es) / self.L0, 0.0, 1.0)

    def enthalpy(self, T, omega, p):
        """E(T, omega, p) for cold (omega=0) or temperate ice."""
        Es = self.enthalpy_cts(p)
        E_cold = self.c_i * (T - self.T_ref)
        return torch.where(T < self.melting_temperature(p), E_cold,
                           Es + omega * self.L0)
