"""Flow laws (port of ``pism_tpu/physics/rheology.py``): the
Paterson-Budd law (``pb``, EISMINT II's SIA law), the polythermal GPBLD
law, the default of both the SIA and the SSA, and the isothermal Glen law
of the verification tests and MISMIP (SIA and SSA). Other laws raise
``NotImplementedError`` in :func:`flow_law_from_config`.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .enthalpy_converter import EnthalpyConverter


@dataclass(frozen=True)
class IsothermalGlen:
    """Constant softness (PISM ``rheology::IsothermalGlen``)."""

    n: float = 3.0
    EC: EnthalpyConverter = field(default_factory=EnthalpyConverter)
    A: float = 3.1689e-24  # Pa^-3 s^-1

    def softness(self, E, p):
        return torch.full_like(_floating(E), self.A)

    def hardness(self, E, p):
        return torch.full_like(_floating(E), self.A ** (-1.0 / self.n))

    def averaged_hardness(self, thickness, E_column, z):
        return _averaged_hardness(self, thickness, E_column, z)


def _averaged_hardness(law, thickness, E_column, z):
    """Vertical average of the law's hardness over the ice column (the
    SSA's B; the JAX package's ``FlowLaw.averaged_hardness``).

    E_column: (..., Mz); z: (Mz,) levels. Trapezoid rule restricted to
    z <= H."""
    H = thickness[..., None]
    depth = torch.clamp(H - z, min=0.0)
    p = law.EC.pressure(depth)
    B = law.hardness(E_column, p)
    z_c = torch.minimum(z, H)
    w = torch.diff(z_c, dim=-1)
    B_mid = 0.5 * (B[..., 1:] + B[..., :-1])
    integral = torch.sum(B_mid * w, dim=-1)
    return torch.where(thickness > 0.0,
                       integral / torch.clamp(thickness, min=1e-9),
                       B[..., 0])


def _floating(E):
    """E as a floating tensor (an integer or Python value becomes float64,
    as ``jnp.result_type(E, 1.0)`` does under x64)."""
    if isinstance(E, (int, float)):
        return torch.tensor(float(E), dtype=torch.float64)
    E = torch.as_tensor(E)
    return E if E.is_floating_point() else E.to(torch.float64)


@dataclass(frozen=True)
class PatersonBudd:
    """Temperature-dependent Arrhenius law (Paterson & Budd 1982)."""

    n: float = 3.0
    EC: EnthalpyConverter = field(default_factory=EnthalpyConverter)
    A_cold: float = 3.610e-13  # Pa^-3 s^-1
    A_warm: float = 1.730e3
    Q_cold: float = 6.0e4      # J/mol
    Q_warm: float = 13.9e4
    T_critical: float = 263.15
    R: float = 8.31441

    def softness_from_temp_pa(self, T_pa):
        cold = T_pa < self.T_critical
        A = torch.where(cold, torch.full_like(T_pa, self.A_cold), self.A_warm)
        Q = torch.where(cold, torch.full_like(T_pa, self.Q_cold), self.Q_warm)
        return A * torch.exp(-Q / (self.R * T_pa))

    def softness(self, E, p):
        return self.softness_from_temp_pa(
            self.EC.pressure_adjusted_temperature(E, p))

    def hardness(self, E, p):
        return self.softness(E, p) ** (-1.0 / self.n)

    def averaged_hardness(self, thickness, E_column, z):
        return _averaged_hardness(self, thickness, E_column, z)


@dataclass(frozen=True)
class GPBLD(PatersonBudd):
    """Glen-Paterson-Budd-Lliboutry-Duval polythermal law (PISM default):
    Paterson-Budd softness times (1 + C omega) for temperate ice."""

    water_frac_coeff: float = 181.25
    water_frac_observed_limit: float = 0.01

    def softness(self, E, p):
        base = self.softness_from_temp_pa(
            self.EC.pressure_adjusted_temperature(E, p))
        omega = torch.clamp(self.EC.water_fraction(E, p),
                            max=self.water_frac_observed_limit)
        return base * (1.0 + self.water_frac_coeff * omega)


def flow_law_from_config(config, which: str = "sia",
                         EC: EnthalpyConverter = None) -> PatersonBudd:
    """Factory (PISM ``rheology::FlowLawFactory``): ``pb``, ``gpbld`` and
    ``isothermal_glen``."""
    from ..config import require

    require(config, f"stress_balance.{which}.flow_law",
            ("gpbld", "pb", "isothermal_glen"))
    if which == "sia":
        require(config, "flow_law.grain_aware_GK", (False,))
    if EC is None:
        EC = EnthalpyConverter.from_config(config)
    name = config.get_string(f"stress_balance.{which}.flow_law")
    if name == "isothermal_glen":
        return IsothermalGlen(
            n=config.get_number(f"stress_balance.{which}.Glen_exponent"),
            EC=EC, A=config.get_number("flow_law.isothermal_Glen.ice_softness"))
    pb_kw = dict(
        n=config.get_number(f"stress_balance.{which}.Glen_exponent"), EC=EC,
        A_cold=config.get_number("flow_law.Paterson_Budd.A_cold"),
        A_warm=config.get_number("flow_law.Paterson_Budd.A_warm"),
        Q_cold=config.get_number("flow_law.Paterson_Budd.Q_cold"),
        Q_warm=config.get_number("flow_law.Paterson_Budd.Q_warm"),
        T_critical=config.get_number("flow_law.Paterson_Budd.T_critical"),
        R=config.get_number("constants.ideal_gas_constant"),
    )
    if name == "pb":
        return PatersonBudd(**pb_kw)
    return GPBLD(
        **pb_kw,
        water_frac_coeff=config.get_number("flow_law.gpbld.water_frac_coeff"),
        water_frac_observed_limit=config.get_number(
            "flow_law.gpbld.water_frac_observed_limit"),
    )
