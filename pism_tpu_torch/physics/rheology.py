"""Flow laws (port of ``pism_tpu/physics/rheology.py``): the isothermal
Glen law, Paterson-Budd (``pb``) with its cold and warm branches
(``pb_cold``, ``pb_warm``), Hooke (1981), the polythermal GPBLD law (the
default of the SIA and the SSA) and the Goldsby-Kohlstedt composite law
(``gk``, SIA only), each with the methods of its JAX class:
``softness``, ``hardness``, ``flow`` and ``averaged_hardness``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from .enthalpy_converter import EnthalpyConverter


def _floating(E):
    """E as a floating tensor (an integer or Python value becomes float64,
    as ``jnp.result_type(E, 1.0)`` does under x64)."""
    if isinstance(E, (int, float)):
        return torch.tensor(float(E), dtype=torch.float64)
    E = torch.as_tensor(E)
    return E if E.is_floating_point() else E.to(torch.float64)


@dataclass(frozen=True)
class FlowLaw:
    """Base Glen-type law: F(sigma, E, p) = A(E, p) sigma^(n-1)."""

    n: float = 3.0
    EC: EnthalpyConverter = field(default_factory=EnthalpyConverter)

    def softness(self, E, p):
        raise NotImplementedError

    def hardness(self, E, p):
        return self.softness(E, p) ** (-1.0 / self.n)

    def flow(self, stress, E, p):
        """Strain-rate factor: eps_dot = flow(sigma) sigma (PISM
        ``FlowLaw::flow``)."""
        return self.softness(E, p) * stress ** (self.n - 1.0)

    def averaged_hardness(self, thickness, E_column, z):
        """Vertical average of the hardness over the ice column (the SSA's
        B). E_column: (..., Mz); z: (Mz,) levels. Trapezoid rule restricted
        to z <= H."""
        H = thickness[..., None]
        depth = torch.clamp(H - z, min=0.0)
        p = self.EC.pressure(depth)
        B = self.hardness(E_column, p)
        z_c = torch.minimum(z, H)
        w = torch.diff(z_c, dim=-1)
        B_mid = 0.5 * (B[..., 1:] + B[..., :-1])
        integral = torch.sum(B_mid * w, dim=-1)
        return torch.where(thickness > 0.0,
                           integral / torch.clamp(thickness, min=1e-9),
                           B[..., 0])


@dataclass(frozen=True)
class IsothermalGlen(FlowLaw):
    """Constant softness (PISM ``rheology::IsothermalGlen``)."""

    A: float = 3.1689e-24  # Pa^-3 s^-1

    def softness(self, E, p):
        return torch.full_like(_floating(E), self.A)

    def hardness(self, E, p):
        return torch.full_like(_floating(E), self.A ** (-1.0 / self.n))


@dataclass(frozen=True)
class PatersonBudd(FlowLaw):
    """Temperature-dependent Arrhenius law (Paterson & Budd 1982)."""

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


@dataclass(frozen=True)
class PatersonBuddCold(PatersonBudd):
    """Only the cold branch (PISM ``pb_cold``; verification tests F/G)."""

    def softness_from_temp_pa(self, T_pa):
        return self.A_cold * torch.exp(-self.Q_cold / (self.R * T_pa))

    def tempFromSoftness(self, A):
        return -self.Q_cold / (self.R * torch.log(A / self.A_cold))


@dataclass(frozen=True)
class PatersonBuddWarm(PatersonBudd):
    """Only the warm branch (PISM ``pb_warm``)."""

    def softness_from_temp_pa(self, T_pa):
        return self.A_warm * torch.exp(-self.Q_warm / (self.R * T_pa))


@dataclass(frozen=True)
class Hooke(PatersonBudd):
    """Hooke (1981) law (PISM ``rheology::Hooke``), with the JAX package's
    constants."""

    A_Hooke: float = 4.42e-10  # Pa^-3 s^-1
    Q_Hooke: float = 7.88e4
    C_Hooke: float = 0.16612
    K_Hooke: float = 1.17
    Tr_Hooke: float = 273.39

    def softness_from_temp_pa(self, T_pa):
        return self.A_Hooke * torch.exp(
            -self.Q_Hooke / (self.R * T_pa)
            + 3.0 * self.C_Hooke
            / torch.clamp(self.Tr_Hooke - T_pa, min=1e-3) ** self.K_Hooke)


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


@dataclass(frozen=True)
class GoldsbyKohlstedt(FlowLaw):
    """Goldsby & Kohlstedt (2001) composite creep law: diffusional flow,
    dislocation creep and the harmonic combination of basal slip and
    grain-boundary sliding, grain-size dependent (the JAX package's
    constants, MPa-based, converted to Pa).

    Only ``flow`` is defined; there is no Glen softness or hardness, so the
    SIA takes this law through the stress-dependent diffusivity integral
    (``ops/sia.py`` ``_flow_integral``) and the factory refuses it for the
    SSA, as the JAX package does."""

    generalized = True          # ops/sia.py takes the flow() integral

    grain_size: float = 1.0e-3  # m
    V_act_vol: float = -13.0e-6  # m^3/mol activation volume
    R: float = 8.31441

    # dislocation creep
    disl_crit_temp: float = 258.0
    disl_A_cold: float = 4.0e5    # MPa^-4 s^-1
    disl_A_warm: float = 6.0e28
    disl_n: float = 4.0
    disl_Q_cold: float = 60.0e3   # J/mol
    disl_Q_warm: float = 180.0e3
    # easy slip (basal)
    basal_A: float = 5.5e7        # MPa^-2.4 s^-1
    basal_n: float = 2.4
    basal_Q: float = 60.0e3
    # grain boundary sliding
    gbs_crit_temp: float = 255.0
    gbs_A_cold: float = 3.9e-3    # MPa^-1.8 m^1.4 s^-1
    gbs_A_warm: float = 3.0e26
    gbs_n: float = 1.8
    gbs_Q_cold: float = 49.0e3
    gbs_Q_warm: float = 192.0e3
    p_grain_sz_exp: float = 1.4
    # diffusional flow
    diff_crit_temp: float = 258.0
    diff_V_m: float = 1.97e-5     # molar volume m^3/mol
    diff_D_0v: float = 9.10e-4    # m^2/s volume diffusion pre-exponential
    diff_Q_v: float = 59.4e3
    diff_D_0b: float = 5.8e-4     # m^2/s grain-boundary diffusion
    diff_Q_b: float = 49.0e3
    diff_delta: float = 9.04e-10  # m, grain-boundary width

    def softness(self, E, p):
        raise RuntimeError(
            "Goldsby-Kohlstedt does not define a Glen softness; "
            "use flow() (same restriction as the reference)")

    def hardness(self, E, p):
        raise RuntimeError(
            "Goldsby-Kohlstedt does not define a Glen hardness")

    def averaged_hardness(self, thickness, E_column, z):
        raise RuntimeError(
            "Goldsby-Kohlstedt cannot be used in the SSA (no hardness)")

    def flow(self, stress, E, p):
        """Strain-rate factor F with eps = F sigma, from the absolute
        temperature; stress in Pa."""
        T = self.EC.temperature(E, p)
        gs = self.grain_size
        pV = p * self.V_act_vol
        RT = self.R * torch.clamp(T, min=1.0)
        MPa = 1.0e-6  # Pa -> MPa folded into the prefactors

        # diffusional flow (linear in stress: a constant factor)
        D_v = self.diff_D_0v * torch.exp(-self.diff_Q_v / RT)
        D_b = self.diff_D_0b * torch.exp(-self.diff_Q_b / RT)
        D_b = torch.where(T > self.diff_crit_temp, D_b * 1000.0, D_b)
        eps_diff = 42.0 * self.diff_V_m \
            * (D_v + math.pi * self.diff_delta * D_b / gs) / (RT * gs ** 2)

        sig = torch.clamp(stress, min=1e-10)
        warm_d = T > self.disl_crit_temp
        A_d = torch.where(warm_d, torch.full_like(T, self.disl_A_warm),
                          self.disl_A_cold) * MPa ** self.disl_n
        Q_d = torch.where(warm_d, torch.full_like(T, self.disl_Q_warm),
                          self.disl_Q_cold)
        eps_disl = A_d * sig ** (self.disl_n - 1.0) \
            * torch.exp(-(Q_d + pV) / RT)
        eps_basal = self.basal_A * MPa ** self.basal_n \
            * sig ** (self.basal_n - 1.0) \
            * torch.exp(-(self.basal_Q + pV) / RT)
        warm_g = T > self.gbs_crit_temp
        A_g = torch.where(warm_g, torch.full_like(T, self.gbs_A_warm),
                          self.gbs_A_cold) * MPa ** self.gbs_n
        Q_g = torch.where(warm_g, torch.full_like(T, self.gbs_Q_warm),
                          self.gbs_Q_cold)
        eps_gbs = A_g * sig ** (self.gbs_n - 1.0) \
            / gs ** self.p_grain_sz_exp * torch.exp(-(Q_g + pV) / RT)

        return eps_diff + eps_disl \
            + eps_basal * eps_gbs / torch.clamp(eps_basal + eps_gbs,
                                                min=1e-300)


def flow_law_from_config(config, which: str = "sia",
                         EC: EnthalpyConverter = None) -> FlowLaw:
    """Factory (PISM ``rheology::FlowLawFactory``): every name the JAX
    factory builds; ``flow_law.grain_aware_GK`` forces ``gk`` for the SIA.
    An unknown name raises ValueError, and ``gk`` for another stress
    balance than the SIA too, as in the JAX package."""
    if EC is None:
        EC = EnthalpyConverter.from_config(config)
    name = config.get_string(f"stress_balance.{which}.flow_law")
    if which == "sia" and config.get_flag("flow_law.grain_aware_GK"):
        name = "gk"
    n = config.get_number(f"stress_balance.{which}.Glen_exponent")
    pb_kw = dict(
        n=n, EC=EC,
        A_cold=config.get_number("flow_law.Paterson_Budd.A_cold"),
        A_warm=config.get_number("flow_law.Paterson_Budd.A_warm"),
        Q_cold=config.get_number("flow_law.Paterson_Budd.Q_cold"),
        Q_warm=config.get_number("flow_law.Paterson_Budd.Q_warm"),
        T_critical=config.get_number("flow_law.Paterson_Budd.T_critical"),
        R=config.get_number("constants.ideal_gas_constant"),
    )
    if name == "isothermal_glen":
        return IsothermalGlen(
            n=n, EC=EC,
            A=config.get_number("flow_law.isothermal_Glen.ice_softness"))
    if name == "pb":
        return PatersonBudd(**pb_kw)
    if name == "pb_cold":
        return PatersonBuddCold(**pb_kw)
    if name == "pb_warm":
        return PatersonBuddWarm(**pb_kw)
    if name == "hooke":
        return Hooke(
            **pb_kw,
            # flow_law.Hooke.A is stored in s-1 MPa-3 (reference units)
            A_Hooke=config.get_number("flow_law.Hooke.A") * 1e-18,
            Q_Hooke=config.get_number("flow_law.Hooke.Q"),
            C_Hooke=config.get_number("flow_law.Hooke.C"),
            K_Hooke=config.get_number("flow_law.Hooke.k"),
            Tr_Hooke=config.get_number("flow_law.Hooke.Tr"))
    if name == "gk":
        if which != "sia":
            raise ValueError(
                "Goldsby-Kohlstedt is SIA-only (no Glen hardness; the "
                "reference FlowLawFactory applies the same restriction)")
        gs = config.get_number("flow_law.gk.grain_size") \
            if config.is_set("flow_law.gk.grain_size") \
            else config.get_number("constants.ice.grain_size", "m")
        return GoldsbyKohlstedt(
            n=n, EC=EC, grain_size=gs,
            R=config.get_number("constants.ideal_gas_constant"))
    if name == "gpbld":
        return GPBLD(
            **pb_kw,
            water_frac_coeff=config.get_number(
                "flow_law.gpbld.water_frac_coeff"),
            water_frac_observed_limit=config.get_number(
                "flow_law.gpbld.water_frac_observed_limit"))
    raise ValueError(f"unknown flow law {name!r}")
