"""Basal strength (port of ``pism_tpu/physics/basal.py``): the till yield
stress and the (pseudo-)plastic sliding-law drag coefficient.

- Mohr-Coulomb: tau_c = c0 + tan(phi) N_till, with N_till from the till
  water amount (Bueler & van Pelt 2015; with ``add_transportable_water``
  the routed layer's tlftw log1p(W / 0.1) added to it); phi the state's ``till_phi`` field
  (an ensemble's members may differ in it), from the bed elevation with
  ``topg_to_phi``, and no till drag at marine grounding lines with
  ``slippery_grounding_lines``;
- a constant tau_c, or a prescribed tau_c field (an array, or ``tauc``
  read from ``basal_yield_stress.given.file``); ocean cells have none;
- beta(u) for tau_b = -beta(|u|) u:
      beta = tau_c |u|^(q-1) / u_threshold^q      (pseudo-plastic)
      beta = tau_c / sqrt(|u|^2 + u_reg^2)         (plastic, q = 0)
  and c = 2 dbeta/d|u|^2, the drag tangent of the exact drag Jacobian.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import state as S
from ..config import require


@dataclass
class MohrCoulombYieldStress:
    """tau_c = c0 + tan(phi) * N_till (PISM ``MohrCoulombYieldStress``)."""

    config: object

    def __post_init__(self):
        cfg = self.config
        require(cfg, "basal_yield_stress.model", ("mohr_coulomb",))
        require(cfg, "basal_yield_stress.mohr_coulomb.tillphi_opt.enabled",
                (False,))
        require(cfg, "basal_yield_stress.mohr_coulomb.delta.file", ("",))
        self.c0 = cfg.get_number("basal_yield_stress.mohr_coulomb.till_cohesion")
        self.phi_default = cfg.get_number(
            "basal_yield_stress.mohr_coulomb.till_phi_default")
        self.N0 = cfg.get_number(
            "basal_yield_stress.mohr_coulomb.till_reference_effective_pressure")
        self.e0 = cfg.get_number(
            "basal_yield_stress.mohr_coulomb.till_reference_void_ratio")
        self.Cc = cfg.get_number(
            "basal_yield_stress.mohr_coulomb.till_compressibility_coefficient")
        self.delta = cfg.get_number(
            "basal_yield_stress.mohr_coulomb.till_effective_fraction_overburden")
        self.W_max = cfg.get_number("hydrology.tillwat_max")
        self.rho_i = cfg.get_number("constants.ice.density")
        self.g = cfg.get_number("constants.standard_gravity")
        self.tau_c_ice_free = cfg.get_number("basal_yield_stress.ice_free_bedrock")
        self.t2p_enabled = cfg.get_flag(
            "basal_yield_stress.mohr_coulomb.topg_to_phi.enabled")
        self.t2p = tuple(cfg.get_number(
            "basal_yield_stress.mohr_coulomb.topg_to_phi." + k)
            for k in ("phi_min", "phi_max", "topg_min", "topg_max"))
        self.add_transportable = cfg.get_flag(
            "basal_yield_stress.add_transportable_water")
        self.tlftw = cfg.get_number(
            "basal_yield_stress.mohr_coulomb.till_log_factor_transportable_water")
        self.slippery_gl = cfg.get_flag(
            "basal_yield_stress.slippery_grounding_lines")

    def topg_to_phi(self, bed):
        """Till friction angle from the bed elevation (PISM
        ``-topg_to_phi``): phi_min below topg_min, a linear ramp to phi_max
        at topg_max."""
        phi_min, phi_max, b_min, b_max = self.t2p
        w = torch.clamp((bed - b_min) / max(b_max - b_min, 1e-30), 0.0, 1.0)
        return phi_min + (phi_max - phi_min) * w

    def effective_pressure(self, tillwat, P_overburden):
        """Bueler & van Pelt (2015) eq. 23: N_till from till water amount."""
        s = torch.clamp(tillwat / self.W_max, 0.0, 1.0)
        N = self.N0 * (self.delta * P_overburden / self.N0) ** s \
            * 10.0 ** ((self.e0 / self.Cc) * (1.0 - s))
        return torch.minimum(P_overburden, N)

    def compute(self, state: S.ModelState, t=None):
        H = state.geometry.ice_thickness
        mask = state.geometry.cell_type
        P_ov = self.rho_i * self.g * H
        tillwat = state.tillwat if state.tillwat is not None \
            else torch.zeros_like(H)
        if self.add_transportable and state.hydro_W is not None:
            # the routed transportable layer weakens the till on top of the
            # till water, by a log-saturating term
            tillwat = torch.clamp(
                tillwat + self.tlftw * torch.log1p(state.hydro_W / 0.1),
                0.0, self.W_max)
        N = self.effective_pressure(tillwat, torch.clamp(P_ov, min=1.0))
        if state.till_phi is not None:
            tan_phi = torch.tan(torch.deg2rad(state.till_phi))
        else:
            tan_phi = math.tan(math.radians(self.phi_default))
        tau_c = self.c0 + tan_phi * N
        # ice-free bedrock is strong; floating ice and ocean have no till drag
        tau_c = torch.where(mask == S.MASK_ICE_FREE_BEDROCK,
                            self.tau_c_ice_free, tau_c)
        tau_c = torch.where(S.ocean(mask), 0.0, tau_c)
        if self.slippery_gl:
            # grounded marine cells touching the ocean slide freely; the
            # neighbours wrap at the domain edges, as the JAX package's
            # jnp.roll does; y and x are the last two axes (an ensemble's
            # fields lead with the member axis)
            o = S.ocean(mask)
            nbr = (torch.roll(o, 1, -2) | torch.roll(o, -1, -2)
                   | torch.roll(o, 1, -1) | torch.roll(o, -1, -1))
            gl = S.grounded_ice(mask) & (state.geometry.bed_elevation
                                         < state.geometry.sea_level) & nbr
            tau_c = torch.where(gl, 0.0, tau_c)
        return tau_c


@dataclass
class ConstantYieldStress:
    """tau_c = ``basal_yield_stress.constant.value`` (PISM
    ``ConstantYieldStress``)."""

    config: object

    def __post_init__(self):
        self.value = self.config.get_number("basal_yield_stress.constant.value")

    def compute(self, state: S.ModelState, t=None):
        H = state.geometry.ice_thickness
        tau_c = torch.full_like(H, self.value)
        return torch.where(S.ocean(state.geometry.cell_type), 0.0, tau_c)


@dataclass
class GivenYieldStress:
    """A prescribed till yield stress field (PISM ``-yield_stress given``;
    the MISMIP3d friction perturbations). ``tau_c``: an (My, Mx) array
    [Pa], or, left None, ``tauc`` read from
    ``basal_yield_stress.given.file`` onto ``grid``."""

    config: object
    tau_c: object = None
    grid: object = None

    def __post_init__(self):
        if self.tau_c is None:
            path = self.config.get_string("basal_yield_stress.given.file")
            if not path or self.grid is None:
                raise ValueError(
                    "-yield_stress given needs a tau_c array or "
                    "basal_yield_stress.given.file (and a grid)")
            from ..io.bootstrap import read_and_regrid
            self.tau_c = np.nan_to_num(
                read_and_regrid(path, self.grid, ["tauc"])["tauc"])
        self._field = {}

    def compute(self, state: S.ModelState, t=None):
        H = state.geometry.ice_thickness
        key = (H.dtype, H.device)
        if key not in self._field:   # one copy to the device per dtype
            self._field[key] = torch.as_tensor(self.tau_c, dtype=H.dtype,
                                               device=H.device)
        return torch.where(S.ocean(state.geometry.cell_type), 0.0,
                           self._field[key])


def yield_stress_from_config(config, grid=None):
    """The yield stress model ``basal_yield_stress.model`` names."""
    require(config, "basal_yield_stress.model",
            ("constant", "mohr_coulomb", "given"))
    name = config.get_string("basal_yield_stress.model")
    if name == "constant":
        return ConstantYieldStress(config)
    if name == "given":
        return GivenYieldStress(config, grid=grid)
    return MohrCoulombYieldStress(config)


@dataclass(frozen=True)
class SlidingLaw:
    """beta(|u|) for tau_b = -beta u (PISM ``IceBasalResistancePlasticLaw``
    and ``IceBasalResistancePseudoPlasticLaw``)."""

    pseudo_plastic: bool = False
    q: float = 0.25
    u_threshold: float = 100.0 / 3.15569259747e7   # m/s
    plastic_reg: float = 0.01 / 3.15569259747e7    # m/s
    sliding_scale: float = -1.0

    @staticmethod
    def from_config(config) -> "SlidingLaw":
        require(config, "basal_resistance.regularized_coulomb.enabled", (False,))
        return SlidingLaw(
            pseudo_plastic=config.get_flag("basal_resistance.pseudo_plastic.enabled"),
            q=config.get_number("basal_resistance.pseudo_plastic.q"),
            u_threshold=config.get_number(
                "basal_resistance.pseudo_plastic.u_threshold", "m s-1"),
            plastic_reg=config.get_number(
                "basal_resistance.plastic.regularization", "m s-1"),
            sliding_scale=config.get_number(
                "basal_resistance.pseudo_plastic.sliding_scale_factor"),
        )

    def beta(self, tau_c, u, v, reg=None):
        """Drag coefficient; ``reg`` overrides the regularization velocity
        (the solver's continuation warmup starts with a large reg)."""
        r = self.plastic_reg if reg is None else reg
        speed2 = u ** 2 + v ** 2
        if self.pseudo_plastic:
            if self.sliding_scale > 0.0:
                tau_c = tau_c / self.sliding_scale ** self.q
            sp = torch.sqrt(speed2 + r ** 2)
            return tau_c * sp ** (self.q - 1.0) / self.u_threshold ** self.q
        return tau_c / torch.sqrt(speed2 + r ** 2)

    def dbeta_coef(self, tau_c, u, v):
        """c = 2 dbeta/d|u|^2 at (u, v), so that the derivative of beta in
        a direction (du, dv) is c (u du + v dv) (the drag tangent of the
        exact drag Jacobian; the JAX package differentiates ``beta`` with
        autodiff): (q - 1) beta / (|u|^2 + r^2), the plastic law's q = 0
        included; 0 where tau_c is 0."""
        r = self.plastic_reg
        s2 = u ** 2 + v ** 2 + r ** 2
        q = self.q if self.pseudo_plastic else 0.0
        return (q - 1.0) * self.beta(tau_c, u, v) / s2
