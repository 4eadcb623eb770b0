"""Ocean boundary models (port of ``pism_tpu/coupler/ocean.py``:
``OceanInputs``, the ``OceanModel`` base, ``Constant``, ``PIK``, ``GivenTH``,
``Given`` and the modifiers ``Anomaly``, ``DeltaT``, ``DeltaSMB``,
``FracSMB``, ``RunoffSMB``, ``FracMBP``, ``DeltaMBP`` and ``Cache``; PICO is
``pico.py``): the sub-shelf melt rate [m/s ice equivalent, + = melt], the
shelf-base temperature [K] and, raised by the melange back-pressure
modifiers, the calving front's average water-column pressure [Pa].

A time stack's record and weight are found on the host in float64, the
weight rounded to the field dtype (``util.forcing``)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..util.forcing import constant_slice, linear_slice


class OceanInputs(NamedTuple):
    shelf_base_melt: torch.Tensor         # m/s ice equivalent (+ = melt)
    shelf_base_temperature: torch.Tensor  # K at the ice-shelf base


class OceanModel:
    def __call__(self, geometry, t):
        """The melt rate only (what ``IceModel`` consumes); ``inputs``
        gives both fields."""
        return self.inputs(geometry, t).shelf_base_melt

    def inputs(self, geometry, t) -> OceanInputs:
        raise NotImplementedError

    def members(self, geometry, t):
        """The melt rate under an ensemble's members: ``geometry`` with a
        leading member axis, ``t`` their model times. Models that have no
        member form raise."""
        raise NotImplementedError(
            f"the ocean model {type(self).__name__} on an ensemble's member "
            "axis is not implemented in pism_tpu_torch (supported: Constant, "
            "PIK, Pico, DeltaT over them)")

    def water_column_pressure(self, geometry, t):
        """The average water-column pressure over the submerged front face
        [Pa], or None for the hydrostatic default (PISM
        ``ocean::Ocean::average_water_column_pressure``; the melange
        back-pressure modifiers raise it)."""
        inner = getattr(self, "inner", None)
        if inner is not None:
            return inner.water_column_pressure(geometry, t)
        return None

    @staticmethod
    def _draft(geometry):
        """Ice draft (depth of the shelf base below sea level), >= 0."""
        return torch.clamp(geometry.sea_level - (geometry.ice_surface_elevation
                                                 - geometry.ice_thickness),
                           min=0.0)


@dataclass
class Constant(OceanModel):
    """PISM ``-ocean constant``: melt from a constant heat flux into the
    shelf base (or a prescribed rate)."""

    config: object = None
    melt_rate: Optional[float] = None   # m/s ice equivalent; overrides flux

    def __post_init__(self):
        cfg = self.config
        self.rho_i = cfg.get_number("constants.ice.density")
        self.L = cfg.get_number("constants.fresh_water.latent_heat_of_fusion")
        self.heat_flux = cfg.get_number("ocean.sub_shelf_heat_flux_into_ice")
        if self.melt_rate is None:
            self.melt_rate = cfg.get_number("ocean.constant.melt_rate", "m s-1")

    def _melt(self, H):
        return torch.full_like(H, self.melt_rate
                               + self.heat_flux / (self.rho_i * self.L))

    def members(self, geometry, t):
        """Constant in time: one evaluation on the members' geometry."""
        return self(geometry, None)

    def inputs(self, geometry, t) -> OceanInputs:
        H = geometry.ice_thickness
        # pressure-melting temperature at the shelf base
        T = 273.15 - 7.9e-8 * (self.rho_i * 9.81 * torch.clamp(H, min=0.0))
        return OceanInputs(self._melt(H), T)


@dataclass
class PIK(OceanModel):
    """PISM ``-ocean pik`` (Martin et al. 2011): melt proportional to the
    pressure-melting-point depression at the shelf draft."""

    config: object = None

    def __post_init__(self):
        cfg = self.config
        self.rho_i = cfg.get_number("constants.ice.density")
        self.rho_w = cfg.get_number("constants.sea_water.density")
        self.c_w = cfg.get_number("constants.sea_water.specific_heat_capacity")
        self.L = cfg.get_number("constants.fresh_water.latent_heat_of_fusion")
        self.melt_factor = cfg.get_number("ocean.pik_melt_factor")
        self.S_ocean = cfg.get_number("constants.sea_water.salinity")
        self.T_ocean = 271.15  # PISM: -2 degC ambient

    def inputs(self, geometry, t) -> OceanInputs:
        draft = self._draft(geometry)
        # potential temperature above the in-situ freezing point at the
        # draft (Beckmann-Goosse freezing point)
        T_f = 273.15 - 0.0575 * self.S_ocean + 0.0832e-2 \
            - 7.64e-4 * draft
        dT = torch.clamp(self.T_ocean - T_f, min=0.0)
        gamma_T = 1e-4
        melt = (self.melt_factor * self.rho_w * self.c_w * gamma_T
                / (self.rho_i * self.L)) * dT
        return OceanInputs(melt, T_f)

    def members(self, geometry, t):
        """Pointwise and constant in time: one evaluation on the members'
        geometry."""
        return self(geometry, None)


@dataclass
class GivenTH(OceanModel):
    """PISM ``-ocean th``: the Holland & Jenkins (1999) three-equation
    sub-shelf melt from the ambient potential temperature and salinity
    (fields, or stacks with ``times``, piecewise-linear), the liquidus, heat
    and salt balances reduced to one quadratic in the interface salinity,
    solved per cell in the product form (stable where it cancels, near
    freeze-on); ``ocean.th.two_equation`` drops the salt balance."""

    theta_ocean: torch.Tensor      # K, ambient potential temperature
    salinity_ocean: torch.Tensor   # g/kg
    config: object = None
    times: Optional[np.ndarray] = None    # (Nt,) [s], sorted
    period: float = 0.0                   # [s]; > 0 cycles the series

    #: Holland & Jenkins liquidus: T_f = a S + b + c z  (z < 0 below sl)
    LIQ_A = -0.0575
    LIQ_B = 273.15 + 0.0832e-2
    LIQ_C = 7.53e-4  # K/m, applied to z (negative below sea level)

    def __post_init__(self):
        cfg = self.config
        self.rho_i = cfg.get_number("constants.ice.density")
        self.rho_w = cfg.get_number("constants.sea_water.density")
        self.c_w = cfg.get_number("constants.sea_water.specific_heat_capacity")
        self.c_i = cfg.get_number("constants.ice.specific_heat_capacity")
        self.L = cfg.get_number("constants.fresh_water.latent_heat_of_fusion")
        self.gamma_T = cfg.get_number("ocean.th.gamma_T")
        self.gamma_S = cfg.get_number("ocean.th.gamma_S")
        self.T_ice = cfg.get_number("ocean.th.ice_temperature")
        self.two_eq = cfg.get_flag("ocean.th.two_equation")
        self.clip_salinity = cfg.get_flag("ocean.th.clip_salinity")

    def inputs(self, geometry, t) -> OceanInputs:
        draft = self._draft(geometry)
        dtype = geometry.ice_thickness.dtype
        S_o = linear_slice(self.salinity_ocean, self.times, self.period, t,
                           dtype)
        theta = linear_slice(self.theta_ocean, self.times, self.period, t,
                             dtype)
        a, b = self.LIQ_A, self.LIQ_B
        Tz = b - self.LIQ_C * draft          # liquidus at S = 0, z = -draft
        cw_gT = self.c_w * self.gamma_T
        gS = self.gamma_S
        if self.two_eq:
            T_b = a * S_o + Tz
            dT = torch.clamp(theta - T_b, min=0.0)
            melt = (self.rho_w * cw_gT / (self.rho_i * self.L)) * dT
            return OceanInputs(melt, T_b)
        # A S_b^2 + B S_b + C = 0 from eliminating m and T_b
        Li = self.L + self.c_i * (Tz - self.T_ice)
        A = a * (gS * self.c_i - cw_gT)
        Bq = cw_gT * (theta - Tz) + gS * Li - gS * S_o * self.c_i * a
        C = -gS * S_o * Li
        disc = torch.sqrt(torch.clamp(Bq * Bq - 4.0 * A * C, min=0.0))
        # the root with S_b > 0 ((-B + disc) / 2A, A < 0) in product form
        S_b = (2.0 * C) / (-Bq - disc)
        if self.clip_salinity:
            S_b = torch.clamp(S_b, min=1.0)
            S_b = torch.minimum(S_b, 2.0 * torch.clamp(S_o, min=1.0))
        T_b = a * S_b + Tz
        melt = (self.rho_w * gS / self.rho_i) * (S_o - S_b) \
            / torch.clamp(S_b, min=1.0)
        return OceanInputs(melt, T_b)


@dataclass
class Given(OceanModel):
    """PISM ``-ocean given``: prescribed sub-shelf melt rate and
    temperature (fields, or stacks with ``times``, piecewise-constant)."""

    melt_rate: torch.Tensor                    # m/s ice equivalent
    temperature: Optional[torch.Tensor] = None  # K
    times: Optional[np.ndarray] = None          # (Nt,) [s], sorted
    period: float = 0.0                         # [s]; > 0 cycles the series

    def inputs(self, geometry, t) -> OceanInputs:
        dtype = geometry.ice_thickness.dtype
        melt = constant_slice(self.melt_rate, self.times, self.period, t,
                              dtype)
        if self.temperature is not None:
            T = constant_slice(self.temperature, self.times, self.period, t,
                               dtype)
        else:
            T = torch.full_like(geometry.ice_thickness, 271.15)
        return OceanInputs(melt, T)


@dataclass
class Anomaly(OceanModel):
    """PISM ``-ocean ...,anomaly``: a melt anomaly field (or stack with
    ``times``, piecewise-constant) added to the inner model's melt."""

    inner: OceanModel
    anomaly: torch.Tensor  # m/s
    times: Optional[np.ndarray] = None
    period: float = 0.0

    def inputs(self, geometry, t) -> OceanInputs:
        o = self.inner.inputs(geometry, t)
        a = self.anomaly
        if self.times is not None and a.ndim == 3:
            a = constant_slice(a, self.times, self.period, t, a.dtype)
        return OceanInputs(o.shelf_base_melt + a, o.shelf_base_temperature)


@dataclass
class DeltaT(OceanModel):
    """PISM ``-ocean ...,delta_T``: a scalar offset ``offset(t)`` [K] (a
    host callable of model time) on the inner model's shelf-base
    temperature, and ``melt_sensitivity`` [m/s per K] times it on the melt
    (the factory leaves it at 0, so the melt passes through)."""

    inner: OceanModel
    offset: Callable                  # t -> K
    melt_sensitivity: float = 0.0     # m/s per K of warming

    def members(self, geometry, t):
        """The melt of the inner model's member form (with no melt
        sensitivity)."""
        if self.melt_sensitivity != 0.0:
            return super().members(geometry, t)
        return self.inner.members(geometry, t)

    def inputs(self, geometry, t) -> OceanInputs:
        o = self.inner.inputs(geometry, t)
        dT = self.offset(t)
        melt = o.shelf_base_melt
        if self.melt_sensitivity != 0.0:
            melt = melt + self.melt_sensitivity * dT
        return OceanInputs(melt, o.shelf_base_temperature + dT)


@dataclass
class DeltaSMB(OceanModel):
    """PISM ``-ocean ...,delta_SMB``: a scalar series added to the
    sub-shelf mass flux."""

    inner: OceanModel
    offset: Callable                  # t -> m/s ice equivalent

    def inputs(self, geometry, t) -> OceanInputs:
        o = self.inner.inputs(geometry, t)
        return OceanInputs(o.shelf_base_melt + self.offset(t),
                           o.shelf_base_temperature)


@dataclass
class FracSMB(OceanModel):
    """PISM ``-ocean ...,frac_SMB``: the sub-shelf mass flux times a scalar
    series."""

    inner: OceanModel
    fraction: Callable                # t -> dimensionless

    def inputs(self, geometry, t) -> OceanInputs:
        o = self.inner.inputs(geometry, t)
        return OceanInputs(o.shelf_base_melt * self.fraction(t),
                           o.shelf_base_temperature)


@dataclass
class RunoffSMB(OceanModel):
    """PISM ``-ocean ...,runoff_SMB``: the sub-shelf melt scaled with the
    runoff change of an air-temperature anomaly dT(t) (Xu et al. 2013):
    melt (1 + B Q^alpha dT^beta), Q = a dT."""

    inner: OceanModel
    delta_T: Callable                 # t -> K air-temperature anomaly
    temp_to_runoff_a: float = 0.1
    melt_factor_B: float = 1.0
    alpha: float = 0.54
    beta: float = 1.17

    def inputs(self, geometry, t) -> OceanInputs:
        o = self.inner.inputs(geometry, t)
        dT = max(self.delta_T(t), 0.0)
        Q = self.temp_to_runoff_a * dT
        factor = 1.0 + self.melt_factor_B * Q ** self.alpha * dT ** self.beta
        return OceanInputs(o.shelf_base_melt * factor,
                           o.shelf_base_temperature)


def hydrostatic_water_column_pressure(geometry, g=9.81, rho_i=910.0,
                                      rho_w=1028.0):
    """The default average water-column pressure over the submerged part of
    a calving front [Pa], (1/2) rho_w g d^2 / H."""
    H = geometry.ice_thickness
    d = torch.minimum(torch.clamp(geometry.sea_level
                                  - geometry.bed_elevation, min=0.0),
                      (rho_i / rho_w) * H)
    return 0.5 * g * rho_w * d ** 2 / torch.clamp(H, min=1.0)


@dataclass
class FracMBP(OceanModel):
    """PISM ``-ocean ...,frac_MBP``: melange back pressure as a fraction
    lambda(t) of the maximum support, the front's water-column pressure
    raised to (1 - lambda) P_water + lambda P_ice_avg."""

    inner: OceanModel
    fraction: Callable                # t -> lambda in [0, 1]
    g: float = 9.81
    rho_i: float = 910.0
    rho_w: float = 1028.0

    def inputs(self, geometry, t) -> OceanInputs:
        return self.inner.inputs(geometry, t)

    def water_column_pressure(self, geometry, t):
        Pw = self.inner.water_column_pressure(geometry, t)
        if Pw is None:
            Pw = hydrostatic_water_column_pressure(geometry, self.g,
                                                   self.rho_i, self.rho_w)
        lam = min(max(self.fraction(t), 0.0), 1.0)
        P_ice = 0.5 * self.g * self.rho_i * geometry.ice_thickness
        return (1.0 - lam) * Pw + lam * P_ice


@dataclass
class DeltaMBP(OceanModel):
    """PISM ``-ocean ...,delta_MBP``: a scalar melange back pressure [Pa]
    added to the front's water-column pressure."""

    inner: OceanModel
    offset: Callable                  # t -> Pa
    g: float = 9.81
    rho_i: float = 910.0
    rho_w: float = 1028.0

    def inputs(self, geometry, t) -> OceanInputs:
        return self.inner.inputs(geometry, t)

    def water_column_pressure(self, geometry, t):
        Pw = self.inner.water_column_pressure(geometry, t)
        if Pw is None:
            Pw = hydrostatic_water_column_pressure(geometry, self.g,
                                                   self.rho_i, self.rho_w)
        return Pw + self.offset(t)


@dataclass
class Cache(OceanModel):
    """PISM ``-ocean ...,cache``: the inner model on a clock quantized to
    ``update_interval`` (its forcing held for an interval); the inner model
    sees the current geometry."""

    inner: OceanModel
    update_interval: float            # seconds

    def inputs(self, geometry, t) -> OceanInputs:
        tq = math.floor(t / self.update_interval) * self.update_interval
        return self.inner.inputs(geometry, tq)
