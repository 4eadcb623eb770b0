"""Positive-degree-day (temperature index) surface mass balance (port of
``pism_tpu/coupler/pdd.py``, ``method = expectation_integral``).

The expected positive degree days come from the Calov & Greve (2005)
integral over Gaussian daily variability sigma,

    E[max(T, 0)] = sigma/sqrt(2 pi) exp(-T^2 / (2 sigma^2))
                   + (T/2) erfc(-T / (sqrt(2) sigma)).

The model is stateful (snow and firn bookkeeping depths). ``update``
integrates the budget over [t, t+dt] in sub-intervals whose count follows
dt (``surface.pdd.max_evals_per_year``). In the JAX package that count is
traced from dt and the loop is a ``fori_loop`` (``pism_tpu/coupler/
pdd.py:197-199, 288``); here dt is a host float, so the count and the
balance-year rollover test are host arithmetic in the field dtype and need
no sync.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..config import require
from ..util.units import SEC_PER_YEAR
from .atmosphere import AtmosphereModel
from .surface import SurfaceCarry, SurfaceInputs, SurfaceModel


def expected_pdd_rate(T, T_threshold, sigma: float):
    """Calov-Greve expectation of max(T - T_threshold, 0) [K]."""
    dT = T - T_threshold
    sig = max(sigma, 1e-3)
    z = dT / (math.sqrt(2.0) * sig)
    return (sig / math.sqrt(2.0 * math.pi) * torch.exp(-z ** 2)
            + 0.5 * dT * torch.special.erfc(-z))


def _round_to(x: float, dtype) -> float:
    """A host float rounded to a tensor dtype (f32 fields see f32 scalars,
    as under JAX's casts)."""
    return torch.tensor(x, dtype=dtype).item()


@dataclass
class TemperatureIndex(SurfaceModel):
    """PDD surface model (PISM ``-surface pdd``)."""

    atmosphere: AtmosphereModel
    config: object = None
    n_intervals: int = 0   # sub-intervals per update; 0 = from the config

    stateful = True

    def __post_init__(self):
        cfg = self.config
        require(cfg, "surface.pdd.method", ("expectation_integral",))
        require(cfg, "surface.pdd.fausto.enabled", (False,))
        require(cfg, "surface.pdd.std_dev.param_enabled", (False,))
        require(cfg, "surface.pdd.std_dev.file", ("",))
        # the JAX model ramps sigma with latitude when given one
        require(cfg, "surface.pdd.std_dev.lapse_lat_rate", (0.0,))
        self.factor_snow = cfg.get_number("surface.pdd.factor_snow", "m K-1 s-1")
        self.factor_ice = cfg.get_number("surface.pdd.factor_ice", "m K-1 s-1")
        self.refreeze = cfg.get_number("surface.pdd.refreeze")
        self.refreeze_ice = cfg.get_flag("surface.pdd.refreeze_ice_melt")
        self.sigma = cfg.get_number("surface.pdd.std_dev.value")
        self.T_melt = cfg.get_number("surface.pdd.positive_threshold_temp")
        self.T_all_snow = cfg.get_number("surface.pdd.air_temp_all_precip_as_snow")
        self.T_all_rain = cfg.get_number("surface.pdd.air_temp_all_precip_as_rain")
        self.balance_year_start = cfg.get_number(
            "surface.pdd.balance_year_start_day") / 365.0  # year fraction
        if self.n_intervals <= 0:
            evals = cfg.get_number("surface.pdd.max_evals_per_year") \
                if cfg.is_set("surface.pdd.max_evals_per_year") \
                or not cfg.is_set("climate_forcing.evaluations_per_year") \
                else cfg.get_number("climate_forcing.evaluations_per_year")
            self.n_intervals = max(4, int(round(evals / 2.0)))
        self.precip_as_snow = cfg.get_flag(
            "surface.pdd.interpret_precip_as_snow")
        self.firn_compaction = cfg.get_number(
            "surface.pdd.firn_compaction_to_accumulation_ratio")
        self.summer_peak = cfg.get_number(
            "atmosphere.fausto_air_temp.summer_peak_day") / 365.0

    def max_timestep(self, t) -> float:
        # keep the yearly cycle resolved by the fixed sub-interval count
        return SEC_PER_YEAR

    def _balance_year(self, tk: float) -> float:
        return math.floor(tk / SEC_PER_YEAR - self.balance_year_start)

    def update(self, geometry, t: float, dt: float, carry: SurfaceCarry):
        H = geometry.ice_thickness
        dtype = H.dtype
        snow = carry.snow if carry.snow is not None else torch.zeros_like(H)
        firn = carry.firn if carry.firn is not None else torch.zeros_like(H)
        N_max = self.n_intervals
        evals = 2.0 * N_max   # n_intervals was derived as evals/2
        # the count and the interval length in the field dtype, as the JAX
        # package forms them from its field-dtype dt (pism_tpu/coupler/
        # pdd.py:197-199): a float32 product can land on a whole number
        # where the float64 one lies just above it. Numpy scalars of that
        # dtype round as JAX does, with no device sync.
        f = np.float32 if dtype == torch.float32 else np.float64
        dt_f = f(dt)
        N = int(min(max(math.ceil(dt_f * f(evals) / f(SEC_PER_YEAR)), 1),
                    N_max))
        dt_i = dt_f / f(N)
        dt_if = float(dt_i)

        smb = torch.zeros_like(H)
        melt_a = torch.zeros_like(H)
        runoff_a = torch.zeros_like(H)
        acc_a = torch.zeros_like(H)
        # balance year just before the step start, so a rollover landing
        # exactly on a step boundary promotes snow -> firn in this step
        yr = self._balance_year(t - float(f(1e-3) * dt_i))
        for k in range(N):
            # the offset in the field dtype, the model time float64 (JAX's
            # promotion of a float64 clock plus a field-dtype product)
            tk = t + float(f(k + 0.5) * dt_i)
            atm = self.atmosphere(geometry, tk)
            Ta, Tj = atm.temperature, atm.temperature_july
            frac = tk / SEC_PER_YEAR - math.floor(tk / SEC_PER_YEAR)
            cyc = _round_to(math.cos(2.0 * math.pi * (frac - self.summer_peak)),
                            dtype)
            T = Ta + (Tj - Ta) * cyc
            # balance-year rollover: part of the surviving snow becomes firn
            yr_k = self._balance_year(tk)
            if yr_k > yr:
                firn = firn + self.firn_compaction * snow
                snow = torch.zeros_like(snow)
            yr = yr_k
            if self.precip_as_snow:
                sf = torch.ones_like(T)
            else:
                sf = torch.clamp((self.T_all_rain - T)
                                 / (self.T_all_rain - self.T_all_snow), 0.0, 1.0)
            snowfall = atm.precipitation * sf * dt_if    # m ice equivalent
            snow = snow + snowfall
            pdd = expected_pdd_rate(T, self.T_melt, self.sigma) * dt_if / 86400.0
            # melt snow, then firn (snow factor), then ice
            snowfirn_cap = self.factor_snow * 86400.0 * pdd
            snow_melt = torch.minimum(snow, snowfirn_cap)
            firn_melt = torch.minimum(firn, snowfirn_cap - snow_melt)
            used = torch.where(snowfirn_cap > 0,
                               (snow_melt + firn_melt)
                               / torch.clamp(snowfirn_cap, min=1e-30), 0.0)
            ice_melt = self.factor_ice * 86400.0 * pdd * (1.0 - used)
            refrozen = self.refreeze * (snow_melt + firn_melt)
            if self.refreeze_ice:
                refrozen = refrozen + self.refreeze * ice_melt
            melt_k = snow_melt + firn_melt + ice_melt
            smb = smb + snowfall - melt_k + refrozen
            melt_a = melt_a + melt_k
            runoff_a = runoff_a + melt_k - refrozen
            acc_a = acc_a + snowfall
            snow = snow - snow_melt
            firn = firn - firn_melt
        # ice surface temperature: annual mean air temp, capped at melting
        T_surf = torch.clamp(self.atmosphere(geometry, t).temperature,
                             max=273.15)
        return (SurfaceInputs(smb=smb / dt, temperature=T_surf,
                              melt=melt_a / dt, runoff=runoff_a / dt,
                              accumulation=acc_a / dt),
                SurfaceCarry(snow=snow, firn=firn, albedo=carry.albedo))

    def __call__(self, geometry, t) -> SurfaceInputs:
        """Stateless annual-expectation climatology (bootstrapping)."""
        t0 = (math.floor(t / SEC_PER_YEAR) + self.balance_year_start) \
            * SEC_PER_YEAR
        out, _ = self.update(geometry, t0, SEC_PER_YEAR, SurfaceCarry())
        return out
