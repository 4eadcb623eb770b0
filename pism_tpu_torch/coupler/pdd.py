"""Positive-degree-day (temperature index) surface mass balance (port of
``pism_tpu/coupler/pdd.py``).

The expected positive degree days come from the Calov & Greve (2005)
integral over Gaussian daily variability sigma (``method =
expectation_integral``),

    E[max(T, 0)] = sigma/sqrt(2 pi) exp(-T^2 / (2 sigma^2))
                   + (T/2) erfc(-T / (sqrt(2) sigma)).

The model is stateful (snow and firn bookkeeping depths). ``update``
integrates the budget over [t, t+dt] in sub-intervals whose count follows
dt (``surface.pdd.max_evals_per_year``). In the JAX package that count is
traced from dt and the loop is a ``fori_loop`` (``pism_tpu/coupler/
pdd.py:197-199, 288``); here dt is a host float, so the count and the
balance-year rollover test are host arithmetic in the field dtype and need
no sync. ``members_update`` is the same update for an ensemble's members,
each with its own time, dt and trip count.

sigma is the scalar ``std_dev.value``, the Seguinot (2013) sigma(T)
(``std_dev.param_enabled``), a 2D field (``std_dev.file``) and/or lapsed
with latitude; the degree-day factors are the scalar ones or Fausto et al.
(2009)'s. The Monte-Carlo methods (``random_process``,
``repeatable_random_process``) draw 32 daily temperatures per interval and
cell, each draw from a ``torch.Generator`` seeded with the model's seed and
the draw's slot of absolute model time (86400/32 s), as the JAX package
folds the slot into its key: the same model time sees the same draws, so a
restarted repeatable run draws the same numbers. jax.random's bits are not
reproduced.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..state import dt_divide
from ..util.units import SEC_PER_YEAR
from .atmosphere import AtmosphereModel
from .surface import SurfaceCarry, SurfaceInputs, SurfaceModel


def expected_pdd_rate(T, T_threshold, sigma):
    """Calov-Greve expectation of max(T - T_threshold, 0) [K]; ``sigma`` a
    float or a field."""
    dT = T - T_threshold
    sig = torch.clamp(sigma, min=1e-3) if torch.is_tensor(sigma) \
        else max(sigma, 1e-3)
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
    sigma_field: object = None   # optional 2D air_temp_sd [K]
    #                              (surface.pdd.std_dev.file)
    latitude: object = None      # optional 2D latitude [deg N] (Fausto
    #                              factors, the sigma latitude lapse)
    n_intervals: int = 0   # sub-intervals per update; 0 = from the config

    stateful = True

    #: Monte-Carlo draws per interval and their slot of model time [s]
    DRAWS = 32

    def __post_init__(self):
        cfg = self.config
        self.method = cfg.get_string("surface.pdd.method")
        if self.method not in ("expectation_integral", "random_process",
                               "repeatable_random_process"):
            raise ValueError(f"unknown surface.pdd.method {self.method!r}")
        # random_process seeds from the OS when built (the reference seeds
        # with time(NULL)); the repeatable one with 0
        self._seed = int.from_bytes(os.urandom(4), "little") \
            if self.method == "random_process" else 0
        self.sigma_a = cfg.get_number("surface.pdd.std_dev.param_a")
        self.sigma_b = cfg.get_number("surface.pdd.std_dev.param_b")
        self.sigma_param = cfg.get_flag("surface.pdd.std_dev.param_enabled")
        self.sigma_lat_base = cfg.get_number(
            "surface.pdd.std_dev.lapse_lat_base")
        self.sigma_lat_rate = cfg.get_number(
            "surface.pdd.std_dev.lapse_lat_rate")
        self.fausto = cfg.get_flag("surface.pdd.fausto.enabled")
        if self.fausto:
            day = 86400.0
            self.fausto_T_c = cfg.get_number("surface.pdd.fausto.T_c")
            self.fausto_T_w = cfg.get_number("surface.pdd.fausto.T_w")
            self.fausto_beta = {
                "ice_c": cfg.get_number("surface.pdd.fausto.beta_ice_c") / day,
                "ice_w": cfg.get_number("surface.pdd.fausto.beta_ice_w") / day,
                "snow_c": cfg.get_number("surface.pdd.fausto.beta_snow_c")
                / day,
                "snow_w": cfg.get_number("surface.pdd.fausto.beta_snow_w")
                / day}
            self.fausto_lat_w = cfg.get_number(
                "surface.pdd.fausto.latitude_beta_w")
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

    def _intervals(self, dt: float, f):
        """(N, dt_i): the trip count and the interval length of an update
        of ``dt`` seconds, in the numpy field dtype ``f``, as the JAX package
        forms them from its field-dtype dt (pism_tpu/coupler/pdd.py:197-199):
        a float32 product can land on a whole number where the float64 one
        lies just above it. Numpy scalars of that dtype round as JAX does,
        with no device sync."""
        N_max = self.n_intervals
        evals = 2.0 * N_max   # n_intervals was derived as evals/2
        dt_f = f(dt)
        N = int(min(max(math.ceil(dt_f * f(evals) / f(SEC_PER_YEAR)), 1),
                    N_max))
        return N, dt_f / f(N)

    def _cycle(self, tk: float, dtype) -> float:
        """The seasonal cycle's weight at model time ``tk`` in the field
        dtype."""
        frac = tk / SEC_PER_YEAR - math.floor(tk / SEC_PER_YEAR)
        return _round_to(math.cos(2.0 * math.pi * (frac - self.summer_peak)),
                         dtype)

    def _factors(self, T_mj, dtype):
        """(factor_snow, factor_ice) [m K-1 s-1]: the scalar factors, or
        Fausto's cubic between the cold (T_mj <= T_c) and warm (T_mj >=
        T_w) bands, warm south of ``latitude_beta_w``."""
        if not self.fausto:
            return self.factor_snow, self.factor_ice
        w = torch.clamp((self.fausto_T_w - T_mj)
                        / (self.fausto_T_w - self.fausto_T_c), 0.0, 1.0) ** 3
        fb = self.fausto_beta
        f_ice = fb["ice_w"] + (fb["ice_c"] - fb["ice_w"]) * w
        f_snow = fb["snow_w"] + (fb["snow_c"] - fb["snow_w"]) * w
        if self.latitude is not None:
            south = self.latitude.to(dtype) < self.fausto_lat_w
            f_ice = torch.where(south, fb["ice_w"], f_ice)
            f_snow = torch.where(south, fb["snow_w"], f_snow)
        return f_snow.to(dtype), f_ice.to(dtype)

    def effective_sigma(self, T):
        """The daily variability sigma [K] at air temperature T: the 2D
        field, else the scalar or Seguinot's sigma(T), lapsed with latitude
        north of its base when given a latitude; a float for the plain
        scalar."""
        dtype = T.dtype
        if self.sigma_field is not None:
            return self.sigma_field.to(dtype)
        lat_lapse = self.sigma_lat_rate != 0.0 and self.latitude is not None
        if not self.sigma_param and not lat_lapse:
            return self.sigma
        sigma = torch.tensor(self.sigma, dtype=dtype, device=T.device)
        if self.sigma_param:
            sigma = torch.clamp(self.sigma_a * (T - 273.15) + self.sigma_b,
                                min=1e-3)
        if lat_lapse:
            lat = self.latitude.to(dtype)
            sigma = torch.clamp(sigma + self.sigma_lat_rate * torch.clamp(
                lat - self.sigma_lat_base, min=0.0), min=1e-3)
        return sigma.expand(T.shape)

    def _draw_seeds(self, t0: float, dt_i) -> list:
        """The seeds of one interval's draws: draw s stands for the slice
        [t0 + s dt_i/S, ...) and is keyed on its midpoint's slot of
        86400/S s of absolute model time (the JAX package's fold_in of the
        slot, ``pism_tpu/coupler/pdd.py:583-590``), formed as it forms them
        (``dt_i`` in the field dtype)."""
        S = self.DRAWS
        f = type(dt_i)
        t_s = t0 + (np.arange(S, dtype=np.float64) + 0.5) * float(dt_i / f(S))
        slots = (t_s / (86400.0 / S)).astype(np.int64).astype(np.int32) \
            & 0x7FFFFFFF
        return [(self._seed << 32) | int(s) for s in slots]

    def _random_pdd(self, T, sigma, seeds):
        """The mean of max(T + eps - T_melt, 0) over the draws eps ~
        N(0, sigma), one generator per draw."""
        acc = torch.zeros_like(T)
        for seed in seeds:
            g = torch.Generator(device=T.device).manual_seed(seed)
            eps = torch.randn(T.shape, generator=g, dtype=T.dtype,
                              device=T.device) * sigma
            acc = acc + torch.clamp(T + eps - self.T_melt, min=0.0)
        return acc / len(seeds)

    def _interval(self, atm, cyc, dt_if, snow, firn, seeds=None):
        """One sub-interval's budget from the air temperatures ``atm``, the
        cycle weight and the interval length in the field dtype (``seeds``:
        the Monte-Carlo draws' seeds): (snowfall, melt, refrozen, snow,
        firn) after it."""
        Ta, Tj = atm.temperature, atm.temperature_july
        T = Ta + (Tj - Ta) * cyc
        if self.precip_as_snow:
            sf = torch.ones_like(T)
        else:
            sf = torch.clamp((self.T_all_rain - T)
                             / (self.T_all_rain - self.T_all_snow), 0.0, 1.0)
        snowfall = atm.precipitation * sf * dt_if    # m ice equivalent
        snow = snow + snowfall
        sigma = self.effective_sigma(T)
        if seeds is None:
            pdd = expected_pdd_rate(T, self.T_melt, sigma) * dt_if / 86400.0
        else:
            pdd = self._random_pdd(T, sigma, seeds) * dt_if / 86400.0
        # melt snow, then firn (snow factor), then ice
        f_snow, f_ice = self._factors(Tj, T.dtype)
        snowfirn_cap = f_snow * 86400.0 * pdd
        snow_melt = torch.minimum(snow, snowfirn_cap)
        firn_melt = torch.minimum(firn, snowfirn_cap - snow_melt)
        used = torch.where(snowfirn_cap > 0,
                           (snow_melt + firn_melt)
                           / torch.clamp(snowfirn_cap, min=1e-30), 0.0)
        ice_melt = f_ice * 86400.0 * pdd * (1.0 - used)
        refrozen = self.refreeze * (snow_melt + firn_melt)
        if self.refreeze_ice:
            refrozen = refrozen + self.refreeze * ice_melt
        melt_k = snow_melt + firn_melt + ice_melt
        return snowfall, melt_k, refrozen, snow - snow_melt, firn - firn_melt

    def update(self, geometry, t: float, dt: float, carry: SurfaceCarry):
        H = geometry.ice_thickness
        dtype = H.dtype
        snow = carry.snow if carry.snow is not None else torch.zeros_like(H)
        firn = carry.firn if carry.firn is not None else torch.zeros_like(H)
        f = np.float32 if dtype == torch.float32 else np.float64
        N, dt_i = self._intervals(dt, f)
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
            # balance-year rollover: part of the surviving snow becomes firn
            yr_k = self._balance_year(tk)
            if yr_k > yr:
                firn = firn + self.firn_compaction * snow
                snow = torch.zeros_like(snow)
            yr = yr_k
            seeds = None if self.method == "expectation_integral" \
                else self._draw_seeds(t + float(f(k) * dt_i), dt_i)
            snowfall, melt_k, refrozen, snow, firn = self._interval(
                atm, self._cycle(tk, dtype), dt_if, snow, firn, seeds)
            smb = smb + snowfall - melt_k + refrozen
            melt_a = melt_a + melt_k
            runoff_a = runoff_a + melt_k - refrozen
            acc_a = acc_a + snowfall
        # ice surface temperature: annual mean air temp, capped at melting
        T_surf = torch.clamp(self.atmosphere(geometry, t).temperature,
                             max=273.15)
        return (SurfaceInputs(smb=smb / dt, temperature=T_surf,
                              melt=melt_a / dt, runoff=runoff_a / dt,
                              accumulation=acc_a / dt),
                SurfaceCarry(snow=snow, firn=firn, albedo=carry.albedo))

    def members_update(self, geometry, t, dt, carry: SurfaceCarry):
        """``update`` for an ensemble's members in lockstep: ``geometry``
        and ``carry`` with a leading member axis, ``t`` and ``dt`` host
        lists of the members' model times and steps (dt in the field
        dtype). Each member takes its own trip count, interval times,
        balance years and snow -> firn rollovers, formed on the host as
        ``update`` forms them and copied to the device once; the loop runs
        the most intervals any member takes, and a member past its own count
        keeps its accumulators (the JAX package's ``fori_loop`` under
        ``vmap``, ``pism_tpu/coupler/pdd.py:288``)."""
        if self.method != "expectation_integral":
            raise NotImplementedError(
                f"surface.pdd.method = {self.method!r} on an ensemble's "
                "member axis is not implemented in pism_tpu_torch (ROADMAP "
                "Queue 1 item 3)")
        H = geometry.ice_thickness
        dtype = H.dtype
        snow = carry.snow if carry.snow is not None else torch.zeros_like(H)
        firn = carry.firn if carry.firn is not None else torch.zeros_like(H)
        f = np.float32 if dtype == torch.float32 else np.float64
        runs = [self._intervals(d, f) for d in dt]
        n_max = max(N for N, _ in runs)
        # per interval and member: the time, the cycle weight, the interval
        # length, the rollover and whether the member takes the interval
        tk = [[t_b + float(f(k + 0.5) * dt_i) for t_b, (_, dt_i)
               in zip(t, runs)] for k in range(n_max)]
        yr = [self._balance_year(t_b - float(f(1e-3) * dt_i))
              for t_b, (_, dt_i) in zip(t, runs)]
        rows = []
        for k in range(n_max):
            yr_k = [self._balance_year(x) for x in tk[k]]
            rows.append([[self._cycle(x, dtype) for x in tk[k]],
                         [float(dt_i) for _, dt_i in runs],
                         [float(a > b) for a, b in zip(yr_k, yr)],
                         [float(k < N) for N, _ in runs]])
            yr = yr_k
        host = torch.tensor(rows, dtype=torch.float64).to(H.device)
        cyc, dt_i, rolled, on = (x.view(n_max, -1, 1, 1)
                                 for x in host.unbind(1))
        cyc, dt_i = cyc.to(dtype), dt_i.to(dtype)

        smb = torch.zeros_like(H)
        melt_a = torch.zeros_like(H)
        runoff_a = torch.zeros_like(H)
        acc_a = torch.zeros_like(H)
        for k in range(n_max):
            atm = self.atmosphere.members(geometry, tk[k])
            roll = rolled[k] > 0.0
            firn_k = torch.where(roll, firn + self.firn_compaction * snow, firn)
            snow_k = torch.where(roll, 0.0, snow)
            snowfall, melt_k, refrozen, snow_k, firn_k = self._interval(
                atm, cyc[k], dt_i[k], snow_k, firn_k)
            new = (smb + snowfall - melt_k + refrozen, melt_a + melt_k,
                   runoff_a + melt_k - refrozen, acc_a + snowfall, snow_k,
                   firn_k)
            old = (smb, melt_a, runoff_a, acc_a, snow, firn)
            take = on[k] > 0.0
            smb, melt_a, runoff_a, acc_a, snow, firn = (
                torch.where(take, a, b) for a, b in zip(new, old))
        T_surf = torch.clamp(self.atmosphere.members(geometry, t).temperature,
                             max=273.15)
        dt_d = torch.tensor(dt, dtype=dtype).to(H.device).view(-1, 1, 1)
        return (SurfaceInputs(smb=dt_divide(smb, dt_d), temperature=T_surf,
                              melt=dt_divide(melt_a, dt_d),
                              runoff=dt_divide(runoff_a, dt_d),
                              accumulation=dt_divide(acc_a, dt_d)),
                SurfaceCarry(snow=snow, firn=firn, albedo=carry.albedo))

    def __call__(self, geometry, t) -> SurfaceInputs:
        """Stateless annual-expectation climatology (bootstrapping)."""
        t0 = (math.floor(t / SEC_PER_YEAR) + self.balance_year_start) \
            * SEC_PER_YEAR
        out, _ = self.update(geometry, t0, SEC_PER_YEAR, SurfaceCarry())
        return out
