"""dEBM-simple surface mass balance (port of ``pism_tpu/coupler/debm.py``;
PISM ``surface::DEBMSimple``, Krebs-Kanzow et al. 2018, Zeitz et al. 2021):
insolation- and temperature-driven melt,

    M = (h_phi / pi) / (rho_w L_m) [ tau_A(z) (1 - albedo) S_mean
                                     + c1 T_eff + c2 ]        if T > T_min,

with the melt-albedo feedback albedo = clip(albedo_max + slope rho_i M,
albedo_min, albedo_max) carried as model state (``SurfaceCarry.albedo``,
the ``albedo`` variable of a state file). The orbit is the present-day
expansion or the Berger (1978) paleo form, optionally from a series.

``update`` integrates [t, t+dt] in N = ``max_evals_per_year / 2``
sub-intervals, the JAX package's ``fori_loop`` unrolled on the host: the
interval length and offsets are formed in the field dtype and added to the
float64 clock, the balance years, cycle weights and the orbit's
declination and distance factor are host arithmetic (float64, rounded to
the field dtype), so an update launches only field ops and no device sync.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import state as S
from ..util.units import SEC_PER_YEAR
from .atmosphere import AtmosphereModel
from .pdd import _round_to, expected_pdd_rate
from .surface import SurfaceCarry, SurfaceInputs, SurfaceModel

#: spring (March) equinox as a day number, shared by both orbital modes
EQUINOX_DAY = 80.0


# ---------------------------------------------------------------------------
# Orbital geometry (angles in radians; floats or numpy arrays, float64 on
# the host)
# ---------------------------------------------------------------------------

def solar_declination_present_day(year_fraction):
    """Solar declination [rad] from the year fraction (0 = Jan 1); Liou
    (2002) / Spencer (1971) trigonometric expansion."""
    t = 2.0 * np.pi * year_fraction
    return (0.006918
            - 0.399912 * np.cos(t) + 0.070257 * np.sin(t)
            - 0.006758 * np.cos(2 * t) + 0.000907 * np.sin(2 * t)
            - 0.002697 * np.cos(3 * t) + 0.001480 * np.sin(3 * t))


def distance_factor_present_day(year_fraction):
    """(d_mean/d)^2, the sun-earth inverse-square factor."""
    t = 2.0 * np.pi * year_fraction
    return (1.000110
            + 0.034221 * np.cos(t) + 0.001280 * np.sin(t)
            + 0.000719 * np.cos(2 * t) + 0.000077 * np.sin(2 * t))


def solar_longitude(year_fraction, eccentricity, perihelion_longitude):
    """True solar longitude [rad] from the spring equinox (Berger 1978's
    equation-of-center expansion of the mean longitude)."""
    e = eccentricity
    w = perihelion_longitude + np.pi
    beta = np.sqrt(1.0 - e * e)
    lambda_m = (-2.0 * ((e / 2.0 + e ** 3 / 8.0) * (1.0 + beta) * np.sin(-w)
                        - e * e / 4.0 * (0.5 + beta) * np.sin(-2.0 * w)
                        + e ** 3 / 8.0 * (1.0 / 3.0 + beta) * np.sin(-3.0 * w))
                + 2.0 * np.pi * (year_fraction - EQUINOX_DAY / 365.0))
    return (lambda_m
            + (2.0 * e - e ** 3 / 4.0) * np.sin(lambda_m - w)
            + 5.0 / 4.0 * e * e * np.sin(2.0 * (lambda_m - w))
            + 13.0 / 12.0 * e ** 3 * np.sin(3.0 * (lambda_m - w)))


def solar_declination_paleo(year_fraction, eccentricity, obliquity,
                            perihelion_longitude):
    """sin(declination) = sin(obliquity) sin(solar longitude)."""
    lam = solar_longitude(year_fraction, eccentricity, perihelion_longitude)
    return np.arcsin(np.sin(obliquity) * np.sin(lam))


def distance_factor_paleo(year_fraction, eccentricity, perihelion_longitude):
    """((1 + e cos(nu)) / (1 - e^2))^2, nu the true anomaly."""
    e = eccentricity
    lam = solar_longitude(year_fraction, e, perihelion_longitude)
    return ((1.0 + e * np.cos(lam - (perihelion_longitude + np.pi)))
            / (1.0 - e * e)) ** 2


def hour_angle(phi, latitude, declination):
    """Hour angle [rad] at which the sun reaches the elevation ``phi``: 0
    when it never does, pi when it never drops below it. ``latitude`` a
    tensor; ``phi`` and ``declination`` floats."""
    cos_h = ((math.sin(phi) - torch.sin(latitude) * math.sin(declination))
             / torch.clamp(torch.cos(latitude) * math.cos(declination),
                           min=1e-12))
    return torch.arccos(torch.clamp(cos_h, -1.0, 1.0))


def insolation(solar_constant, distance_factor, h_phi, latitude, declination):
    """Mean top-of-atmosphere insolation [W m-2] during the melt period
    (Krebs-Kanzow et al. 2018 eq. 2)."""
    h = torch.clamp(h_phi, min=1e-9)
    mean = (h * torch.sin(latitude) * math.sin(declination)
            + torch.cos(latitude) * math.cos(declination) * torch.sin(h)) / h
    return torch.where(h_phi > 0.0, solar_constant * distance_factor * mean,
                       0.0)


# ---------------------------------------------------------------------------
# The surface model
# ---------------------------------------------------------------------------

@dataclass
class DEBMSimple(SurfaceModel):
    """dEBM-simple surface model (PISM ``-surface debm_simple``).

    ``latitude`` in degrees north; ``albedo_field`` (optional) prescribes
    the albedo (``surface.debm_simple.albedo_input.file``);
    ``paleo_series`` (optional) a ``(times, eccentricity, obliquity,
    perihelion_longitude)`` tuple of 1D arrays (radians) of a time-dependent
    orbit (``surface.debm_simple.paleo.file``)."""

    atmosphere: AtmosphereModel
    latitude: torch.Tensor           # degrees N
    config: object = None
    albedo_field: object = None      # optional prescribed albedo (2D)
    paleo_series: object = None      # optional (t, ecc, obl, peri) arrays
    n_intervals: int = 0             # sub-intervals per update; 0 =
    #                                  surface.debm_simple.max_evals_per_year/2

    stateful = True
    uses_albedo = True

    def __post_init__(self):
        cfg = self.config
        g = cfg.get_number
        if self.n_intervals <= 0:
            self.n_intervals = max(int(g(
                "surface.debm_simple.max_evals_per_year")) // 2, 2)
        deg = math.pi / 180.0
        self.albedo_max = g("surface.debm_simple.albedo_max")
        self.albedo_min = g("surface.debm_simple.albedo_min")
        self.albedo_slope = g("surface.debm_simple.albedo_slope")  # m2 s kg-1
        self.albedo_ocean = g("surface.debm_simple.albedo_ocean")
        self.c1 = g("surface.debm_simple.c1")                      # W m-2 K-1
        self.c2 = g("surface.debm_simple.c2")                      # W m-2
        self.T_melt_min = g("surface.debm_simple.melting_threshold_temp")
        self.T_pos = g("surface.debm_simple.positive_threshold_temp")
        self.phi = g("surface.debm_simple.phi") * deg
        self.S0 = g("surface.debm_simple.solar_constant")          # W m-2
        self.sigma = g("surface.debm_simple.std_dev")
        self.sigma_a = g("surface.debm_simple.std_dev.param_a")
        self.sigma_b = g("surface.debm_simple.std_dev.param_b")
        self.sigma_param = cfg.get_flag(
            "surface.debm_simple.std_dev.param_enabled")
        self.tau_a0 = g("surface.debm_simple.tau_a_intercept")
        self.tau_az = g("surface.debm_simple.tau_a_slope")         # m-1
        self.paleo = cfg.get_flag("surface.debm_simple.paleo.enabled")
        self.ecc = g("surface.debm_simple.paleo.eccentricity")
        self.obl = g("surface.debm_simple.paleo.obliquity") * deg
        self.peri = g("surface.debm_simple.paleo.perihelion_longitude") * deg
        self.refreeze = g("surface.debm_simple.refreeze")
        self.refreeze_ice = cfg.get_flag(
            "surface.debm_simple.refreeze_ice_melt")
        self.precip_as_snow = cfg.get_flag(
            "surface.debm_simple.interpret_precip_as_snow")
        self.T_all_snow = g("surface.debm_simple.air_temp_all_precip_as_snow")
        self.T_all_rain = g("surface.debm_simple.air_temp_all_precip_as_rain")
        self.balance_year_start = g(
            "surface.pdd.balance_year_start_day") / 365.0
        self.rho_i = g("constants.ice.density")
        self.rho_w = g("constants.fresh_water.density")
        self.L_m = g("constants.fresh_water.latent_heat_of_fusion")
        self.initial_albedo = self.albedo_max
        if self.paleo_series is not None:
            self.paleo_series = tuple(np.asarray(a, np.float64)
                                      for a in self.paleo_series)
        self._lat = {}

    def max_timestep(self, t) -> float:
        return SEC_PER_YEAR

    # -- orbital state at time t ------------------------------------------
    def _orbit(self, t: float):
        """(declination, distance_factor) at model time t [s], float64 host
        floats."""
        yf = t / SEC_PER_YEAR
        yf = yf - math.floor(yf)
        if not self.paleo:
            return (float(solar_declination_present_day(yf)),
                    float(distance_factor_present_day(yf)))
        if self.paleo_series is not None:
            times, ecc, obl, peri = self.paleo_series
            e = float(np.interp(t, times, ecc))
            o = float(np.interp(t, times, obl))
            w = float(np.interp(t, times, peri))
        else:
            e, o, w = self.ecc, self.obl, self.peri
        return (float(solar_declination_paleo(yf, e, o, w)),
                float(distance_factor_paleo(yf, e, w)))

    def _latitude(self, dtype, device):
        """The latitude [rad] in the field dtype, formed once per dtype and
        device as the JAX package forms it (cast, then times pi/180)."""
        key = (dtype, device)
        if key not in self._lat:
            self._lat[key] = self.latitude.to(device=device, dtype=dtype) \
                * (math.pi / 180.0)
        return self._lat[key]

    def insolation_at(self, t: float, dtype, device):
        """Mean top-of-atmosphere insolation [W m-2] of the melt period at
        model time t."""
        decl, dist = self._orbit(t)
        lat = self._latitude(dtype, device)
        decl, dist = _round_to(decl, dtype), _round_to(dist, dtype)
        return insolation(self.S0, dist, hour_angle(self.phi, lat, decl),
                          lat, decl)

    # -- pointwise melt ---------------------------------------------------
    def melt_components(self, t: float, T, surface_elevation, albedo):
        """Per-unit-time melt split [m ice-equivalent / s]:
        (insolation-driven, temperature-driven, offset, total)."""
        dtype = T.dtype
        decl, dist = self._orbit(t)
        decl, dist = _round_to(decl, dtype), _round_to(dist, dtype)
        lat = self._latitude(dtype, T.device)
        h = hour_angle(self.phi, lat, decl)
        S_ = insolation(self.S0, dist, h, lat, decl)
        tau_a = self.tau_a0 + self.tau_az * torch.clamp(surface_elevation,
                                                        min=0.0)
        sigma = self.sigma
        if self.sigma_param:
            sigma = torch.clamp(self.sigma_a * (T - 273.15) + self.sigma_b,
                                min=1e-3)
        Teff = expected_pdd_rate(T, self.T_pos, sigma)
        # W m-2 -> m water-equivalent / s -> m ice-equivalent / s
        to_ice = (h / math.pi) / (self.rho_w * self.L_m) \
            * (self.rho_w / self.rho_i)
        insol = to_ice * tau_a * (1.0 - albedo) * S_
        tempm = to_ice * self.c1 * Teff
        offset = to_ice * self.c2
        cold = T < self.T_melt_min
        total = torch.where(cold, 0.0, torch.clamp(insol + tempm + offset,
                                                   min=0.0))
        return (torch.where(cold, 0.0, insol), torch.where(cold, 0.0, tempm),
                torch.where(cold, 0.0, offset), total)

    def albedo_from_melt(self, melt_ice_rate):
        """Linear melt-albedo feedback; melt in m ice-equivalent / s."""
        melt_mass = melt_ice_rate * self.rho_i        # kg m-2 s-1
        return torch.clamp(self.albedo_max + self.albedo_slope * melt_mass,
                           self.albedo_min, self.albedo_max)

    # -- stateful protocol --------------------------------------------------
    def _balance_year(self, tk: float) -> float:
        return math.floor(tk / SEC_PER_YEAR - self.balance_year_start)

    def update(self, geometry, t: float, dt: float, carry: SurfaceCarry,
               clock=None):
        """[t, t+dt] in ``n_intervals`` sub-intervals; ``dt`` the step in
        the field dtype. ``clock``: the numpy dtype of the interval and
        its offsets, the field dtype by default (the JAX package's
        field-dtype dt; its climatology divides a Python float)."""
        H = geometry.ice_thickness
        dtype = H.dtype
        f = clock or (np.float32 if dtype == torch.float32 else np.float64)
        snow = carry.snow if carry.snow is not None else torch.zeros_like(H)
        albedo = carry.albedo if carry.albedo is not None \
            else torch.full_like(H, self.initial_albedo)
        N = self.n_intervals
        # the interval and its offsets in the field dtype (the JAX
        # package's field-dtype dt divided by a Python int), the clock
        # float64
        dt_i = f(dt) / f(N)
        dt_if = _round_to(float(dt_i), dtype)
        icy = S.icy(geometry.cell_type)
        z = geometry.ice_surface_elevation
        if self.albedo_field is not None:
            alb_in = torch.where(icy, self.albedo_field.to(dtype),
                                 self.albedo_ocean)

        smb = torch.zeros_like(H)
        melt_a = torch.zeros_like(H)
        runoff_a = torch.zeros_like(H)
        acc_a = torch.zeros_like(H)
        yr = self._balance_year(t - float(f(1e-3) * dt_i))
        for k in range(N):
            tk = t + float(f(k + 0.5) * dt_i)
            atm = self.atmosphere(geometry, tk)
            frac = tk / SEC_PER_YEAR - math.floor(tk / SEC_PER_YEAR)
            cyc = _round_to(math.cos(2.0 * math.pi * (frac - 0.5)), dtype)
            T = atm.temperature + (atm.temperature_july - atm.temperature) \
                * cyc
            yr_k = self._balance_year(tk)
            if yr_k > yr:                      # balance-year reset
                snow = torch.zeros_like(snow)
            yr = yr_k
            if self.precip_as_snow:
                snowfall = atm.precipitation * dt_if
            else:
                sf = torch.clamp((self.T_all_rain - T)
                                 / (self.T_all_rain - self.T_all_snow),
                                 0.0, 1.0)
                snowfall = atm.precipitation * sf * dt_if
            snow = snow + snowfall
            # ice-free (ocean) cells take the fixed ocean albedo
            alb = alb_in if self.albedo_field is not None \
                else torch.where(icy, albedo, self.albedo_ocean)
            M = self.melt_components(tk, T, z, alb)[3]
            albedo = self.albedo_from_melt(M)
            melt_amt = M * dt_if
            snow_melt = torch.minimum(snow, melt_amt)
            ice_melt = melt_amt - snow_melt
            refrozen = self.refreeze * snow_melt
            if self.refreeze_ice:
                refrozen = refrozen + self.refreeze * ice_melt
            smb = smb + snowfall - melt_amt + refrozen
            melt_a = melt_a + melt_amt
            runoff_a = runoff_a + melt_amt - refrozen
            acc_a = acc_a + snowfall
            snow = snow - snow_melt
        Ta = self.atmosphere(geometry, t).temperature
        out = SurfaceInputs(smb=smb / dt,
                            temperature=torch.clamp(Ta, max=273.15),
                            melt=melt_a / dt, runoff=runoff_a / dt,
                            accumulation=acc_a / dt)
        return out, SurfaceCarry(snow=snow, firn=carry.firn, albedo=albedo)

    # -- stateless climatology ----------------------------------------------
    def __call__(self, geometry, t) -> SurfaceInputs:
        t0 = (math.floor(t / SEC_PER_YEAR) + self.balance_year_start) \
            * SEC_PER_YEAR
        out, _ = self.update(geometry, t0, SEC_PER_YEAR, SurfaceCarry(),
                             clock=np.float64)
        return out
