"""Orographic precipitation, the Smith & Barstad (2004) linear theory (port
of ``pism_tpu/coupler/orographic.py``; PISM
``atmosphere::OrographicPrecipitation``): precipitation from the forced
uplift of moist air over the evolving ice surface,

    P_hat(k, l) = Cw i sigma h_hat /
        ((1 - i m H_w)(1 + i sigma tau_c)(1 + i sigma tau_f)),

sigma = U k + V l, m the vertical wavenumber from the moist stability N_m;
P = max(P_background + irfft2(P_hat), 0), through ``torch.fft``.

The spectra stay in the field precision (complex64 under float32), as the
JAX package keeps them. The transfer function does not depend on the
surface: it is built once per dtype and device, in the same operations as
the JAX package's per-call form, so it is the same to the bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..util.units import SEC_PER_YEAR
from .atmosphere import AtmosphereInputs, AtmosphereModel


@dataclass
class OrographicPrecipitation(AtmosphereModel):
    grid: object
    wind_u: float = 10.0        # m/s eastward
    wind_v: float = 0.0
    tau_c: float = 1000.0       # cloud conversion time [s]
    tau_f: float = 1000.0       # fallout time [s]
    Hw: float = 2500.0          # water vapor scale height [m]
    Nm: float = 0.005           # moist stability frequency [1/s]
    Cw: float = 0.001           # uplift sensitivity [kg m^-3]
    background_precip: float = 0.3 / SEC_PER_YEAR  # m/s ice equivalent
    temperature: float = 263.15
    temperature_july: float = 268.15
    rho_water: float = 1000.0
    f_cor: float = 0.0          # Coriolis parameter [1/s]
    scale_factor: float = 1.0   # multiplier on the orographic perturbation
    truncate: bool = True       # clamp negative total precipitation
    pad_factor: int = 1         # FFT domain padding against wrap-around

    def __post_init__(self):
        g = self.grid
        self.Ny = max(int(self.pad_factor), 1) * g.My
        self.Nx = max(int(self.pad_factor), 1) * g.Mx
        kx = np.fft.rfftfreq(self.Nx, g.dx) * 2.0 * np.pi
        ky = np.fft.fftfreq(self.Ny, g.dy) * 2.0 * np.pi
        self._KY, self._KX = np.meshgrid(ky, kx, indexing="ij")
        self._transfer = {}

    def _transfer_function(self, dtype, device):
        """Cw i sigma / denom on the rfft2 grid, in the field precision."""
        key = (dtype, device)
        if key in self._transfer:
            return self._transfer[key]
        cdt = torch.complex64 if dtype == torch.float32 else torch.complex128
        kx = torch.as_tensor(self._KX).to(device=device, dtype=dtype)
        ky = torch.as_tensor(self._KY).to(device=device, dtype=dtype)
        sigma = self.wind_u * kx + self.wind_v * ky
        k2 = kx ** 2 + ky ** 2
        # vertical wavenumber (moist, hydrostatic limit with a
        # regularization; with rotation the denominator is sigma^2 - f^2)
        sigma_reg = torch.where(torch.abs(sigma) < 1e-10,
                                torch.sign(sigma) * 1e-10
                                + (sigma == 0).to(dtype) * 1e-10, sigma)
        denom_sig = sigma_reg ** 2 - self.f_cor ** 2
        denom_sig = torch.where(torch.abs(denom_sig) < 1e-18,
                                torch.sign(denom_sig) * 1e-18
                                + (denom_sig == 0).to(dtype) * 1e-18,
                                denom_sig)
        m2 = (self.Nm ** 2 - sigma_reg ** 2) / denom_sig * k2
        root = torch.sqrt(torch.abs(m2))
        m = torch.where(m2 >= 0, torch.complex(root * torch.sign(sigma_reg),
                                               torch.zeros_like(root)),
                        torch.complex(torch.zeros_like(root), root)).to(cdt)
        sig_c = sigma.to(cdt)
        denom = ((1.0 - 1j * m * self.Hw)
                 * (1.0 + 1j * sig_c * self.tau_c)
                 * (1.0 + 1j * sig_c * self.tau_f))
        out = (self.Cw * 1j * sig_c, denom)
        self._transfer[key] = out
        return out

    def precipitation_field(self, surface):
        g = self.grid
        h = surface - torch.mean(surface)
        if self.pad_factor > 1:
            hp = h.new_zeros((self.Ny, self.Nx))
            hp[:g.My, :g.Mx] = h
            h = hp
        num, denom = self._transfer_function(h.dtype, h.device)
        h_hat = torch.fft.rfft2(h)
        P_hat = num * h_hat / denom
        P = torch.fft.irfft2(P_hat, s=h.shape)   # kg m^-2 s^-1
        if self.pad_factor > 1:
            P = P[:g.My, :g.Mx]
        P = self.scale_factor * P / self.rho_water   # m/s water equivalent
        total = self.background_precip + P
        return torch.clamp(total, min=0.0) if self.truncate else total

    def __call__(self, geometry, t) -> AtmosphereInputs:
        s = geometry.ice_surface_elevation
        P = self.precipitation_field(s).to(s.dtype)
        return AtmosphereInputs(torch.full_like(s, self.temperature),
                                torch.full_like(s, self.temperature_july), P)


@dataclass
class OrographicModifier(AtmosphereModel):
    """PISM ``-atmosphere ...,orographic_precipitation``: the inner model's
    temperatures, the precipitation replaced by the Smith-Barstad field over
    the evolving surface."""

    inner: AtmosphereModel
    ltop: OrographicPrecipitation

    def __call__(self, geometry, t) -> AtmosphereInputs:
        inp = self.inner(geometry, t)
        s = geometry.ice_surface_elevation
        P = self.ltop.precipitation_field(s).to(s.dtype)
        return AtmosphereInputs(inp.temperature, inp.temperature_july, P)


def orographic_from_config(grid, config):
    """An ``OrographicPrecipitation`` from the
    ``atmosphere.orographic_precipitation.*`` parameters."""
    p = "atmosphere.orographic_precipitation."
    speed = config.get_number(p + "wind_speed", "m s-1")
    direction = config.get_number(p + "wind_direction", "degrees")
    # meteorological convention: the direction the wind blows from,
    # clockwise from north; 270 degrees is a westerly, +x wind
    theta = math.radians(direction)
    # Cw = rho_Sref Gamma_m / gamma (Smith & Barstad 2004) when the
    # thermodynamic constants are set and no uplift sensitivity is
    if not config.is_set(p + "uplift_sensitivity") and any(
            config.is_set(p + k) for k in
            ("reference_density", "moist_adiabatic_lapse_rate",
             "lapse_rate")):
        Cw = (config.get_number(p + "reference_density")
              * config.get_number(p + "moist_adiabatic_lapse_rate")
              / config.get_number(p + "lapse_rate"))
    else:
        Cw = config.get_number(p + "uplift_sensitivity", "kg m-3")
    lat = config.get_number(p + "coriolis_latitude")
    f_cor = 2.0 * 7.2921e-5 * math.sin(math.radians(lat))
    return OrographicPrecipitation(
        grid=grid,
        wind_u=-speed * math.sin(theta),
        wind_v=-speed * math.cos(theta),
        tau_c=config.get_number(p + "conversion_time", "seconds"),
        tau_f=config.get_number(p + "fallout_time", "seconds"),
        Hw=config.get_number(p + "water_vapor_scale_height", "m"),
        Nm=config.get_number(p + "moist_stability_frequency", "s-1"),
        Cw=Cw,
        background_precip=config.get_number(
            p + "background_precip_rate", "m s-1"),
        f_cor=f_cor,
        scale_factor=config.get_number(p + "scale_factor"),
        truncate=config.get_flag(p + "truncate"),
        pad_factor=config.get_int(p + "grid_size_factor"),
    )
