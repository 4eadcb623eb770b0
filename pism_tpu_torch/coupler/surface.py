"""Surface (climate) boundary models (port of
``pism_tpu/coupler/surface.py``): the data types, the base class with the
modifier protocol, the stateless ``FunctionSurface`` of the verification
setups, ``Uniform``, ``Simple``, ``PIK``, ``Given``, ``GivenStreamed``,
``ElevationDependent`` and ``ISMIP6``, and the modifiers ``Anomaly``,
``DeltaT``, ``ElevationChange``, ``Cache`` and ``ForceThickness``.

Model time is a host float: a time stack's record and weight are found on
the host (``util.forcing``), never read back from the card."""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..util.forcing import TimeStack, constant_slice


class SurfaceInputs(NamedTuple):
    smb: torch.Tensor          # surface mass balance [m/s ice equivalent]
    temperature: torch.Tensor  # ice surface temperature [K]
    melt: Optional[torch.Tensor] = None          # m/s ice equivalent
    runoff: Optional[torch.Tensor] = None        # m/s (melt - refreeze)
    accumulation: Optional[torch.Tensor] = None  # m/s (snowfall)


class SurfaceCarry(NamedTuple):
    """Model-state fields threaded through stateful surface models: the PDD
    snow/firn bookkeeping depths and the dEBM-simple albedo; a slot a model
    does not use passes through."""

    snow: Optional[torch.Tensor] = None    # m ice equivalent
    firn: Optional[torch.Tensor] = None    # m ice equivalent
    albedo: Optional[torch.Tensor] = None  # 1


class SurfaceModel:
    """Base interface (PISM ``surface::SurfaceModel``): ``model(geometry, t)``
    is the stateless climatology; a stateful model also integrates
    ``update(geometry, t, dt, carry)`` over [t, t+dt]. A modifier holds an
    ``inner`` model and transforms its output in ``_transform``; the carry,
    ``stateful``, ``uses_albedo``, ``midpoint_sampling`` and
    ``max_timestep`` pass through it."""

    def __call__(self, geometry, t) -> SurfaceInputs:
        inner = getattr(self, "inner", None)
        if inner is not None:
            return self._transform(inner(geometry, t), geometry, t)
        raise NotImplementedError

    def _transform(self, s: SurfaceInputs, geometry, t) -> SurfaceInputs:
        """Modifier hook: transform the inner model's output."""
        raise NotImplementedError

    @property
    def stateful(self) -> bool:
        inner = getattr(self, "inner", None)
        return bool(inner is not None and inner.stateful)

    @property
    def uses_albedo(self) -> bool:
        inner = getattr(self, "inner", None)
        return bool(inner is not None and inner.uses_albedo)

    @property
    def midpoint_sampling(self) -> bool:
        """True when the forcing is sampled at the step's midpoint
        (``GivenStreamed``), through any modifier."""
        inner = getattr(self, "inner", None)
        return bool(inner is not None and inner.midpoint_sampling)

    def update(self, geometry, t, dt, carry: SurfaceCarry):
        inner = getattr(self, "inner", None)
        if inner is not None:
            s, carry = inner.update(geometry, t, dt, carry)
            return self._transform(s, geometry, t), carry
        return self(geometry, t), carry

    def max_timestep(self, t) -> float:
        inner = getattr(self, "inner", None)
        return inner.max_timestep(t) if inner is not None else math.inf

    def members(self, geometry, t) -> SurfaceInputs:
        """The climate of an ensemble's members: ``geometry`` with a leading
        member axis, ``t`` their model times (a float64 tensor, one per
        member). Models that have no member form raise."""
        raise NotImplementedError(
            f"the surface model {type(self).__name__} on an ensemble's member "
            "axis is not implemented in pism_tpu_torch (supported: Uniform, "
            "FunctionSurface, PIK; ROADMAP Queue 1 item 3)")

    def members_update(self, geometry, t, dt, carry: SurfaceCarry):
        """``update`` of a stateful model for an ensemble's members:
        ``geometry`` and ``carry`` with a leading member axis, ``t`` and
        ``dt`` host lists of the members' times and steps. Models that have
        no member form raise."""
        raise NotImplementedError(
            f"the stateful surface model {type(self).__name__} on an "
            "ensemble's member axis is not implemented in pism_tpu_torch "
            "(supported: the PDD, TemperatureIndex; ROADMAP Queue 1 item 3)")


@dataclass
class FunctionSurface(SurfaceModel):
    """Wraps fn(geometry, t) -> (smb, temperature); used by the verification
    setups (EISMINT II's radially symmetric climate). On an ensemble's
    member axis ``fn`` sees one member at a time (``torch.func.vmap`` over
    the geometry's fields and the members' times), as the JAX package's
    ``vmap`` over the whole step shows it one member."""

    fn: Callable

    def __call__(self, geometry, t) -> SurfaceInputs:
        smb, temp = self.fn(geometry, t)
        return SurfaceInputs(smb, temp)

    def members(self, geometry, t) -> SurfaceInputs:
        import torch.func

        names = [f.name for f in dataclasses.fields(geometry)]

        def one(t_, *fields):
            return tuple(self.fn(type(geometry)(**dict(zip(names, fields))),
                                 t_))

        smb, temp = torch.func.vmap(one)(
            t, *(getattr(geometry, n) for n in names))
        return SurfaceInputs(smb, temp)


@dataclass
class Uniform(SurfaceModel):
    """Spatially uniform, constant in time."""

    smb: float = 0.0          # m/s ice equivalent
    temperature: float = 263.15

    def __call__(self, geometry, t) -> SurfaceInputs:
        H = geometry.ice_thickness
        return SurfaceInputs(smb=torch.full_like(H, self.smb),
                             temperature=torch.full_like(H, self.temperature))

    def members(self, geometry, t) -> SurfaceInputs:
        return self(geometry, None)


@dataclass
class Simple(SurfaceModel):
    """PISM ``-surface simple``: SMB = the atmosphere's precipitation, ice
    surface temperature = its mean-annual air temperature."""

    atmosphere: object          # AtmosphereModel

    def __call__(self, geometry, t) -> SurfaceInputs:
        a = self.atmosphere(geometry, t)
        return SurfaceInputs(a.precipitation, a.temperature)


@dataclass
class PIK(SurfaceModel):
    """PISM ``-surface pik``: SMB = the atmosphere's precipitation; the ice
    surface temperature from the Martin et al. (2011, TC) Antarctic
    parameterization T_s [K] = 273.15 + 30 - 0.0075 h - 0.68775 |lat|
    (h the surface elevation [m], lat in degrees), capped at the melting
    point."""

    atmosphere: object
    latitude: torch.Tensor      # degrees (negative in the south)

    def __call__(self, geometry, t) -> SurfaceInputs:
        return self._surface(self.atmosphere(geometry, t), geometry)

    def members(self, geometry, t) -> SurfaceInputs:
        """The atmosphere's member form, the latitude broadcast over the
        members."""
        return self._surface(self.atmosphere.members(geometry, t), geometry)

    def _surface(self, a, geometry) -> SurfaceInputs:
        h = geometry.ice_surface_elevation
        lat = torch.abs(self.latitude.to(h.dtype))
        T = 273.15 + 30.0 - 0.0075 * h - 0.68775 * lat
        return SurfaceInputs(a.precipitation, torch.clamp(T, max=273.15))


@dataclass
class Given(SurfaceModel, TimeStack):
    """Prescribed fields (PISM ``-surface given``): single slices or
    ``(Nt, My, Mx)`` stacks with a ``times`` axis [s]; SMB (a "time: mean"
    flux) piecewise-constant, temperature piecewise-linear; ``period`` > 0
    cycles the series."""

    smb_field: torch.Tensor
    temperature_field: torch.Tensor
    times: Optional[np.ndarray] = None    # (Nt,) [s], sorted
    period: float = 0.0                   # [s]; > 0 cycles the series

    def __call__(self, geometry, t) -> SurfaceInputs:
        return SurfaceInputs(
            self._constant(self.smb_field, t, self.smb_field.dtype),
            self._linear(self.temperature_field, t,
                         self.temperature_field.dtype))


@dataclass
class GivenStreamed(SurfaceModel):
    """PISM ``-surface given`` reading its records from the file during the
    run: each field a ``coupler.stream.ForcingStream`` whose reader thread
    reads ahead of model time. The series is sampled at the step's
    midpoint (``midpoint_sampling``), as the JAX package does."""

    smb: object           # ForcingStream [m/s ice equivalent]
    temperature: object   # ForcingStream [K]

    midpoint_sampling = True

    def __call__(self, geometry, t) -> SurfaceInputs:
        H = geometry.ice_thickness
        return SurfaceInputs(self.smb.slice_at(t, H.device).to(H.dtype),
                             self.temperature.slice_at(t, H.device)
                             .to(H.dtype))


@dataclass
class ElevationDependent(SurfaceModel):
    """PISM ``-surface elevation``: a piecewise-linear SMB(z) ramp."""

    z_min: float
    z_ela: float
    z_max: float
    m_min: float   # SMB at z_min [m/s]
    m_max: float   # SMB at z_max
    temperature: float = 263.15

    def __call__(self, geometry, t) -> SurfaceInputs:
        z = geometry.ice_surface_elevation
        below = self.m_min * (self.z_ela - z) / (self.z_ela - self.z_min)
        above = self.m_max * (z - self.z_ela) / (self.z_max - self.z_ela)
        smb = torch.where(z < self.z_ela, -below, above)
        smb = torch.clamp(smb, self.m_min, self.m_max)
        return SurfaceInputs(smb, torch.full_like(z, self.temperature))


@dataclass
class ISMIP6(SurfaceModel):
    """PISM ``-surface ismip6``: the reference climate plus the records of
    the anomaly and elevation-gradient stacks,

        SMB(t) = SMB_ref + aSMB(t) + dSMBdz(t) (h - h_ref)
        T(t)   = T_ref   + aST(t)  + dSTdz(t)  (h - h_ref),

    the records piecewise-constant in time, clamped at the ends."""

    smb_ref: torch.Tensor            # m/s ice equivalent
    temperature_ref: torch.Tensor    # K
    surface_ref: torch.Tensor        # h_ref [m]
    anomaly_times: Optional[np.ndarray] = None   # (Nt,) [s], sorted
    a_smb: Optional[torch.Tensor] = None          # (Nt, My, Mx) [m/s]
    a_temp: Optional[torch.Tensor] = None         # (Nt, My, Mx) [K]
    dsmb_dz: Optional[torch.Tensor] = None        # (Nt, My, Mx) [m/s / m]
    dtemp_dz: Optional[torch.Tensor] = None       # (Nt, My, Mx) [K / m]

    def _slice(self, stack, t, dtype):
        return constant_slice(stack, self.anomaly_times, 0.0, t, dtype)

    def __call__(self, geometry, t) -> SurfaceInputs:
        h = geometry.ice_surface_elevation
        dt_ = h.dtype
        dh = h - self.surface_ref.to(dt_)
        smb, T = self.smb_ref.to(dt_), self.temperature_ref.to(dt_)
        if self.a_smb is not None:
            smb = smb + self._slice(self.a_smb, t, dt_)
        if self.dsmb_dz is not None:
            smb = smb + self._slice(self.dsmb_dz, t, dt_) * dh
        if self.a_temp is not None:
            T = T + self._slice(self.a_temp, t, dt_)
        if self.dtemp_dz is not None:
            T = T + self._slice(self.dtemp_dz, t, dt_) * dh
        return SurfaceInputs(smb, T)


@dataclass
class Anomaly(SurfaceModel):
    """PISM ``-surface ...,anomaly``: prescribed SMB and temperature
    anomaly fields (or stacks with ``times``, piecewise-constant) added to
    the inner model's."""

    inner: SurfaceModel
    smb_anomaly: Optional[torch.Tensor] = None       # m/s
    temp_anomaly: Optional[torch.Tensor] = None      # K
    times: Optional[np.ndarray] = None               # (Nt,) [s] if stacked
    period: float = 0.0   # [s]; > 0 cycles (surface.anomaly.periodic)

    def _transform(self, s, geometry, t) -> SurfaceInputs:
        dt_ = s.smb.dtype
        smb, T = s.smb, s.temperature
        if self.smb_anomaly is not None:
            smb = smb + constant_slice(self.smb_anomaly, self.times,
                                       self.period, t, dt_)
        if self.temp_anomaly is not None:
            T = T + constant_slice(self.temp_anomaly, self.times,
                                   self.period, t, dt_)
        return s._replace(smb=smb, temperature=T)


@dataclass
class DeltaT(SurfaceModel):
    """PISM ``-surface ...,delta_T``: a scalar ice-surface-temperature
    offset ``offset(t)`` [K] (a host callable) on an inner model."""

    inner: SurfaceModel
    offset: Callable            # t -> K

    def _transform(self, s, geometry, t) -> SurfaceInputs:
        return s._replace(temperature=s.temperature + self.offset(t))


@dataclass
class ElevationChange(SurfaceModel):
    """PISM ``-surface ...,elevation_change``: the inner model's outputs
    corrected for the surface's change against a reference surface, the
    temperature by a lapse rate (capped at the melting point), the SMB
    shifted by an SMB lapse rate or scaled exponentially with the implied
    temperature change (``surface.elevation_change.smb.method``)."""

    inner: SurfaceModel
    reference_surface: torch.Tensor
    temp_lapse_rate: float = 6.0e-3   # K/m
    smb_lapse_rate: float = 0.0       # m/s ice-eq per m of uplift ("shift")
    smb_exp_factor: float = 0.0       # per K of implied warming ("scale")

    def _transform(self, s: SurfaceInputs, geometry, t) -> SurfaceInputs:
        dh = geometry.ice_surface_elevation \
            - self.reference_surface.to(geometry.ice_thickness.dtype)
        dT = -self.temp_lapse_rate * dh
        smb = s.smb
        if self.smb_exp_factor != 0.0:
            smb = smb * torch.exp(self.smb_exp_factor * dT)
        if self.smb_lapse_rate != 0.0:
            smb = smb - self.smb_lapse_rate * dh
        return s._replace(smb=smb, temperature=torch.clamp(
            s.temperature + dT, max=273.15))


@dataclass
class Cache(SurfaceModel):
    """PISM ``-surface ...,cache``: the inner model evaluated on a clock
    quantized to ``update_interval``, so its forcing is held for an
    interval as the reference's cache holds it; the inner model sees the
    current geometry. A stateful inner model sees every (t, dt) unquantized
    (a cache would drop its state updates)."""

    inner: SurfaceModel
    update_interval: float      # seconds

    def __call__(self, geometry, t) -> SurfaceInputs:
        tq = math.floor(t / self.update_interval) * self.update_interval
        return self.inner(geometry, tq)

    def update(self, geometry, t, dt, carry):
        if self.stateful:
            return self.inner.update(geometry, t, dt, carry)
        return self(geometry, t), carry


@dataclass
class ForceThickness(SurfaceModel):
    """PISM ``-surface ...,forcing``: the inner model's SMB nudged toward a
    target thickness, SMB -= alpha (H - H_target), with alpha scaled by
    ``ice_free_alpha_factor`` where the target is ice-free and 0 before
    ``start_time``."""

    inner: SurfaceModel
    target_thickness: torch.Tensor   # m
    alpha: float = 3.17e-9           # 1/s
    ice_free_alpha_factor: float = 1.0
    start_time: float = -1.0e30      # [s]

    def _transform(self, s, geometry, t) -> SurfaceInputs:
        H = geometry.ice_thickness
        Ht = self.target_thickness.to(H.dtype)
        if t >= self.start_time:
            a1 = torch.tensor(self.alpha, dtype=H.dtype, device=H.device)
            a0 = torch.tensor(self.alpha * self.ice_free_alpha_factor,
                              dtype=H.dtype, device=H.device)
            alpha = torch.where(Ht > 1.0, a1, a0)
        else:
            alpha = torch.zeros_like(H)
        return s._replace(smb=s.smb - alpha * (H - Ht))
