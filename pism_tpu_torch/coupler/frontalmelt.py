"""Frontal melt models (port of ``pism_tpu/coupler/frontalmelt.py``):
``Constant``, ``Given``, ``DischargeRouting`` and ``DischargeGiven`` supply
a frontal (calving-face) melt rate [m/s] that the front-retreat machinery
of ``model/calving.py`` applies at marine ice fronts. The two discharge
models use the Rignot / Xu et al. (2013) plume parameterization,
``DischargeRouting`` fed by the subglacial discharge of the hydrology
(``hydro_Q`` of the steady model, else the routing layer ``hydro_W`` as a
proxy). Every rate is returned in the geometry's dtype.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


class FrontalMeltModel:
    def __call__(self, geometry, t, state=None):
        raise NotImplementedError


@dataclass
class Constant(FrontalMeltModel):
    rate: float = 0.0   # m/s

    def __call__(self, geometry, t, state=None):
        return torch.full_like(geometry.ice_thickness, self.rate)


@dataclass
class Given(FrontalMeltModel):
    rate_field: torch.Tensor   # m/s

    def __call__(self, geometry, t, state=None):
        H = geometry.ice_thickness
        return self.rate_field.to(device=H.device, dtype=H.dtype)


def _plume(A, B, alpha, beta, h, q_sg, theta):
    """Melt [m/s] = (A h q_sg^alpha + B) max(theta, 0)^beta / 86400, q_sg
    in m/day, h the water depth [m], theta the thermal forcing [K]."""
    melt_m_per_day = (A * h * q_sg ** alpha + B) \
        * torch.clamp(theta, min=0.0) ** beta
    return melt_m_per_day / 86400.0


@dataclass
class DischargeRouting(FrontalMeltModel):
    """Rignot et al. (2016) / Xu et al. (2013) plume parameterization with
    the subglacial discharge of the hydrology model."""

    theta: torch.Tensor          # thermal forcing field [K]
    A: float = 3e-4
    B: float = 0.15
    alpha: float = 0.39
    beta: float = 1.18

    def __call__(self, geometry, t, state=None):
        h = torch.clamp(geometry.sea_level - geometry.bed_elevation, min=0.0)
        if state is not None and state.hydro_Q is not None:
            # the steady model's discharge per unit width [m^2/s] over the
            # submerged face height, per day
            q_sg = state.hydro_Q / torch.clamp(h, min=1.0) * 86400.0
        elif state is not None and state.hydro_W is not None:
            # a proxy: the transportable water layer drained per day [m]
            q_sg = state.hydro_W
        else:
            q_sg = torch.zeros_like(h)
        theta = self.theta.to(device=h.device, dtype=h.dtype)
        return _plume(self.A, self.B, self.alpha, self.beta, h, q_sg, theta)


@dataclass
class DischargeGiven(FrontalMeltModel):
    """PISM ``-frontal_melt discharge_given``: the plume parameterization of
    :class:`DischargeRouting` with the subglacial discharge prescribed."""

    theta: torch.Tensor          # thermal forcing field [K]
    discharge: torch.Tensor      # subglacial discharge q_sg [m/day]
    A: float = 3e-4
    B: float = 0.15
    alpha: float = 0.39
    beta: float = 1.18

    def __call__(self, geometry, t, state=None):
        h = torch.clamp(geometry.sea_level - geometry.bed_elevation, min=0.0)
        q_sg = self.discharge.to(device=h.device, dtype=h.dtype)
        theta = self.theta.to(device=h.device, dtype=h.dtype)
        return _plume(self.A, self.B, self.alpha, self.beta, h, q_sg, theta)


def _plume_constants(config):
    """The plume constants ``frontal_melt.routing.*``."""
    return dict(
        A=config.get_number("frontal_melt.routing.parameter_a"),
        B=config.get_number("frontal_melt.routing.parameter_b"),
        alpha=config.get_number("frontal_melt.routing.power_alpha"),
        beta=config.get_number("frontal_melt.routing.power_beta"))


def frontal_melt_from_config(config, grid=None, inputs=None):
    """The model of ``frontal_melt.models`` (None for none). ``constant``
    needs no inputs; ``given``, ``routing`` and ``discharge_given`` take
    their fields from ``inputs`` (``coupler.factory.inputs_from_files(...,
    "frontal_melt")`` reads them from the ``frontal_melt.*.file`` keys)."""
    name = config.get_string("frontal_melt.models")
    if not name or name == "none":
        return None
    if name == "constant":
        return Constant(rate=config.get_number(
            "frontal_melt.constant.melt_rate", "m s-1"))
    inputs = inputs or {}

    def need(key):
        if key not in inputs:
            raise ValueError(
                f"frontal_melt.models = {name!r} needs input field {key!r} "
                f"(set frontal_melt.{name}.file)")
        return inputs[key]

    if name == "given":
        return Given(rate_field=need("frontal_melt_rate"))
    if name == "routing":
        return DischargeRouting(theta=need("theta_ocean"),
                                **_plume_constants(config))
    if name == "discharge_given":
        return DischargeGiven(theta=need("theta_ocean"),
                              discharge=need("subglacial_discharge"),
                              **_plume_constants(config))
    raise ValueError(f"unknown frontal_melt model {name!r}")
