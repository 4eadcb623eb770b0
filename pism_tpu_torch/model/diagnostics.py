"""Diagnostics registry (port of ``pism_tpu/model/diagnostics.py``, the
part the output channels of the ported routes write).

A registry of functions ``(state, model, t) -> tensor`` with CF metadata
(PISM ``Diagnostic``): the spatial fields of the default ``-extra_vars``
(``thk``, ``usurf``, ``velbar_mag``, ``mask``) and of ``-o_size medium``
(``output.sizes.medium``), the scalars of the default ``-ts_vars``
(``ice_volume_glacierized``, ``ice_area_glacierized``, ``max_velocity``)
with ``ice_volume``, the fields of the PIK chain (``shelfbmassflux``,
``shelfbtemp``, the ``pico_*`` set, the eigen, von Mises, Hayhurst,
frontal-melt and total retreat rates, ``frontal_melt_rate``,
``dbdt_total``, ``viscous_bed_displacement``), the hydrology's (``bwat``,
``bwp``, ``bwprel``, ``effbwp``, ``hydraulic_potential``, ``bwatflux``,
``bwatvel_x``/``_y``, ``wallmelt``), the
bedrock layer's ``bedtoptemp``, ``heat_flux_from_bedrock`` and
``litho_temp`` (the column, ``(..., Mbz)``), the surface model's state
(``snow_depth``, ``firn_depth``, ``surface_albedo``) and dEBM-simple's
``insolation`` and ``debm_*_melt_flux`` fields, the column tracers' and
the damage field's (``age``, ``isochrone_depth`` on the layer axis ``nl``,
``ch_temp``, ``ch_liqfrac``, ``ch_heat_flux``, ``fracture_density``,
``fracture_age``, ``fracture_flow_enhancement``), and
the interval-averaged rates: the scalar ones
(``Window``, ``RATE``) from ``StepStats``' volume sums, and the spatial
ones (``Window2D``, ``SPATIAL_RATE``) from its per-cell ``CellBudget``.
Names, units, long names and formulas are the JAX package's; where it
registers a name twice the later registration is the one ported.

Every other diagnostic of the JAX package raises NotImplementedError when
an output channel asks for it (``require_known``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple

import torch

from .. import state as S
from ..ops import stencils as st
from ..util.units import SEC_PER_YEAR


class Diagnostic(NamedTuple):
    func: Callable            # (state, model, t) -> tensor, or (window) -> value
    units: str
    long_name: str
    standard_name: str = ""


SPATIAL: Dict[str, Diagnostic] = {}
SCALAR: Dict[str, Diagnostic] = {}
RATE: Dict[str, Diagnostic] = {}
SPATIAL_RATE: Dict[str, Diagnostic] = {}


def _register(table, name, units, long_name, standard_name=""):
    def deco(fn):
        table[name] = Diagnostic(fn, units, long_name, standard_name)
        return fn
    return deco


def spatial(name, units, long_name, standard_name=""):
    return _register(SPATIAL, name, units, long_name, standard_name)


def scalar(name, units, long_name, standard_name=""):
    return _register(SCALAR, name, units, long_name, standard_name)


def rate(name, units, long_name, standard_name=""):
    return _register(RATE, name, units, long_name, standard_name)


def spatial_rate(name, units, long_name, standard_name=""):
    return _register(SPATIAL_RATE, name, units, long_name, standard_name)


def _zeros2(state):
    return torch.zeros_like(state.geometry.ice_thickness)


def _sb(state, model, t=None):
    """The composite stress balance of ``state``, computed once for all the
    velocity diagnostics of one output record (keyed on the state object)."""
    cached = getattr(model, "_diag_sb_cache", None)
    if cached is not None and cached[0] is state:
        return cached[1]
    tau_c = None
    if model.yield_stress is not None:
        tau_c = model.yield_stress.compute(state, t=t)
    res = model.stress_balance.update(state, tau_c, t=t)
    model._diag_sb_cache = (state, res)
    return res


# --------------------------------------------------------------------------
# spatial diagnostics
# --------------------------------------------------------------------------

@spatial("thk", "m", "land ice thickness", "land_ice_thickness")
def _thk(state, model, t):
    return state.geometry.ice_thickness


@spatial("usurf", "m", "ice upper surface elevation", "surface_altitude")
def _usurf(state, model, t):
    return state.geometry.ice_surface_elevation


@spatial("topg", "m", "bedrock surface elevation", "bedrock_altitude")
def _topg(state, model, t):
    return state.geometry.bed_elevation


@spatial("mask", "", "ice-type mask (0=ice-free land,2=grounded,3=floating,4=ocean)")
def _mask(state, model, t):
    return state.geometry.cell_type


@spatial("velbar_mag", "m s-1", "magnitude of vertically-integrated horizontal velocity")
def _velbar(state, model, t):
    u = state.u_ssa if state.u_ssa is not None else _zeros2(state)
    v = state.v_ssa if state.v_ssa is not None else torch.zeros_like(u)
    return torch.sqrt(u ** 2 + v ** 2)


@spatial("ubar", "m s-1", "x-component of vertically-integrated velocity")
def _ubar(state, model, t):
    return state.u_ssa if state.u_ssa is not None else _zeros2(state)


@spatial("vbar", "m s-1", "y-component of vertically-integrated velocity")
def _vbar(state, model, t):
    return state.v_ssa if state.v_ssa is not None else _zeros2(state)


@spatial("velsurf_mag", "m s-1", "magnitude of horizontal surface velocity")
def _velsurf(state, model, t):
    sb = _sb(state, model, t)
    if sb.sia3 is not None:
        return torch.sqrt(sb.sia3.u[..., -1] ** 2 + sb.sia3.v[..., -1] ** 2)
    return _velbar(state, model, t)


@spatial("bmelt", "m s-1", "basal melt rate (ice equivalent)",
         "land_ice_basal_melt_rate")
def _bmelt(state, model, t):
    return state.basal_melt_rate if state.basal_melt_rate is not None \
        else _zeros2(state)


@spatial("tillwat", "m", "effective thickness of subglacial till water")
def _tillwat(state, model, t):
    return state.tillwat if state.tillwat is not None else _zeros2(state)


@spatial("temppabase", "K", "pressure-adjusted basal temperature")
def _temppabase(state, model, t):
    H = state.geometry.ice_thickness
    if state.enthalpy is None:
        return torch.zeros_like(H)
    EC = model.EC
    return EC.pressure_adjusted_temperature(state.enthalpy[..., 0],
                                            EC.pressure(H))


@spatial("taud_mag", "Pa", "magnitude of the gravitational driving stress")
def _taud(state, model, t):
    g = state.geometry
    sx, sy = st.centered_grad(g.ice_surface_elevation, model.grid.dx,
                              model.grid.dy, model.sh)
    f = model.rho_i * 9.81 * g.ice_thickness
    return f * torch.sqrt(sx ** 2 + sy ** 2)


@spatial("diffusivity", "m2 s-1", "SIA diffusivity (staggered max)")
def _diff(state, model, t):
    sb = _sb(state, model, t)
    return torch.clamp(sb.qe * 0 + sb.max_diffusivity, min=0.0)


@spatial("velbase_mag", "m s-1", "magnitude of basal horizontal velocity")
def _velbase(state, model, t):
    sb = _sb(state, model, t)
    if sb.sia3 is not None:
        return torch.sqrt(sb.sia3.u[..., 0] ** 2 + sb.sia3.v[..., 0] ** 2)
    return _velbar(state, model, t)


@spatial("tauc", "Pa", "basal yield stress")
def _tauc(state, model, t):
    if model.yield_stress is None:
        return _zeros2(state)
    return model.yield_stress.compute(state)


@spatial("flux_mag", "m2 s-1",
         "magnitude of vertically-integrated horizontal flux")
def _fluxmag(state, model, t):
    return _velbar(state, model, t) * state.geometry.ice_thickness


@spatial("snow_depth", "m", "PDD snow cover depth (ice equivalent)")
def _snowdepth(state, model, t):
    return state.snow_depth if state.snow_depth is not None \
        else _zeros2(state)


@spatial("firn_depth", "m", "PDD firn layer depth (ice equivalent)")
def _firndepth(state, model, t):
    return state.firn_depth if state.firn_depth is not None \
        else _zeros2(state)


@spatial("surface_albedo", "1", "dEBM-simple surface albedo")
def _surfalbedo(state, model, t):
    return state.surface_albedo if state.surface_albedo is not None \
        else _zeros2(state)


def _debm_model(model):
    from ..coupler.debm import DEBMSimple
    surf = getattr(model, "surface", None)
    while surf is not None and not isinstance(surf, DEBMSimple):
        surf = getattr(surf, "inner", None)
    return surf


@spatial("insolation", "W m-2",
         "mean top-of-atmosphere insolation during the dEBM melt period")
def _insolation(state, model, t):
    surf = _debm_model(model)
    if surf is None:
        return _zeros2(state)
    H = state.geometry.ice_thickness
    return surf.insolation_at(t, H.dtype, H.device)


def _debm_melt_parts(state, model, t):
    """The dEBM melt components at model time t [m ice equivalent s-1]."""
    surf = _debm_model(model)
    if surf is None:
        z = _zeros2(state)
        return z, z, z
    geom = state.geometry
    atm = surf.atmosphere(geom, t)
    frac = t / SEC_PER_YEAR - math.floor(t / SEC_PER_YEAR)
    cyc = torch.tensor(math.cos(2.0 * math.pi * (frac - 0.5)),
                       dtype=geom.ice_thickness.dtype).item()
    T = atm.temperature + (atm.temperature_july - atm.temperature) * cyc
    alb = state.surface_albedo if state.surface_albedo is not None \
        else torch.full_like(geom.ice_thickness, surf.albedo_max)
    insol, temp, offset, _ = surf.melt_components(
        t, T, geom.ice_surface_elevation, alb)
    return insol, temp, offset


@spatial("debm_insolation_driven_melt_flux", "kg m-2 s-1",
         "dEBM-simple insolation-driven melt flux")
def _debm_insol_melt(state, model, t):
    return _debm_melt_parts(state, model, t)[0] * 910.0


@spatial("debm_temperature_driven_melt_flux", "kg m-2 s-1",
         "dEBM-simple temperature-driven melt flux")
def _debm_temp_melt(state, model, t):
    return _debm_melt_parts(state, model, t)[1] * 910.0


@spatial("debm_offset_melt_flux", "kg m-2 s-1",
         "dEBM-simple background (offset) melt flux")
def _debm_offset_melt(state, model, t):
    return _debm_melt_parts(state, model, t)[2] * 910.0


@spatial("climatic_mass_balance", "kg m-2 s-1",
         "surface mass balance seen by the ice (climatology at t)",
         standard_name="land_ice_surface_specific_mass_balance_flux")
def _cmb(state, model, t):
    if model.surface is None:
        return _zeros2(state)
    return model.surface(state.geometry, t).smb * 910.0


@spatial("ice_surface_temp", "K",
         "temperature of the ice at the ice surface but below firn")
def _ist(state, model, t):
    if model.surface is None:
        return _zeros2(state)
    return model.surface(state.geometry, t).temperature


@spatial("sftgif", "1", "fraction of grid cell covered with ice",
         "land_ice_area_fraction")
def _sftgif(state, model, t):
    return S.icy(state.geometry.cell_type).to(state.geometry.ice_thickness.dtype)


@spatial("sftgrf", "1", "fraction of grid cell covered with grounded ice",
         "grounded_ice_sheet_area_fraction")
def _sftgrf(state, model, t):
    return _sftgif(state, model, t) * state.geometry.cell_grounded_fraction


@spatial("sftflf", "1", "fraction of grid cell covered with floating ice",
         "floating_ice_shelf_area_fraction")
def _sftflf(state, model, t):
    return _sftgif(state, model, t) - _sftgrf(state, model, t)


# -- the bedrock thermal layer (PISM bedtoptemp, heat_flux_from_bedrock,
# BTU_Full's litho_temp) ------------------------------------------------------

@spatial("bedtoptemp", "K", "temperature at the top of the bedrock column")
def _bedtoptemp(state, model, t):
    if state.bedrock_temperature is None:
        return _zeros2(state)
    return state.bedrock_temperature[..., -1]


@spatial("heat_flux_from_bedrock", "W m-2",
         "conductive upward heat flux at the top of the bedrock",
         "upward_geothermal_heat_flux_at_ground_level")
def _bedrock_flux(state, model, t):
    if state.bedrock_temperature is None or model.grid.Mbz < 2:
        G = model.config.get_number("bootstrapping.defaults.geothermal_flux")
        return torch.full_like(state.geometry.ice_thickness, G)
    k_b = model.config.get_number("energy.bedrock_thermal.conductivity")
    dzb = model.grid.Lbz / (model.grid.Mbz - 1)
    T = state.bedrock_temperature
    return k_b * (T[..., -2] - T[..., -1]) / dzb


@spatial("litho_temp", "K", "lithosphere (bedrock thermal layer) temperature")
def _litho_temp(state, model, t):
    if state.bedrock_temperature is not None:
        return state.bedrock_temperature
    return _zeros2(state)[..., None]


# --------------------------------------------------------------------------
# ocean, calving and bed deformation (the PIK chain's fields)
# --------------------------------------------------------------------------

def _zeros3(state, model):
    H = state.geometry.ice_thickness
    return torch.zeros(tuple(H.shape) + (model.grid.Mz,), dtype=H.dtype,
                       device=H.device)


def _pressure3(state, model):
    H = state.geometry.ice_thickness
    z = torch.as_tensor(model.grid.z, dtype=H.dtype, device=H.device)
    return model.EC.pressure(torch.clamp(H[..., None] - z, min=0.0))


@spatial("ch_temp", "K", "3D cryo-hydrologic system temperature")
def _chtemp3(state, model, t):
    if state.ch_enthalpy is None:
        return _zeros3(state, model)
    return model.EC.temperature(state.ch_enthalpy, _pressure3(state, model))


@spatial("ch_liqfrac", "1", "3D cryo-hydrologic system liquid water fraction")
def _chliqfrac3(state, model, t):
    if state.ch_enthalpy is None:
        return _zeros3(state, model)
    return model.EC.water_fraction(state.ch_enthalpy,
                                   _pressure3(state, model))


@spatial("ch_heat_flux", "W m-3",
         "3D cryo-hydrologic warming volumetric heat flux into the ice")
def _chheat3(state, model, t):
    em = getattr(model, "energy_model", None)
    if state.ch_enthalpy is None or state.enthalpy is None or em is None \
            or not em.ch_enabled:
        return _zeros3(state, model)
    EC, p = model.EC, _pressure3(state, model)
    dT = EC.temperature(state.ch_enthalpy, p) \
        - EC.temperature(state.enthalpy, p)
    return em.k_i * torch.clamp(dT, min=0.0) / em.ch_spacing ** 2


@spatial("age", "s", "age of the ice", "age_of_glacier_ice")
def _age3(state, model, t):
    return _zeros3(state, model) if state.age is None else state.age


@spatial("fracture_density", "1", "fracture density phase field")
def _fracdens(state, model, t):
    return state.fracture_density if state.fracture_density is not None \
        else _zeros2(state)


@spatial("fracture_age", "s", "age of the fractures")
def _fracage(state, model, t):
    return state.fracture_age if state.fracture_age is not None \
        else _zeros2(state)


@spatial("fracture_flow_enhancement", "1",
         "flow enhancement from fracture-induced softening")
def _fracenh(state, model, t):
    # the JAX package's later registration (model/diagnostics_ext.py:700),
    # with flow_enhancement's default exponent 3
    f = getattr(model, "fracture", None)
    if f is None or state.fracture_density is None:
        return torch.ones_like(state.geometry.ice_thickness)
    return f.flow_enhancement(state.fracture_density)


@spatial("isochrone_depth", "m",
         "depth below the ice surface of each tracked isochrone "
         "(last axis = deposition-time layer boundary)")
def _isochrone_depth(state, model, t):
    if state.iso_layers is None:
        H = state.geometry.ice_thickness
        return torch.zeros(tuple(H.shape) + (1,), dtype=torch.float64,
                           device=H.device)
    from .isochrones import isochrone_depth
    return isochrone_depth(state.iso_layers)


@spatial("shelfbmassflux", "kg m-2 s-1", "sub-shelf mass flux (melt positive)")
def _shelfbmf(state, model, t):
    if model.ocean is None:
        return _zeros2(state)
    return model.ocean(state.geometry, t) * model.rho_i


@spatial("shelfbtemp", "K", "ice temperature at the ice-shelf base")
def _shelfbtemp(state, model, t):
    if model.ocean is None:
        return _zeros2(state)
    return model.ocean.inputs(state.geometry, t).shelf_base_temperature


@spatial("dbdt_total", "m", "total bed displacement since initialization")
def _dbdt_total(state, model, t):
    if state.bed_reference is None:
        return _zeros2(state)
    return state.geometry.bed_elevation - state.bed_reference


@spatial("viscous_bed_displacement", "m",
         "Lingle-Clark viscous half-space bed displacement (model state)")
def _viscous_bed(state, model, t):
    if state.bed_uplift is None:
        return _zeros2(state)
    return state.bed_uplift


def _calving_front(state, model):
    from . import calving as cv
    mask = state.geometry.cell_type
    return cv.front_mask(S.icy(mask), mask == S.MASK_ICE_FREE_OCEAN,
                         model.sh)


def _ssa_uv(state):
    H = state.geometry.ice_thickness
    u = state.u_ssa if state.u_ssa is not None else torch.zeros_like(H)
    v = state.v_ssa if state.v_ssa is not None else torch.zeros_like(H)
    return u, v


@spatial("eigen_calving_rate", "m s-1",
         "horizontal calving rate due to eigen-calving")
def _eigen_calving_rate(state, model, t):
    cm = model.calving
    if cm is None or "eigen_calving" not in cm.methods:
        return _zeros2(state)
    u, v = _ssa_uv(state)
    l1, l2 = cm._strain_eigenvalues(u, v)
    rate = cm.eigen_K * torch.clamp(l1, min=0.0) * torch.clamp(l2, min=0.0)
    front = _calving_front(state, model)
    floating = S.floating_ice(state.geometry.cell_type)
    return torch.where(front & floating, rate, 0.0)


@spatial("vonmises_calving_rate", "m s-1",
         "horizontal calving rate due to von Mises calving")
def _vonmises_calving_rate(state, model, t):
    cm = model.calving
    if cm is None or "vonmises_calving" not in cm.methods \
            or model.ssa is None:
        return _zeros2(state)
    u, v = _ssa_uv(state)
    B = model.ssa._hardness(state)
    l1, l2 = cm._strain_eigenvalues(u, v)
    e1, e2 = torch.clamp(l1, min=0.0), torch.clamp(l2, min=0.0)
    eff = torch.sqrt(0.5 * (e1 ** 2 + e2 ** 2))
    sigma = math.sqrt(3.0) * B * eff ** (1.0 / cm.n_glen)
    speed = torch.sqrt(u ** 2 + v ** 2)
    rate = speed * sigma / cm.vm_sigma_max
    front = _calving_front(state, model)
    floating = S.floating_ice(state.geometry.cell_type)
    return torch.where(front & floating, rate, 0.0)


@spatial("hayhurst_calving_rate", "m s-1",
         "horizontal calving rate due to Hayhurst-stress calving")
def _hayhurst_calving_rate(state, model, t):
    cm = model.calving
    if cm is None or "hayhurst_calving" not in cm.methods:
        return _zeros2(state)
    rate = cm.hayhurst_rate(state.geometry)
    front = _calving_front(state, model)
    marine = state.geometry.sea_level - state.geometry.bed_elevation > 0.0
    return torch.where(front & marine, rate, 0.0)


@spatial("frontal_melt_rate", "m s-1", "frontal melt rate")
def _frontal_melt_rate(state, model, t):
    fm = getattr(model, "frontal_melt", None)
    if fm is None:
        return _zeros2(state)
    return fm(state.geometry, t, state=state)


@spatial("frontal_melt_retreat_rate", "m s-1",
         "retreat rate due to frontal melt, applied at marine front cells")
def _frontal_melt_retreat_rate(state, model, t):
    """The melt rate restricted to the front cells it erodes."""
    fm = getattr(model, "frontal_melt", None)
    cm = model.calving
    if fm is None or cm is None:
        return _zeros2(state)
    rate = torch.clamp(fm(state.geometry, t, state=state), min=0.0)
    front = _calving_front(state, model)
    marine = state.geometry.sea_level - state.geometry.bed_elevation > 0.0
    where = front & marine
    if not cm.fm_floating:
        where = where & ~S.floating_ice(state.geometry.cell_type)
    return torch.where(where, rate, 0.0)


@spatial("total_retreat_rate", "m s-1",
         "total horizontal retreat rate (all active calving laws + frontal "
         "melt) at front cells")
def _total_retreat_rate(state, model, t):
    return (_eigen_calving_rate(state, model, t)
            + _vonmises_calving_rate(state, model, t)
            + _hayhurst_calving_rate(state, model, t)
            + _frontal_melt_retreat_rate(state, model, t))


# -- subglacial hydrology ---------------------------------------------------

@spatial("bwat", "m", "transportable subglacial water thickness")
def _bwat(state, model, t):
    return state.hydro_W if state.hydro_W is not None else _zeros2(state)


@spatial("bwp", "Pa", "subglacial water pressure")
def _bwp(state, model, t):
    return state.hydro_P if state.hydro_P is not None else _zeros2(state)


@spatial("bwprel", "1", "water pressure as a fraction of overburden")
def _bwprel(state, model, t):
    H = state.geometry.ice_thickness
    if state.hydro_P is None:
        return _zeros2(state)
    P0 = model.rho_i * 9.81 * torch.clamp(H, min=1.0)
    return torch.where(H > 1.0, state.hydro_P / P0, 0.0)


@spatial("effbwp", "Pa", "effective pressure (overburden minus water pressure)")
def _effbwp(state, model, t):
    H = state.geometry.ice_thickness
    if state.hydro_P is None:
        return _zeros2(state)
    return torch.clamp(model.rho_i * 9.81 * H - state.hydro_P, min=0.0)


@spatial("hydraulic_potential", "Pa",
         "subglacial hydraulic potential psi = P + rho_w g (b + W)")
def _hydropot(state, model, t):
    P = state.hydro_P if state.hydro_P is not None else _zeros2(state)
    W = state.hydro_W if state.hydro_W is not None else _zeros2(state)
    return P + 1000.0 * 9.81 * (state.geometry.bed_elevation + W)


@spatial("bwatflux", "m2 s-1",
         "steady subglacial discharge per unit width (hydrology.model=steady)")
def _bwatflux(state, model, t):
    return state.hydro_Q if state.hydro_Q is not None else _zeros2(state)


def _routing_flux(state, model):
    """(hydrology, W, face gradients, face fluxes) of the routing family
    on the state's potential, or None without a routed layer."""
    hyd = model.hydrology
    W = state.hydro_W
    if W is None or hyd is None or not hasattr(hyd, "_face_gradients"):
        return None
    H = state.geometry.ice_thickness
    b = state.geometry.bed_elevation
    if state.hydro_P is not None:      # distributed: the evolving pressure
        psi = hyd.rho_w * hyd.g * b + state.hydro_P
    else:
        psi = hyd.rho_w * hyd.g * b + hyd.rho_i * hyd.g * H
    grads = hyd._face_gradients(psi)
    return hyd, W, grads, hyd._fluxes(W, grads)


def _bwatvel(state, model):
    """The routed water's velocity q/W at cell centres (PISM
    ``bwatvel``); zero without a routed layer."""
    r = _routing_flux(state, model)
    if r is None:
        return _zeros2(state), _zeros2(state)
    hyd, W, _, (qe, qn) = r
    sh = hyd.sh
    qx = 0.5 * (qe + sh(qe, 0, -1))
    qy = 0.5 * (qn + sh(qn, -1, 0))
    Ws = torch.clamp(W, min=1e-6)
    return qx / Ws, qy / Ws


@spatial("bwatvel_x", "m s-1", "x-velocity of subglacial transportable water")
def _bwatvel_x(state, model, t):
    return _bwatvel(state, model)[0]


@spatial("bwatvel_y", "m s-1", "y-velocity of subglacial transportable water")
def _bwatvel_y(state, model, t):
    return _bwatvel(state, model)[1]


@spatial("wallmelt", "m s-1",
         "melt rate from the dissipation of potential energy of the "
         "lateral subglacial water flow (ice equivalent)")
def _wallmelt(state, model, t):
    """The dissipation q . (-grad psi) per unit area, averaged from the
    faces to the cell centres, as an ice-equivalent melt rate (rho_i L)."""
    r = _routing_flux(state, model)
    if r is None:
        return _zeros2(state)
    hyd, _, (dpx, dpy, _, _), (qe, qn) = r
    sh = hyd.sh
    diss = 0.5 * (torch.clamp(-qe * dpx, min=0.0)
                  + torch.clamp(-sh(qe, 0, -1) * sh(dpx, 0, -1), min=0.0)) \
        + 0.5 * (torch.clamp(-qn * dpy, min=0.0)
                 + torch.clamp(-sh(qn, -1, 0) * sh(dpy, -1, 0), min=0.0))
    return diss / (model.EC.rho_i * model.EC.L0)


def _pico(model):
    from ..coupler.pico import Pico
    m = model.ocean
    while m is not None:   # through the modifiers' ``inner`` links
        if isinstance(m, Pico):
            return m
        m = getattr(m, "inner", None)
    return None


def _pico_solve(p, state, model, t):
    """The PICO solve of (state, t), run once for all the pico_* fields of
    one record (kept on the model with the state object itself, as
    ``_sb`` keeps the stress balance)."""
    cached = getattr(model, "_diag_pico_cache", None)
    if cached is not None and cached[0] is state and cached[1] == t:
        return cached[2]
    fields = p.solve(state.geometry, t)
    model._diag_pico_cache = (state, t, fields)
    return fields


def _pico_field(name, units, long_name, get):
    def fn(state, model, t):
        p = _pico(model)
        if p is None:
            return _zeros2(state)
        return get(_pico_solve(p, state, model, t), state)
    SPATIAL[name] = Diagnostic(fn, units, long_name)


for _args in (
        ("pico_box_mask", "", "PICO ocean box index (0 outside ice shelves)",
         lambda f, s: f.box),
        ("pico_temperature_box", "K", "PICO ocean box water temperature",
         lambda f, s: f.temperature),
        ("pico_salinity_box", "g kg-1", "PICO ocean box water salinity",
         lambda f, s: f.salinity),
        ("pico_overturning", "m3 s-1", "PICO basin overturning flux",
         lambda f, s: f.overturning),
        ("pico_contshelf_mask", "",
         "PICO continental-shelf averaging domain mask",
         lambda f, s: f.contshelf.to(s.geometry.ice_thickness.dtype)),
        ("pico_basal_melt_rate", "m s-1",
         "PICO sub-shelf melt rate (ice equivalent)", lambda f, s: f.melt),
        ("pico_basal_temperature", "K", "PICO shelf-base temperature",
         lambda f, s: f.T_basal)):
    _pico_field(*_args)


@spatial("pico_shelf_mask", "",
         "ice-shelf numbering (connected floating components)")
def _pico_shelf_mask(state, model, t):
    """Connected floating components by a min-label flood fill, numbered
    1..n in the order of their smallest cell index."""
    from ..util.hostsync import fixed_point
    g = state.geometry
    shelf = S.floating_ice(g.cell_type)
    My, Mx = shelf.shape
    idx = torch.arange(1, My * Mx + 1, dtype=torch.float32,
                       device=shelf.device).reshape(My, Mx)
    big = 4.0e9
    sh = model.sh

    def sweep(lab):
        nbr = torch.minimum(torch.minimum(sh(lab, 0, 1), sh(lab, 0, -1)),
                            torch.minimum(sh(lab, 1, 0), sh(lab, -1, 0)))
        return torch.where(shelf, torch.minimum(lab, nbr), lab)

    # the JAX loop runs until nothing changes: no iteration bound
    lab = fixed_point(sweep, torch.where(shelf, idx, big), math.inf)
    flat = torch.where(shelf, lab, big).ravel()
    uniq = torch.unique(flat)   # sorted; ``big`` last, as JAX's padding
    rank_of = torch.searchsorted(uniq, flat)
    out = (rank_of + 1).reshape(My, Mx)
    return torch.where(shelf, out, 0).to(g.ice_thickness.dtype)


@spatial("pico_basin_mask", "", "PICO drainage basin index")
def _pico_basin(state, model, t):
    p = _pico(model)
    if p is None or p.basin_mask is None:
        return _zeros2(state)
    return torch.as_tensor(p.basin_mask).to(
        device=state.geometry.ice_thickness.device,
        dtype=state.geometry.ice_thickness.dtype)


# --------------------------------------------------------------------------
# scalar time series
# --------------------------------------------------------------------------

@scalar("ice_volume", "m3", "total ice volume")
def _vol(state, model, t):
    g = model.grid
    return torch.sum(state.geometry.ice_thickness) * g.dx * g.dy


@scalar("ice_volume_glacierized", "m3", "ice volume in cells above the icy threshold")
def _volg(state, model, t):
    g = model.grid
    H = state.geometry.ice_thickness
    return torch.sum(torch.where(S.icy(state.geometry.cell_type), H, 0.0)) \
        * g.dx * g.dy


@scalar("ice_area_glacierized", "m2", "glacierized area")
def _area(state, model, t):
    g = model.grid
    return torch.sum(S.icy(state.geometry.cell_type).to(
        state.geometry.ice_thickness.dtype)) * g.dx * g.dy


@scalar("max_velocity", "m s-1", "maximum vertically-integrated speed")
def _umax(state, model, t):
    return torch.max(_velbar(state, model, t))


def compute_spatial(names, state, model, t):
    return {n: SPATIAL[n].func(state, model, t) for n in names}


def compute_scalar(names, state, model, t):
    """{name: float}: the scalars of ``names`` in one host transfer."""
    if not names:
        return {}
    vals = torch.stack([SCALAR[n].func(state, model, t).to(torch.float64)
                        for n in names]).tolist()
    return dict(zip(names, vals))


# --------------------------------------------------------------------------
# interval-averaged rates (PISM TSDiagnostic rate quantities): averages
# over the reporting window [t_prev, t] of StepStats' volume sums, with CF
# cell_methods "time: mean" and a time_bnds variable
# --------------------------------------------------------------------------

class Window(NamedTuple):
    """Reporting-window deltas for rate diagnostics (all volumes in m^3)."""
    dt: float            # window length [s]
    d_volume: float      # change of total ice volume
    d_smb: float         # time-integrated applied surface mass balance
    d_bmb: float         # time-integrated applied basal mass balance
    d_flow: float        # time-integrated flux-divergence volume
    d_nonneg: float      # time-integrated non-negativity (projection) volume
    d_discharge: float   # volume change by calving/front retreat (<= 0 loss)
    rho_i: float         # ice density [kg m-3]
    d_nsteps: float = 0.0  # adaptive time steps taken in the window
    d_calving: float = 0.0
    d_frontal_melt: float = 0.0
    d_forced_retreat: float = 0.0
    d_volume_glacierized: float = 0.0


_RATES = (
    ("tendency_of_ice_volume", "m3 s-1",
     "rate of change of ice volume over the reporting interval", "",
     lambda w: w.d_volume / w.dt),
    ("tendency_of_ice_mass", "kg s-1",
     "rate of change of ice mass over the reporting interval", "",
     lambda w: w.rho_i * w.d_volume / w.dt),
    ("tendency_of_ice_volume_glacierized", "m3 s-1",
     "rate of change of the volume of ice thicker than the glacierized "
     "threshold over the reporting interval", "",
     lambda w: w.d_volume_glacierized / w.dt),
    ("tendency_of_ice_mass_glacierized", "kg s-1",
     "rate of change of the mass of ice thicker than the glacierized "
     "threshold over the reporting interval", "",
     lambda w: w.rho_i * w.d_volume_glacierized / w.dt),
    ("dt", "s",
     "mean length of the adaptive time steps in the reporting interval", "",
     lambda w: w.dt / max(float(w.d_nsteps), 1.0)),
    ("tendency_of_ice_volume_due_to_surface_mass_flux", "m3 s-1",
     "average surface mass balance volume rate", "",
     lambda w: w.d_smb / w.dt),
    ("tendency_of_ice_mass_due_to_surface_mass_flux", "kg s-1",
     "average surface mass balance mass rate",
     "tendency_of_land_ice_mass_due_to_surface_mass_balance",
     lambda w: w.rho_i * w.d_smb / w.dt),
    # StepStats.sum_bmb is positive for melt (ice removed)
    ("tendency_of_ice_volume_due_to_basal_mass_flux", "m3 s-1",
     "average basal mass balance volume rate (negative = melt)", "",
     lambda w: -w.d_bmb / w.dt),
    ("tendency_of_ice_mass_due_to_basal_mass_flux", "kg s-1",
     "average basal mass balance mass rate (negative = melt)",
     "tendency_of_land_ice_mass_due_to_basal_mass_balance",
     lambda w: -w.rho_i * w.d_bmb / w.dt),
    ("tendency_of_ice_volume_due_to_flow", "m3 s-1",
     "average volume rate of change due to flow (negative flux divergence)",
     "", lambda w: -w.d_flow / w.dt),
    ("tendency_of_ice_mass_due_to_flow", "kg s-1",
     "average mass rate of change due to flow (negative flux divergence)",
     "", lambda w: -w.rho_i * w.d_flow / w.dt),
    ("tendency_of_ice_volume_due_to_discharge", "m3 s-1",
     "average volume rate of change by calving and front retreat", "",
     lambda w: w.d_discharge / w.dt),
    ("tendency_of_ice_mass_due_to_discharge", "kg s-1",
     "average mass rate of change by calving and front retreat",
     "tendency_of_land_ice_mass_due_to_calving_and_ice_front_melting",
     lambda w: w.rho_i * w.d_discharge / w.dt),
    ("tendency_of_ice_mass_due_to_calving", "kg s-1",
     "average mass rate of change by calving (incl. iceberg removal)",
     "tendency_of_land_ice_mass_due_to_calving",
     lambda w: w.rho_i * w.d_calving / w.dt),
    ("tendency_of_ice_volume_due_to_calving", "m3 s-1",
     "average volume rate of change by calving (incl. iceberg removal)", "",
     lambda w: w.d_calving / w.dt),
    ("tendency_of_ice_mass_due_to_frontal_melt", "kg s-1",
     "average mass rate of change by frontal-melt-driven retreat", "",
     lambda w: w.rho_i * w.d_frontal_melt / w.dt),
    ("tendency_of_ice_mass_due_to_forced_retreat", "kg s-1",
     "average mass rate of change by prescribed front retreat", "",
     lambda w: w.rho_i * w.d_forced_retreat / w.dt),
    ("tendency_of_ice_volume_due_to_conservation_error", "m3 s-1",
     "average volume rate of the non-negativity projection", "",
     lambda w: w.d_nonneg / w.dt),
    ("tendency_of_ice_mass_due_to_conservation_error", "kg s-1",
     "average mass rate of the non-negativity projection", "",
     lambda w: w.rho_i * w.d_nonneg / w.dt),
    # the volume forms of the last two discharge parts (mass / rho_i)
    ("tendency_of_ice_volume_due_to_frontal_melt", "m3 s-1",
     "average volume rate of change by frontal-melt-driven retreat", "",
     lambda w: w.rho_i * w.d_frontal_melt / w.dt / w.rho_i),
    ("tendency_of_ice_volume_due_to_forced_retreat", "m3 s-1",
     "average volume rate of change by prescribed front retreat", "",
     lambda w: w.rho_i * w.d_forced_retreat / w.dt / w.rho_i),
)
for _name, _units, _ln, _sn, _fn in _RATES:
    RATE[_name] = Diagnostic(_fn, _units, _ln, _sn)


def compute_rates(names, window: Window):
    return {n: RATE[n].func(window) for n in names}


class Window2D(NamedTuple):
    """Per-cell reporting-window deltas (thickness changes in m)."""
    dt: float
    d_thickness: object     # H(t) - H(t_prev)
    d_flow: object
    d_smb: object
    d_bmb: object
    d_nonneg: object
    d_discharge: object
    rho_i: float
    d_calving: object = None        # discharge split per mechanism
    d_frontal_melt: object = None
    d_forced_retreat: object = None
    d_topg: object = None   # topg(t) - topg(t_prev), for dbdt
    d_water: object = None  # tillwat + bwat at t, less the previous [m]
    cell_area: float = 1.0  # m2, for the per-cell kg s-1 "mass" variants


_AMOUNTS = (
    ("tendency_of_ice_amount", "d_thickness",
     "rate of change of ice amount over the reporting interval", "",
     "rate of change of ice mass per cell over the reporting interval"),
    ("tendency_of_ice_amount_due_to_flow", "d_flow",
     "average ice-amount rate of change due to flow", "",
     "average per-cell ice-mass rate of change due to flow"),
    ("tendency_of_ice_amount_due_to_surface_mass_flux", "d_smb",
     "average effective surface mass flux",
     "land_ice_surface_specific_mass_balance_flux",
     "average per-cell effective surface mass flux"),
    ("tendency_of_ice_amount_due_to_basal_mass_flux", "d_bmb",
     "average effective basal mass flux (negative = melt)",
     "land_ice_basal_specific_mass_balance_flux",
     "average per-cell effective basal mass flux (negative = melt)"),
    ("tendency_of_ice_amount_due_to_conservation_error", "d_nonneg",
     "average non-negativity projection rate", "",
     "average per-cell non-negativity projection mass rate"),
    ("tendency_of_ice_amount_due_to_discharge", "d_discharge",
     "average ice-amount rate of change by calving and front retreat",
     "land_ice_specific_mass_flux_due_to_calving_and_ice_front_melting",
     "average per-cell mass rate of change by calving and front retreat"),
    ("tendency_of_ice_amount_due_to_calving", "d_calving",
     "average ice-amount rate of change by calving",
     "land_ice_specific_mass_flux_due_to_calving",
     "average per-cell mass rate of change by calving"),
    ("tendency_of_ice_amount_due_to_frontal_melt", "d_frontal_melt",
     "average ice-amount rate of change by frontal-melt retreat", "",
     "average per-cell mass rate of change by frontal-melt retreat"),
    ("tendency_of_ice_amount_due_to_forced_retreat", "d_forced_retreat",
     "average ice-amount rate of change by prescribed front retreat", "",
     "average per-cell mass rate of change by prescribed front retreat"),
)
for _name, _field, _ln, _sn, _ln_mass in _AMOUNTS:
    def _amount(w, _field=_field):
        return w.rho_i * getattr(w, _field) / w.dt
    SPATIAL_RATE[_name] = Diagnostic(_amount, "kg m-2 s-1", _ln, _sn)
    # the per-cell "mass" variant (kg s-1) of every budget field
    SPATIAL_RATE[_name.replace("ice_amount", "ice_mass")] = Diagnostic(
        lambda w, _amount=_amount: _amount(w) * w.cell_area, "kg s-1",
        _ln_mass)


@spatial_rate("dbdt", "m s-1", "bedrock uplift rate",
              "tendency_of_bedrock_altitude")
def _dbdt(w):
    if w.d_topg is None:
        return torch.zeros_like(torch.as_tensor(w.d_thickness))
    return w.d_topg / w.dt


@spatial_rate("tendency_of_subglacial_water_mass", "kg m-2 s-1",
              "rate of change of the total subglacial water amount "
              "(transportable + till) over the reporting interval")
def _dwater(w):
    if w.d_water is None:
        return torch.zeros_like(torch.as_tensor(w.d_thickness))
    return 1000.0 * w.d_water / w.dt


def compute_spatial_rates(names, window: Window2D):
    return {n: SPATIAL_RATE[n].func(window) for n in names}


#: vector diagnostics: a combined name in ``-extra_vars`` expands to its
#: component variables (asking for ``velbar`` writes ``ubar`` and ``vbar``)
VECTOR: Dict[str, tuple] = {
    "velbar": ("ubar", "vbar"),
    "velsurf": ("uvelsurf", "vvelsurf"),
    "velbase": ("uvelbase", "vvelbase"),
    "vel_bc_values": ("u_bc", "v_bc"),
    "flux": ("uflux", "vflux"),
    "bwatvel": ("bwatvel_x", "bwatvel_y"),
    "taud": ("taud_x", "taud_y"),
    "taub": ("taub_x", "taub_y"),
    "strain_rates": ("eigen1", "eigen2"),
    "deviatoric_stresses": ("sigma_xx", "sigma_yy", "sigma_xy"),
    "flux_staggered": ("flux_staggered_e", "flux_staggered_n"),
    "diffusivity_staggered": ("diffusivity_staggered_e",
                              "diffusivity_staggered_n"),
    "surface_gradient": ("h_x", "h_y"),
    "vel3": ("uvel", "vvel", "wvel_rel"),
}


def expand_names(names):
    """Expand vector names to their components, in order, without
    repeats."""
    seen, out = set(), []
    for n in names:
        for c in VECTOR.get(n, (n,)):
            if c not in seen:
                seen.add(c)
                out.append(c)
    return tuple(out)


def require_known(names, tables, option):
    """Raise NotImplementedError for a name that none of ``tables`` holds:
    the port registers the diagnostics of its routes' default outputs, and
    the rest of the JAX package's registry is ROADMAP Queue 1 item 4."""
    missing = [n for n in names if not any(n in tab for tab in tables)]
    if missing:
        raise NotImplementedError(
            f"{option} {', '.join(missing)}: not in pism_tpu_torch's "
            "diagnostics registry (the rest of model/diagnostics.py is "
            "ROADMAP Queue 1 item 4)")
