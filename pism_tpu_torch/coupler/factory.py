"""Coupler factories: atmosphere, surface, ocean and sea-level chains from
config strings (port of ``pism_tpu/coupler/factory.py``; PISM
``src/coupler/util/PCFactory.hh``).

A chain is ``base,modifier,...`` (``-atmosphere searise_greenland,delta_T
-surface pdd``): the first entry is the base model, the rest wrap it left
to right. The factory functions take an ``inputs`` dict of loaded fields
(tensors on the model's device), host time axes and forcing callables;
``inputs_from_files`` fills it from the files the config names. The port
builds every name the JAX package builds:

- atmosphere ``uniform``, ``given``, ``searise_greenland``,
  ``yearly_cycle``, ``pik``, ``one_station``; modifiers
  ``elevation_change``, ``delta_T``, ``delta_P``, ``frac_P``,
  ``precip_scaling``, ``anomaly``, ``orographic_precipitation``;
- surface ``simple``, ``uniform``, ``given``, ``elevation``, ``pdd``,
  ``debm_simple``, ``pik``, ``ismip6``; modifiers ``anomaly``, ``delta_T``,
  ``cache``, ``elevation_change``, ``force_to_thickness``;
- ocean ``constant``, ``pik``, ``th``, ``given``, ``pico``; modifiers
  ``anomaly``, ``delta_T``, ``delta_SMB``, ``frac_SMB``, ``runoff_SMB``,
  ``frac_MBP``, ``delta_MBP``, ``cache`` (and the melange back pressure of
  ``ocean.melange_back_pressure_fraction``);
- sea level ``constant``; modifiers ``delta_sl``, ``delta_sl_2d``;
- the fields of the frontal-melt models (``coupler/frontalmelt.py``),
  group ``frontal_melt`` of ``inputs_from_files``.

A name neither package knows raises ValueError, as in the JAX package.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..config.parameters import PARAMETERS
from . import atmosphere as _atm
from . import ocean as _ocn
from . import sealevel as _sl
from . import surface as _srf


def _split(chain: str):
    parts = [p.strip() for p in chain.split(",") if p.strip()]
    if not parts:
        raise ValueError("empty coupler model chain")
    return parts[0], parts[1:]


def _need(inputs: Mapping, key: str, model: str):
    if key not in inputs:
        raise ValueError(f"coupler model {model!r} requires input {key!r}")
    return inputs[key]


def _fdt(config):
    return torch.float32 \
        if config.get_string("runtime.float_dtype") == "float32" \
        else torch.float64


def stack_period(config, prefix, times):
    """Forcing period [s] of a time-stack coupler: ``<prefix>.period`` if
    set, else with ``<prefix>.periodic`` the series' extent plus one mean
    spacing (a 12-entry monthly climatology cycles yearly)."""
    period = 0.0
    pkey = prefix + ".period"
    if pkey in PARAMETERS:
        period = config.get_number(pkey, "seconds")
    fkey = prefix + ".periodic"
    if period == 0.0 and fkey in PARAMETERS and config.get_flag(fkey) \
            and times is not None and len(times) > 1:
        t = np.asarray(times, float)
        period = float((t[-1] - t[0]) * len(t) / (len(t) - 1))
    return period


# ---------------------------------------------------------------- atmosphere
def atmosphere_from_config(config, inputs: Optional[Mapping] = None,
                           grid=None):
    """The atmosphere chain of ``atmosphere.models``. Inputs: ``given``
    (air_temp, precipitation [, air_temp_summer, times]),
    ``searise_greenland`` (latitude, longitude, precipitation), ``pik``
    (latitude, precipitation), ``yearly_cycle`` (air_temp_mean_annual,
    air_temp_mean_summer, precipitation [, scaling]), ``one_station``
    (air_temp, precipitation: callables of model time); modifiers
    ``elevation_change`` (reference_surface), ``delta_T``, ``delta_P``,
    ``frac_P``, ``precip_scaling`` (delta_T) (callables), ``anomaly``
    (air_temp_anomaly / precipitation_anomaly [, anomaly_times]),
    ``orographic_precipitation`` (needs ``grid``)."""
    inputs = inputs or {}
    base, mods = _split(config.get_string("atmosphere.models"))
    if base == "uniform":
        # precipitation is configured as a mass flux; internally it is
        # ice-equivalent m/s (divided by the ice density)
        rho_i = config.get_number("constants.ice.density")
        model = _atm.Uniform(
            temperature=config.get_number("atmosphere.uniform.temperature"),
            precipitation=config.get_number(
                "atmosphere.uniform.precipitation", "kg m-2 s-1") / rho_i)
    elif base == "given":
        model = _atm.Given(
            temperature=_need(inputs, "air_temp", base),
            precipitation=_need(inputs, "precipitation", base),
            temperature_july=inputs.get("air_temp_summer"),
            times=inputs.get("times"),
            period=stack_period(config, "atmosphere.given",
                                inputs.get("times")))
    elif base == "searise_greenland":
        model = _atm.SeariseGreenland(
            latitude=_need(inputs, "latitude", base),
            longitude=_need(inputs, "longitude", base),
            precipitation=_need(inputs, "precipitation", base),
            config=config)
    elif base == "yearly_cycle":
        model = _atm.CosineYearlyCycle(
            temperature_mean_annual=_need(inputs, "air_temp_mean_annual",
                                          base),
            temperature_mean_summer=_need(inputs, "air_temp_mean_summer",
                                          base),
            precipitation=_need(inputs, "precipitation", base),
            scaling=inputs.get("scaling"))
    elif base == "pik":
        model = _atm.PIK(
            latitude=_need(inputs, "latitude", base),
            precipitation=_need(inputs, "precipitation", base),
            parameterization=config.get_string(
                "atmosphere.pik.parameterization"))
    elif base == "one_station":
        model = _atm.WeatherStation(
            temperature=_need(inputs, "air_temp", base),
            precipitation=_need(inputs, "precipitation", base))
    else:
        raise ValueError(f"unknown atmosphere model {base!r}")
    model.summer_peak_day = config.get_number(
        "atmosphere.fausto_air_temp.summer_peak_day")
    for mod in mods:
        if mod == "elevation_change":
            method = config.get_string(
                "atmosphere.elevation_change.precipitation.method")
            model = _atm.ElevationChange(
                inner=model,
                reference_surface=_need(inputs, "reference_surface", mod),
                lapse_rate=config.get_number(
                    "atmosphere.elevation_change.temperature_lapse_rate"),
                precip_scale_factor=config.get_number(
                    "atmosphere.precip_exponential_factor_for_temperature")
                if method == "scale" else 0.0,
                precip_lapse_rate=config.get_number(
                    "atmosphere.elevation_change.precipitation.lapse_rate")
                if method == "shift" else 0.0)
        elif mod == "delta_T":
            model = _atm.DeltaT(inner=model,
                                offset=_need(inputs, "delta_T", mod))
        elif mod == "delta_P":
            model = _atm.DeltaP(inner=model,
                                offset=_need(inputs, "delta_P", mod))
        elif mod == "frac_P":
            model = _atm.FracP(inner=model,
                               fraction=_need(inputs, "frac_P", mod))
        elif mod == "precip_scaling":
            model = _atm.PrecipitationScaling(
                inner=model, delta_T=_need(inputs, "delta_T", mod),
                exp_factor=config.get_number(
                    "atmosphere.precip_exponential_factor_for_temperature"))
        elif mod == "anomaly":
            model = _atm.Anomaly(
                inner=model,
                temp_anomaly=inputs.get("air_temp_anomaly"),
                precip_anomaly=inputs.get("precipitation_anomaly"),
                times=inputs.get("anomaly_times"),
                period=stack_period(config, "atmosphere.anomaly",
                                    inputs.get("anomaly_times")))
        elif mod == "orographic_precipitation":
            from .orographic import OrographicModifier, orographic_from_config
            if grid is None:
                raise ValueError(
                    "atmosphere modifier 'orographic_precipitation' needs "
                    "the grid (FFT wavenumbers)")
            model = OrographicModifier(
                inner=model, ltop=orographic_from_config(grid, config))
        else:
            raise ValueError(f"unknown atmosphere modifier {mod!r}")
    return model


# ---------------------------------------------------------------- surface
def _ismip6_from_files(config, grid, device):
    """``-surface ismip6`` from the protocol's files: the reference climate
    (surface.ismip6.reference_file) and the anomaly and elevation-gradient
    stacks (surface.ismip6.file)."""
    from ..io.bootstrap import read_forcing_fields
    ref_path = config.get_string("surface.ismip6.reference_file")
    frc_path = config.get_string("surface.ismip6.file")
    if not ref_path or not frc_path or grid is None:
        raise ValueError(
            "surface model 'ismip6' needs surface.ismip6.file and "
            "surface.ismip6.reference_file (CLI) or a prebuilt "
            "inputs['ismip6_model']")
    ref, _ = read_forcing_fields(ref_path, grid,
                                 ["climatic_mass_balance", "ice_surface_temp",
                                  "usurf", "surface_altitude"])
    frc, a_times = read_forcing_fields(
        frc_path, grid, ["climatic_mass_balance_anomaly",
                         "ice_surface_temp_anomaly",
                         "climatic_mass_balance_gradient",
                         "ice_surface_temp_gradient"],
        calendar=config.get_string("time.calendar"),
        reference_date=config.get_string("time.reference_date"))

    def field(d, *names):
        for n in names:
            if n in d:
                # the JAX package loads these as float64
                return torch.as_tensor(np.nan_to_num(d[n])).to(
                    device=device, dtype=torch.float64)
        return None

    return _srf.ISMIP6(
        smb_ref=field(ref, "climatic_mass_balance"),
        temperature_ref=field(ref, "ice_surface_temp"),
        surface_ref=field(ref, "usurf", "surface_altitude"),
        anomaly_times=a_times,
        a_smb=field(frc, "climatic_mass_balance_anomaly"),
        a_temp=field(frc, "ice_surface_temp_anomaly"),
        dsmb_dz=field(frc, "climatic_mass_balance_gradient"),
        dtemp_dz=field(frc, "ice_surface_temp_gradient"))


def surface_from_config(config, inputs: Optional[Mapping] = None,
                        atmosphere=None):
    """The surface chain of ``surface.models``: ``simple``, ``pdd`` (on
    ``atmosphere``; air_temp_sd, latitude), ``debm_simple`` (on
    ``atmosphere``; latitude [, albedo, paleo_times with eccentricity,
    obliquity, perihelion_longitude]), ``pik`` (on ``atmosphere``;
    latitude), ``uniform``, ``elevation``, ``given`` (climatic_mass_balance,
    ice_surface_temp [, times]), ``ismip6`` (inputs["ismip6_model"], or its
    files, inputs["_grid"] and inputs["_device"]); modifiers ``anomaly``, ``delta_T``,
    ``cache``, ``elevation_change`` (reference_surface),
    ``force_to_thickness`` (target_thickness)."""
    inputs = inputs or {}
    base, mods = _split(config.get_string("surface.models"))

    def need_atm(name):
        if atmosphere is None:
            raise ValueError(f"surface model {name!r} needs an atmosphere model")
        return atmosphere

    if base == "simple":
        model = _srf.Simple(atmosphere=need_atm(base))
    elif base == "uniform":
        model = _srf.Uniform()
    elif base == "given":
        model = _srf.Given(
            smb_field=_need(inputs, "climatic_mass_balance", base),
            temperature_field=_need(inputs, "ice_surface_temp", base),
            times=inputs.get("times"),
            period=stack_period(config, "surface.given",
                                inputs.get("times")))
    elif base == "elevation":
        model = _srf.ElevationDependent(
            z_min=config.get_number("surface.elevation_dependent.z_min"),
            z_ela=config.get_number("surface.elevation_dependent.z_ela"),
            z_max=config.get_number("surface.elevation_dependent.z_max"),
            m_min=config.get_number("surface.elevation_dependent.m_min",
                                    "m s-1"),
            m_max=config.get_number("surface.elevation_dependent.m_max",
                                    "m s-1"))
    elif base == "pdd":
        from .pdd import TemperatureIndex
        model = TemperatureIndex(atmosphere=need_atm(base), config=config,
                                 sigma_field=inputs.get("air_temp_sd"),
                                 latitude=inputs.get("latitude"))
    elif base == "debm_simple":
        from .debm import DEBMSimple
        paleo = None
        if "paleo_times" in inputs:
            deg = np.pi / 180.0
            paleo = (inputs["paleo_times"], inputs.get("eccentricity"),
                     np.asarray(inputs.get("obliquity")) * deg,
                     np.asarray(inputs.get("perihelion_longitude")) * deg)
        model = DEBMSimple(atmosphere=need_atm(base),
                           latitude=_need(inputs, "latitude", base),
                           config=config, albedo_field=inputs.get("albedo"),
                           paleo_series=paleo)
    elif base == "pik":
        model = _srf.PIK(atmosphere=need_atm(base),
                         latitude=_need(inputs, "latitude", base))
    elif base == "ismip6":
        model = inputs.get("ismip6_model")
        if model is None:
            grid = inputs.get("_grid")
            model = _ismip6_from_files(
                config, grid, inputs.get("_device", "cuda"))
    else:
        raise ValueError(f"unknown surface model {base!r}")
    for mod in mods:
        if mod == "anomaly":
            model = _srf.Anomaly(
                inner=model,
                smb_anomaly=inputs.get("climatic_mass_balance_anomaly"),
                temp_anomaly=inputs.get("ice_surface_temp_anomaly"),
                times=inputs.get("anomaly_times"),
                period=stack_period(config, "surface.anomaly",
                                    inputs.get("anomaly_times")))
        elif mod == "delta_T":
            model = _srf.DeltaT(inner=model,
                                offset=_need(inputs, "delta_T", mod))
        elif mod == "cache":
            model = _srf.Cache(inner=model, update_interval=config.get_number(
                "surface.cache.update_interval", "seconds"))
        elif mod == "elevation_change":
            method = config.get_string("surface.elevation_change.smb.method")
            model = _srf.ElevationChange(
                inner=model,
                reference_surface=_need(inputs, "reference_surface", mod),
                temp_lapse_rate=config.get_number(
                    "surface.elevation_change.temperature_lapse_rate"),
                smb_lapse_rate=config.get_number(
                    "surface.elevation_change.smb.lapse_rate")
                if method == "shift" else 0.0,
                smb_exp_factor=config.get_number(
                    "surface.elevation_change.smb.exp_factor")
                if method == "scale" else 0.0)
        elif mod == "force_to_thickness":
            model = _srf.ForceThickness(
                inner=model,
                target_thickness=_need(inputs, "target_thickness", mod),
                alpha=config.get_number("surface.force_to_thickness.alpha",
                                        "s-1"),
                ice_free_alpha_factor=config.get_number(
                    "surface.force_to_thickness.ice_free_alpha_factor"),
                start_time=config.get_number(
                    "surface.force_to_thickness.start_time", "seconds"))
        else:
            raise ValueError(f"unknown surface modifier {mod!r}")
    return model


# ---------------------------------------------------------------- ocean
def ocean_from_config(config, inputs: Optional[Mapping] = None, grid=None):
    """The ocean chain of ``ocean.models``: ``constant``, ``pik``, ``th``
    (theta_ocean, salinity_ocean [, times]), ``given``
    (shelf_base_mass_flux [, shelf_base_temperature, times]), ``pico``
    (theta_ocean, salinity_ocean [, basins, times]; needs ``grid``);
    modifiers ``anomaly`` (melt_anomaly [, anomaly_times]), ``delta_T``,
    ``delta_SMB``, ``frac_SMB``, ``runoff_SMB`` (delta_T), ``frac_MBP``,
    ``delta_MBP`` (callables of model time), ``cache``."""
    inputs = inputs or {}
    base, mods = _split(config.get_string("ocean.models"))
    if base == "constant":
        model = _ocn.Constant(config=config)
    elif base == "pik":
        model = _ocn.PIK(config=config)
    elif base == "th":
        model = _ocn.GivenTH(
            theta_ocean=_need(inputs, "theta_ocean", base),
            salinity_ocean=_need(inputs, "salinity_ocean", base),
            config=config, times=inputs.get("times"),
            period=stack_period(config, "ocean.th", inputs.get("times")))
    elif base == "given":
        model = _ocn.Given(
            melt_rate=_need(inputs, "shelf_base_mass_flux", base),
            temperature=inputs.get("shelf_base_temperature"),
            times=inputs.get("times"),
            period=stack_period(config, "ocean.given", inputs.get("times")))
    elif base == "pico":
        from .pico import Pico
        if grid is None:
            raise ValueError("ocean model 'pico' needs the grid")
        model = Pico(
            temperature_ocean=_need(inputs, "theta_ocean", base),
            salinity_ocean=_need(inputs, "salinity_ocean", base),
            config=config, basin_mask=inputs.get("basins"), grid=grid,
            times=inputs.get("times"),
            period=stack_period(config, "ocean.pico", inputs.get("times")))
    else:
        raise ValueError(f"unknown ocean model {base!r}")
    for mod in mods:
        if mod == "anomaly":
            model = _ocn.Anomaly(
                inner=model, anomaly=_need(inputs, "melt_anomaly", mod),
                times=inputs.get("anomaly_times"),
                period=stack_period(config, "ocean.anomaly",
                                    inputs.get("anomaly_times")))
        elif mod == "delta_T":
            model = _ocn.DeltaT(inner=model,
                                offset=_need(inputs, "delta_T", mod))
        elif mod == "delta_SMB":
            model = _ocn.DeltaSMB(inner=model,
                                  offset=_need(inputs, "delta_SMB", mod))
        elif mod == "frac_SMB":
            model = _ocn.FracSMB(inner=model,
                                 fraction=_need(inputs, "frac_SMB", mod))
        elif mod == "runoff_SMB":
            model = _ocn.RunoffSMB(
                inner=model, delta_T=_need(inputs, "delta_T", mod),
                temp_to_runoff_a=config.get_number(
                    "ocean.runoff_to_ocean_melt.temp_to_runoff_a"),
                melt_factor_B=config.get_number(
                    "ocean.runoff_to_ocean_melt_factor"),
                alpha=config.get_number(
                    "ocean.runoff_to_ocean_melt_power_alpha"),
                beta=config.get_number(
                    "ocean.runoff_to_ocean_melt_power_beta"))
        elif mod == "frac_MBP":
            model = _ocn.FracMBP(inner=model,
                                 fraction=_need(inputs, "frac_MBP", mod))
        elif mod == "delta_MBP":
            model = _ocn.DeltaMBP(inner=model,
                                  offset=_need(inputs, "delta_MBP", mod))
        elif mod == "cache":
            model = _ocn.Cache(inner=model, update_interval=config.get_number(
                "ocean.cache.update_interval", "seconds"))
        else:
            raise ValueError(f"unknown ocean modifier {mod!r}")
    # -melange_back_pressure_fraction: a constant melange back pressure,
    # unless a back-pressure modifier is in the chain already
    mbp = config.get_number("ocean.melange_back_pressure_fraction")
    if mbp > 0.0 and "frac_MBP" not in mods and "delta_MBP" not in mods:
        model = _ocn.FracMBP(inner=model, fraction=lambda t, _f=mbp: _f)
    return model


# ---------------------------------------------------------------- sea level
def sea_level_from_config(config, inputs: Optional[Mapping] = None):
    """The sea-level chain of ``sea_level.models``: ``constant``; modifiers
    ``delta_sl`` (a callable of model time), ``delta_sl_2d`` (delta_SL_2D
    [, delta_SL_2D_times])."""
    inputs = inputs or {}
    base, mods = _split(config.get_string("sea_level.models"))
    if base != "constant":
        raise ValueError(f"unknown sea level model {base!r}")
    model = _sl.Constant(value=config.get_number("sea_level.constant.value")
                         + config.get_number("sea_level.constant.delta_SL"))
    for mod in mods:
        if mod == "delta_sl":
            model = _sl.DeltaSL(inner=model,
                                offset=_need(inputs, "delta_SL", mod))
        elif mod == "delta_sl_2d":
            model = _sl.DeltaSL2D(
                inner=model, offset_field=_need(inputs, "delta_SL_2D", mod),
                times=inputs.get("delta_SL_2D_times"),
                period=stack_period(config, "sea_level.delta_sl_2d",
                                    inputs.get("delta_SL_2D_times")))
        else:
            raise ValueError(f"unknown sea level modifier {mod!r}")
    return model


# ---------------------------------------------------------------- files
def inputs_from_files(config, grid, group: str, device="cuda") -> dict:
    """The ``inputs`` of a coupler group from the forcing files its config
    names: spatial fields regridded onto the model grid, converted to
    internal units and cast to the field dtype on ``device`` (a time
    stack's ``times`` stay a host array); scalar series as
    ``util.forcing.ScalarForcing``."""
    from ..io.bootstrap import read_forcing_fields
    from ..io.nc4 import File
    from ..util.forcing import ScalarForcing
    from ..util.units import SEC_PER_YEAR

    inputs = {}
    fdt = _fdt(config)
    cal = config.get_string("time.calendar")
    ref = config.get_string("time.reference_date")

    def tensor(a, dtype=fdt):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    def spatial(file_key, variables):
        path = config.get_string(file_key)
        if not path:
            return
        fields, times = read_forcing_fields(path, grid, variables,
                                            calendar=cal, reference_date=ref)
        for k, v in fields.items():
            if np.isnan(v).any():
                # a forcing file that does not cover the model grid
                raise ValueError(
                    f"forcing variable {k!r} from {path!r} does not cover "
                    "the model grid (regrid produced NaNs)")
            inputs[k] = tensor(v)
        if times is not None:
            inputs["times"] = times

    def scalar(file_key, input_key, variable=None):
        path = config.get_string(file_key)
        if path:
            # every scalar forcing has a sibling ".periodic" flag
            pkey = file_key[:-len(".file")] + ".periodic"
            periodic = pkey in PARAMETERS and config.get_flag(pkey)
            inputs[input_key] = ScalarForcing.from_file(
                path, variable or input_key, periodic=periodic, calendar=cal,
                reference_date=ref)

    def anomaly(file_key, variables, one_key=None):
        """An anomaly stack with its own time axis (``anomaly_times``);
        ``one_key``: the first of ``variables`` found goes in under it."""
        path = config.get_string(file_key)
        if not path:
            return
        fields, a_times = read_forcing_fields(path, grid, variables,
                                              calendar=cal,
                                              reference_date=ref)
        for k in variables:
            if k in fields:
                inputs[one_key or k] = tensor(fields[k])
                if one_key:
                    break
        if a_times is not None:
            inputs["anomaly_times"] = a_times

    def last_record(file_key, variables, key, calendar=False, nan=False):
        """The first of ``variables`` in the file (a stack: its last
        record) under ``key``."""
        path = config.get_string(file_key)
        if not path:
            return
        kw = dict(calendar=cal, reference_date=ref) if calendar else {}
        fields, _ = read_forcing_fields(path, grid, variables, **kw)
        for k in variables:
            if k in fields:
                a = fields[k]
                a = a[-1] if a.ndim == 3 else a
                inputs.setdefault(key, tensor(np.nan_to_num(a) if nan else a))
                break

    if group == "atmosphere":
        spatial("atmosphere.given.file",
                ["air_temp", "precipitation", "air_temp_summer"])
        # the SeaRISE-Greenland inputs (lat/lon/precipitation)
        spatial("atmosphere.searise_greenland.file",
                ["latitude", "longitude", "precipitation", "lat", "lon"])
        for short, full in (("lat", "latitude"), ("lon", "longitude")):
            if short in inputs:
                inputs.setdefault(full, inputs.pop(short))
        spatial("atmosphere.yearly_cycle.file",
                ["air_temp_mean_annual", "air_temp_mean_summer",
                 "air_temp_mean_july", "precipitation"])
        if "air_temp_mean_july" in inputs:
            inputs.setdefault("air_temp_mean_summer",
                              inputs.pop("air_temp_mean_july"))
        scalar("atmosphere.yearly_cycle.scaling.file", "scaling",
               "amplitude_scaling")
        anomaly("atmosphere.anomaly.file",
                ["air_temp_anomaly", "precipitation_anomaly"])
        last_record("atmosphere.elevation_change.file",
                    ["usurf", "surface_altitude", "surface"],
                    "reference_surface")
        path = config.get_string("atmosphere.one_station.file")
        if path:
            inputs.setdefault("air_temp",
                              ScalarForcing.from_file(path, "air_temp"))
            inputs.setdefault("precipitation",
                              ScalarForcing.from_file(path, "precipitation"))
        scalar("atmosphere.delta_T.file", "delta_T")
        scalar("atmosphere.delta_P.file", "delta_P")
        scalar("atmosphere.frac_P.file", "frac_P")
        scalar("atmosphere.precip_scaling.file", "scaling_delta_T", "delta_T")
    elif group == "surface":
        # surface.given.smb_max: an error on implausible SMB magnitudes
        # (unit mistakes in forcing files)
        smb_cap = (config.get_number("surface.given.smb_max", "kg m-2 s-1")
                   / config.get_number("constants.ice.density"))
        spatial("surface.given.file",
                ["climatic_mass_balance", "ice_surface_temp"])
        if "climatic_mass_balance" in inputs:
            m = float(inputs["climatic_mass_balance"].abs().max())
            if m > smb_cap:
                raise ValueError(
                    f"surface.given.file SMB magnitude {m:.3e} m/s exceeds "
                    f"surface.given.smb_max ({smb_cap:.3e} m/s) - check the "
                    "input units")
        scalar("surface.delta_T.file", "delta_T")
        anomaly("surface.anomaly.file", ["climatic_mass_balance_anomaly",
                                         "ice_surface_temp_anomaly"])
        last_record("surface.pdd.std_dev.file", ["air_temp_sd"],
                    "air_temp_sd")
        last_record("surface.elevation_change.file",
                    ["usurf", "surface_altitude", "surface"],
                    "reference_surface", calendar=True)
        last_record("surface.force_to_thickness.file",
                    ["thk", "land_ice_thickness"], "target_thickness",
                    calendar=True, nan=True)
        path = config.get_string("surface.debm_simple.paleo.file")
        if path:
            with File(path, "r") as f:
                tt = np.asarray(f.read("time"), float)
                tu = dict(f.read_attrs("time")).get("units", b"years")
                if isinstance(tu, bytes):
                    tu = tu.decode()
                if "year" in str(tu):
                    tt = tt * SEC_PER_YEAR
                inputs["paleo_times"] = tt
                for v in ("eccentricity", "obliquity",
                          "perihelion_longitude"):
                    inputs[v] = np.asarray(f.read(v), float)
        last_record("surface.debm_simple.albedo_input.file", ["albedo"],
                    "albedo")
    elif group == "ocean":
        spatial("ocean.given.file",
                ["shelf_base_mass_flux", "shelf_base_temperature"])
        spatial("ocean.th.file", ["theta_ocean", "salinity_ocean"])
        spatial("ocean.pico.file",
                ["theta_ocean", "salinity_ocean", "basins"])
        # drainage basins may come from their own file
        spatial("ocean.pico.basins_file", ["basins"])
        if "basins" in inputs and inputs["basins"].ndim == 3:
            inputs["basins"] = inputs["basins"][-1]
        scalar("ocean.delta_T.file", "delta_T")
        scalar("ocean.frac_MBP.file", "frac_MBP")
        scalar("ocean.delta_MBP.file", "delta_MBP")
        scalar("ocean.frac_SMB.file", "frac_SMB")
        anomaly("ocean.anomaly.file", ["shelf_base_mass_flux_anomaly",
                                       "shelf_base_mass_flux"],
                one_key="melt_anomaly")
    elif group == "sea_level":
        scalar("sea_level.delta_sl.file", "delta_SL")
        # the reference's -ocean ...,delta_SL file option, an alias
        if "delta_SL" not in inputs:
            scalar("ocean.delta_SL.file", "delta_SL")
        path = config.get_string("ocean.delta_sl_2d.file")
        if path:
            names = ["delta_SL_2D", "delta_SL", "sea_level_change"]
            fields, sl_times = read_forcing_fields(
                path, grid, names, calendar=cal, reference_date=ref)
            for k in names:
                if k in fields:
                    inputs["delta_SL_2D"] = tensor(fields[k])
                    break
            if sl_times is not None:
                inputs["delta_SL_2D_times"] = sl_times
    elif group == "frontal_melt":
        spatial("frontal_melt.given.file", ["frontal_melt_rate"])
        spatial("frontal_melt.routing.file", ["theta_ocean"])
        spatial("frontal_melt.discharge_given.file",
                ["theta_ocean", "subglacial_discharge"])
        # the frontal-melt models take single 2D fields: a time stack
        # supplies its last record
        for k in ("frontal_melt_rate", "theta_ocean", "subglacial_discharge"):
            if k in inputs and inputs[k].ndim == 3:
                inputs[k] = inputs[k][-1]
    return inputs
