"""Coupler factories: atmosphere, surface, ocean and sea-level chains from
config strings (port of ``pism_tpu/coupler/factory.py``; PISM
``src/coupler/util/PCFactory.hh``).

A chain is ``base,modifier,...`` (``-atmosphere searise_greenland,delta_T
-surface pdd``): the first entry is the base model, the rest wrap it left
to right. The factory functions take an ``inputs`` dict of loaded fields
(tensors on the model's device) and forcing callables;
``inputs_from_files`` fills it from the files the config names. The port builds these names:

- atmosphere ``uniform``, ``given``, ``searise_greenland``, ``pik``;
  modifiers ``delta_T``, ``delta_P``;
- surface ``simple``, ``uniform``, ``given``, ``pdd``, ``pik``; modifier
  ``delta_T``;
- ocean ``constant``, ``pik``, ``pico``; modifier ``delta_T``;
- sea level ``constant``; modifier ``delta_sl``;
- the fields of the frontal-melt models (``coupler/frontalmelt.py``),
  group ``frontal_melt`` of ``inputs_from_files``.

Every other name raises NotImplementedError (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..config import require
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


def _refuse(kind: str, name: str, modifier: bool = False):
    return NotImplementedError(
        f"the {kind} {'modifier' if modifier else 'model'} {name!r} is not "
        "implemented in pism_tpu_torch (ROADMAP Queue 1 item 8)")


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
    (latitude, precipitation); modifiers
    ``delta_T`` and ``delta_P`` (callables of model time)."""
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
    elif base == "pik":
        model = _atm.PIK(
            latitude=_need(inputs, "latitude", base),
            precipitation=_need(inputs, "precipitation", base),
            parameterization=config.get_string(
                "atmosphere.pik.parameterization"))
    else:
        raise _refuse("atmosphere", base)
    for mod in mods:
        if mod == "delta_T":
            model = _atm.DeltaT(inner=model,
                                offset=_need(inputs, "delta_T", mod))
        elif mod == "delta_P":
            model = _atm.DeltaP(inner=model,
                                offset=_need(inputs, "delta_P", mod))
        else:
            raise _refuse("atmosphere", mod, modifier=True)
    return model


# ---------------------------------------------------------------- surface
def surface_from_config(config, inputs: Optional[Mapping] = None,
                        atmosphere=None):
    """The surface chain of ``surface.models``: ``simple`` and ``pdd`` (on
    ``atmosphere``), ``pik`` (on ``atmosphere``; latitude), ``uniform``,
    ``given`` (climatic_mass_balance, ice_surface_temp [, times]); modifier
    ``delta_T``."""
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
    elif base == "pdd":
        from .pdd import TemperatureIndex
        model = TemperatureIndex(atmosphere=need_atm(base), config=config)
    elif base == "pik":
        model = _srf.PIK(atmosphere=need_atm(base),
                         latitude=_need(inputs, "latitude", base))
    else:
        raise _refuse("surface", base)
    for mod in mods:
        if mod == "delta_T":
            model = _srf.DeltaT(inner=model,
                                offset=_need(inputs, "delta_T", mod))
        else:
            raise _refuse("surface", mod, modifier=True)
    return model


# ---------------------------------------------------------------- ocean
def ocean_from_config(config, inputs: Optional[Mapping] = None, grid=None):
    """The ocean chain of ``ocean.models``: ``constant``, ``pik``, ``pico``
    (theta_ocean, salinity_ocean [, basins, times]; needs ``grid``);
    modifier ``delta_T`` (a callable of model time)."""
    inputs = inputs or {}
    base, mods = _split(config.get_string("ocean.models"))
    if base == "constant":
        model = _ocn.Constant(config=config)
    elif base == "pik":
        model = _ocn.PIK(config=config)
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
        raise _refuse("ocean", base)
    for mod in mods:
        if mod == "delta_T":
            model = _ocn.DeltaT(inner=model,
                                offset=_need(inputs, "delta_T", mod))
        else:
            raise _refuse("ocean", mod, modifier=True)
    # the JAX factory wraps a melange back pressure modifier around any
    # chain when this fraction is > 0
    require(config, "ocean.melange_back_pressure_fraction", (0.0,))
    return model


# ---------------------------------------------------------------- sea level
def sea_level_from_config(config, inputs: Optional[Mapping] = None):
    """The sea-level chain of ``sea_level.models``: ``constant``; modifier
    ``delta_sl`` (a callable of model time)."""
    inputs = inputs or {}
    base, mods = _split(config.get_string("sea_level.models"))
    if base != "constant":
        raise _refuse("sea level", base)
    model = _sl.Constant(value=config.get_number("sea_level.constant.value")
                         + config.get_number("sea_level.constant.delta_SL"))
    for mod in mods:
        if mod == "delta_sl":
            model = _sl.DeltaSL(inner=model,
                                offset=_need(inputs, "delta_SL", mod))
        else:
            raise _refuse("sea level", mod, modifier=True)
    return model


# ---------------------------------------------------------------- files
#: forcing files the JAX ``inputs_from_files`` reads for models the port
#: does not build: refused when set
_UNPORTED_FILES = {
    "atmosphere": ("atmosphere.yearly_cycle.file",
                   "atmosphere.yearly_cycle.scaling.file",
                   "atmosphere.anomaly.file", "atmosphere.elevation_change.file",
                   "atmosphere.one_station.file", "atmosphere.frac_P.file",
                   "atmosphere.precip_scaling.file"),
    "surface": ("surface.anomaly.file", "surface.pdd.std_dev.file",
                "surface.elevation_change.file",
                "surface.force_to_thickness.file",
                "surface.debm_simple.paleo.file",
                "surface.debm_simple.albedo_input.file"),
    "ocean": ("ocean.given.file", "ocean.th.file",
              "ocean.frac_MBP.file", "ocean.delta_MBP.file",
              "ocean.frac_SMB.file", "ocean.anomaly.file"),
    "sea_level": ("ocean.delta_sl_2d.file",),
}


def inputs_from_files(config, grid, group: str, device="cuda") -> dict:
    """The ``inputs`` of a coupler group from the forcing files its config
    names: spatial fields regridded onto the model grid, converted to
    internal units and cast to the field dtype on ``device`` (a time
    stack's ``times`` stay a host array); scalar series as
    ``util.forcing.ScalarForcing``."""
    from ..io.bootstrap import read_forcing_fields
    from ..util.forcing import ScalarForcing

    for key in _UNPORTED_FILES.get(group, ()):
        require(config, key, ("",))
    inputs = {}
    fdt = torch.float32 \
        if config.get_string("runtime.float_dtype") == "float32" \
        else torch.float64
    cal = config.get_string("time.calendar")
    ref = config.get_string("time.reference_date")

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
            inputs[k] = torch.as_tensor(v).to(device=device, dtype=fdt)
        if times is not None:
            inputs["times"] = times

    def scalar(file_key, input_key):
        path = config.get_string(file_key)
        if path:
            # every scalar forcing has a sibling ".periodic" flag
            pkey = file_key[:-len(".file")] + ".periodic"
            periodic = pkey in PARAMETERS and config.get_flag(pkey)
            inputs[input_key] = ScalarForcing.from_file(
                path, input_key, periodic=periodic, calendar=cal,
                reference_date=ref)

    if group == "atmosphere":
        spatial("atmosphere.given.file",
                ["air_temp", "precipitation", "air_temp_summer"])
        # the SeaRISE-Greenland inputs (lat/lon/precipitation)
        spatial("atmosphere.searise_greenland.file",
                ["latitude", "longitude", "precipitation", "lat", "lon"])
        for short, full in (("lat", "latitude"), ("lon", "longitude")):
            if short in inputs:
                inputs.setdefault(full, inputs.pop(short))
        scalar("atmosphere.delta_T.file", "delta_T")
        scalar("atmosphere.delta_P.file", "delta_P")
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
    elif group == "ocean":
        spatial("ocean.pico.file",
                ["theta_ocean", "salinity_ocean", "basins"])
        # drainage basins may come from their own file
        spatial("ocean.pico.basins_file", ["basins"])
        if "basins" in inputs and inputs["basins"].ndim == 3:
            inputs["basins"] = inputs["basins"][-1]
        scalar("ocean.delta_T.file", "delta_T")
    elif group == "sea_level":
        scalar("sea_level.delta_sl.file", "delta_SL")
        # the reference's -ocean ...,delta_SL file option, an alias
        if "delta_SL" not in inputs:
            scalar("ocean.delta_SL.file", "delta_SL")
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
