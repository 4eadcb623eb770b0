"""Bootstrapping: a model state from an input file on another grid plus
heuristics (port of ``pism_tpu/io/bootstrap.py``; PISM's ``-bootstrap``,
``src/icemodel/initialization.cc`` ``bootstrap_2d/3d``).

2D input fields (thickness, bed topography, climate fields) are read from a
CF NetCDF file on its own grid and bilinearly regridded onto the model grid
on the host (``util/regrid.py``); the 3D enthalpy is built on the device
from the surface-temperature / geothermal-flux heuristic profile
(``model.energy.bootstrap_enthalpy``). The state's fields take the
configured ``runtime.float_dtype`` on the caller's device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..grid import Grid
from ..model.energy import bootstrap_enthalpy
from ..physics.enthalpy_converter import EnthalpyConverter
from ..state import ModelState, new_geometry
from ..util.regrid import regrid_bilinear
from .nc4 import File

#: PISM standard variable names consulted at bootstrap
DEFAULT_VARS = {
    "thk": "thk",
    "topg": "topg",
    "tillwat": "tillwat",
    "bwat": "bwat",
    "bmelt": "bmelt",
    "fracture_density": "fracture_density",
    "ice_surface_temp": "ice_surface_temp",
    "bheatflx": "bheatflx",
}


def read_and_regrid(path: str, grid: Grid, variables=None, fill=np.nan,
                    allow_extrapolation: bool = False) -> Dict[str, np.ndarray]:
    """Read 2D (y, x) or (time, y, x) variables (the last record) and regrid
    them onto ``grid``. Points outside the file's extent take the nearest
    edge value whatever ``allow_extrapolation`` says: the regridder clamps
    (the JAX package does the same on both of its routes)."""
    variables = variables or list(DEFAULT_VARS.values())
    gx, gy = grid.x, grid.y
    out = {}
    with File(path, "r") as f:
        xs = np.asarray(f.read("x"), float)
        ys = np.asarray(f.read("y"), float)
        if allow_extrapolation:
            gx = np.clip(grid.x, xs.min(), xs.max())
            gy = np.clip(grid.y, ys.min(), ys.max())
        for name in variables:
            if not f.has_variable(name):
                continue
            data = np.asarray(f.read(name), float)
            if data.ndim == 3:
                data = data[-1]
            out[name] = regrid_bilinear(data, xs, ys, gx, gy, fill=fill)
    return out


def projection_of(path: str):
    """The file's map projection: its ``proj`` (or ``proj4``) global
    attribute parsed as a PROJ string, else a CF grid-mapping variable;
    None when it has neither (or neither parses)."""
    from ..util import projection as prj

    with File(path, "r") as f:
        p = f.get_global_attr("proj") or f.get_global_attr("proj4")
        if p is not None:
            if isinstance(p, bytes):
                p = p.decode()
            try:
                return prj.from_proj_string(p)
            except ValueError:
                pass
        for name in list(f.variables()):
            attrs = dict(f.read_attrs(name))
            if "grid_mapping_name" in attrs or name == "polar_stereographic":
                try:
                    return prj.from_cf_mapping(attrs)
                except ValueError:
                    continue
    return None


def lonlat_from_projection(path: str, grid: Grid):
    """(lon, lat) fields [degrees] of ``grid`` from the file's projection
    (PISM ``grid.recompute_longitude_and_latitude``), or (None, None)."""
    from ..util import projection as prj

    ps = projection_of(path)
    if ps is None:
        return None, None
    return prj.lonlat_for_grid(grid, ps)


def latitude_from_projection(path: str, grid: Grid):
    """The latitude field [degrees N] of :func:`lonlat_from_projection`,
    or None."""
    return lonlat_from_projection(path, grid)[1]


#: internal target units per forcing variable (temperatures in K, mass
#: fluxes in m/s ice equivalent)
_FORCING_UNITS = {
    "air_temp": "K",
    "ice_surface_temp": "K",
    "shelf_base_temperature": "K",
    "theta_ocean": "K",
    "precipitation": "flux",
    "climatic_mass_balance": "flux",
    "shelf_base_mass_flux": "flux",
}


def _convert_forcing(data, units, kind, rho_i):
    """A raw forcing field in internal units; mass fluxes given as
    kg m-2 *-1 are divided by the ice density (as PISM's I/O layer does)."""
    from ..util import units as U
    units = (units or "").strip()
    if kind == "K":
        if not units or units == "K" or units.lower() == "kelvin":
            return data
        return U.convert(data, units, "K")
    if kind == "flux":
        if not units:
            return data                       # m s-1 ice equivalent
        if U.Unit.parse(units).is_convertible(U.Unit.parse("kg m-2 s-1")):
            return U.convert(data, units, "kg m-2 s-1") / rho_i
        return U.convert(data, units, "m s-1")
    return data


def read_forcing_fields(path: str, grid: Grid, variables,
                        time_name: str = "time", rho_i: float = 910.0,
                        calendar: str = "365_day",
                        reference_date: str = "1-1-1"):
    """Forcing fields for the coupler factory: each variable a ``(y, x)``
    slice or a ``(time, y, x)`` stack, regridded slice by slice and
    converted to internal units. Returns ``(fields, times)``, host float64
    arrays, with ``times`` in model seconds (None without a time axis);
    dated CF time axes are aligned to model time under the run calendar."""
    from ..util.timecal import parse_time_units
    out = {}
    times = None
    with File(path, "r") as f:
        xs = np.asarray(f.read("x"), float)
        ys = np.asarray(f.read("y"), float)
        if f.has_variable(time_name):
            times = np.asarray(f.read(time_name), float)
            t_units = dict(f.read_attrs(time_name)).get("units", b"seconds")
            if isinstance(t_units, bytes):
                t_units = t_units.decode()
            scale, offset = parse_time_units(str(t_units), calendar,
                                             reference_date)
            times = times * scale + offset
        for name in variables:
            if not f.has_variable(name):
                continue
            data = np.asarray(f.read(name), float)
            units = dict(f.read_attrs(name)).get("units", "")
            if isinstance(units, bytes):
                units = units.decode()
            data = _convert_forcing(data, units, _FORCING_UNITS.get(name),
                                    rho_i)
            if data.ndim == 3:
                data = np.stack([regrid_bilinear(d, xs, ys, grid.x, grid.y)
                                 for d in data])
            else:
                data = regrid_bilinear(data, xs, ys, grid.x, grid.y)
            out[name] = data
    return out, times


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not implemented in pism_tpu_torch (ROADMAP Queue 1 "
        f"item {item})")


def bootstrap(path: str, grid: Grid, config, device="cuda") -> ModelState:
    """PISM ``-i file.nc -bootstrap``: regrid the 2D inputs, heuristics for
    everything else. The regridded fields are host float64 arrays cast to
    the field dtype, so they are the same on every device; the enthalpy is
    computed on ``device``."""
    fdt = torch.float32 \
        if config.get_string("runtime.float_dtype") == "float32" \
        else torch.float64
    device = torch.device(device)

    def field(a):
        return torch.as_tensor(np.asarray(a, np.float64)).to(
            device=device, dtype=fdt)

    fields = read_and_regrid(
        path, grid,
        allow_extrapolation=config.get_flag("grid.allow_extrapolation"))
    # the components that would carry these fields are not ported
    if "bwat" in fields \
            or config.get_number("bootstrapping.defaults.bwat") > 0.0:
        raise _unported("bootstrapping transportable water (bwat, the "
                        "routing hydrology's state)", "6")
    # missing-variable fallbacks (PISM bootstrapping.defaults.*)
    d_thk = config.get_number("bootstrapping.defaults.ice_thickness")
    d_bed = config.get_number("bootstrapping.defaults.bed")
    if "thk" not in fields:
        fields["thk"] = np.full(grid.shape2, d_thk)
    H = np.nan_to_num(fields["thk"], nan=d_thk)
    bed = np.nan_to_num(fields.get("topg", np.full_like(H, d_bed)), nan=d_bed)

    geom = new_geometry(
        field(np.maximum(H, 0.0)), field(bed),
        ice_density=config.get_number("constants.ice.density"),
        ocean_density=config.get_number("constants.sea_water.density"),
        ice_free_thickness=config.get_number(
            "geometry.ice_free_thickness_standard"))

    kw = {}
    d_tillwat = config.get_number("bootstrapping.defaults.tillwat")
    if "tillwat" in fields:
        kw["tillwat"] = field(np.nan_to_num(fields["tillwat"], nan=d_tillwat))
    elif d_tillwat > 0.0:
        kw["tillwat"] = field(np.full(grid.shape2, d_tillwat))
    if "fracture_density" in fields:
        kw["fracture_density"] = field(np.nan_to_num(
            fields["fracture_density"],
            nan=config.get_number("bootstrapping.defaults.fracture_density")))
    d_bmelt = config.get_number("bootstrapping.defaults.bmelt")
    if "bmelt" in fields:
        kw["basal_melt_rate"] = field(np.nan_to_num(fields["bmelt"],
                                                    nan=d_bmelt))
    G_default = config.get_number("bootstrapping.defaults.geothermal_flux")
    if "bheatflx" in fields:
        # the 2D geothermal flux map is carried as model state
        kw["geothermal_flux"] = field(np.nan_to_num(fields["bheatflx"],
                                                    nan=G_default))

    if config.get_string("energy.model") in ("enthalpy", "cold") \
            and grid.Mz > 1:
        T_default = config.get_number("bootstrapping.defaults.ice_surface_temp")
        T_sfc = np.nan_to_num(
            fields.get("ice_surface_temp", np.full(grid.shape2, T_default)),
            nan=T_default)
        if not config.get_flag("energy.allow_temperature_above_melting"):
            # the surface Dirichlet value is capped at the melting point
            T_sfc = np.minimum(T_sfc, 273.15)
        heuristic = config.get_string("bootstrapping.temperature_heuristic")
        smb = None
        if heuristic == "smb":
            # the Robin profile wants an accumulation rate: the file's
            # climatic_mass_balance when it has one
            fsmb, _ = read_forcing_fields(path, grid,
                                          ["climatic_mass_balance"])
            if "climatic_mass_balance" in fsmb:
                a = fsmb["climatic_mass_balance"]
                smb = field(np.nan_to_num(a[-1] if a.ndim == 3 else a))
        kw["enthalpy"] = bootstrap_enthalpy(
            grid, EnthalpyConverter.from_config(config), geom.ice_thickness,
            field(T_sfc), smb=smb,
            geothermal=kw.get("geothermal_flux", G_default),
            k_i=config.get_number("constants.ice.thermal_conductivity"),
            heuristic=heuristic,
            rho=config.get_number("constants.ice.density"),
            c_i=config.get_number("constants.ice.specific_heat_capacity"))
        kw.setdefault("basal_melt_rate", torch.zeros_like(geom.ice_thickness))

    return ModelState(geometry=geom, **kw)
