"""Model-state checkpointing to CF/NetCDF files (port of
``pism_tpu/io/checkpoint.py``).

The output file is the checkpoint, as in PISM: ``save_state`` writes every
field of the ``ModelState`` under PISM's variable names with CF metadata,
the full config as the JSON global attribute ``pism_config`` and the grid
as ``grid_json``; ``load_state`` reads it back exactly (fields are stored
in their own dtype). Variable names, attributes and the time axis are the
JAX package's, so either package reads the other's files, in both formats
(``format="netcdf4"`` through h5py, ``"netcdf3"`` through scipy).

Layout: 2D fields (time, y, x); 3D fields (time, y, x, z) with z = height
above the ice base; the bedrock temperature (time, y, x, zb); the
isochrones' layers ``isochronal_layer_thickness`` (time, y, x, nl) with
the active top layer in the global attribute ``iso_top``.
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from .. import state as S
from ..config import Config
from ..grid import Grid
from .nc4 import File

#: ModelState field -> (variable name, CF attrs, rank); the names and
#: attributes of the JAX package's table for the fields the port carries
_STATE_VARS = {
    "enthalpy": ("enthalpy", {"units": "J kg-1", "long_name": "ice enthalpy"}, 3),
    "bedrock_temperature": ("litho_temp", {"units": "K"}, 3),
    "basal_melt_rate": ("bmelt", {"units": "m s-1",
                                  "standard_name": "land_ice_basal_melt_rate"}, 2),
    "u_ssa": ("u_ssa", {"units": "m s-1"}, 2),
    "v_ssa": ("v_ssa", {"units": "m s-1"}, 2),
    "tillwat": ("tillwat", {"units": "m"}, 2),
    "till_phi": ("tillphi", {"units": "degrees"}, 2),
    "hydro_W": ("bwat", {"units": "m"}, 2),
    "hydro_P": ("bwp", {"units": "Pa"}, 2),
    "hydro_Q": ("bwatflux", {"units": "m2 s-1"}, 2),
    "age": ("age", {"units": "s"}, 3),
    "ch_enthalpy": ("ch_enthalpy", {"units": "J kg-1", "long_name":
                                    "cryo-hydrologic system enthalpy"}, 3),
    "bed_uplift": ("viscous_bed_displacement", {"units": "m"}, 2),
    "bed_load_reference": ("bed_def_load_reference", {"units": "m"}, 2),
    "bed_reference": ("bed_def_reference", {"units": "m"}, 2),
    "fracture_density": ("fracture_density", {"units": "1"}, 2),
    "fracture_age": ("fracture_age", {"units": "s", "long_name":
                                      "age of the fractures"}, 2),
    "geothermal_flux": ("bheatflx", {"units": "W m-2", "long_name":
                                     "upward geothermal flux at the bedrock "
                                     "thermal layer base"}, 2),
    "snow_depth": ("snow_depth", {"units": "m", "long_name":
                                  "PDD snow depth (melt bookkeeping)"}, 2),
    "firn_depth": ("firn_depth", {"units": "m", "long_name":
                                  "PDD firn depth (melt bookkeeping)"}, 2),
    "surface_albedo": ("albedo", {"units": "1", "long_name":
                                  "dEBM-simple surface albedo"}, 2),
}

#: the 3D fields that a column solve leaves level-major in memory; a
#: restart reads them so, since torch's reductions over z round by layout
_LEVEL_MAJOR = ("enthalpy", "age", "ch_enthalpy")

_XY = ("time", "y", "x")


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _setup_dims(f, grid: Grid, config: Optional[Config] = None):
    # the time axis carries the run calendar (PISM Time.cc)
    units, cal = "seconds since 1-1-1", "365_day"
    if config is not None:
        cal = config.get_string("time.calendar")
        units = "seconds since " + config.get_string("time.reference_date")
    f.define_dimension("time", None, attrs={
        "units": units, "calendar": cal, "axis": "T"})
    f.define_dimension("y", grid.My, grid.y, attrs={
        "units": "m", "axis": "Y", "standard_name": "projection_y_coordinate"})
    f.define_dimension("x", grid.Mx, grid.x, attrs={
        "units": "m", "axis": "X", "standard_name": "projection_x_coordinate"})
    if grid.Mz > 1:
        f.define_dimension("z", grid.Mz, grid.z, attrs={
            "units": "m", "axis": "Z", "positive": "up",
            "long_name": "height above ice base"})
    if grid.Mbz > 1:
        f.define_dimension("zb", grid.Mbz, grid.zb, attrs={
            "units": "m", "axis": "Z", "positive": "up"})


def write_projection(f, grid: Grid, config: Config):
    """With ``grid.projection`` set: the ``proj`` attribute and, when the
    string parses, the mandatory ``lat``/``lon`` and their CF cell bounds
    ``lat_bnds``/``lon_bnds`` (PISM stores them in every output file;
    JAX ``pism_tpu/io/checkpoint.py:125-155``). The bounds' ``nv4``
    dimension goes through ``has_dimension``, so classic files get them
    too."""
    from ..util import projection as prj

    proj = config.get_string("grid.projection")
    if not proj:
        return
    f.set_global_attr("proj", proj)
    try:
        ps = prj.from_proj_string(proj)
    except ValueError:
        return
    lon, lat = prj.lonlat_for_grid(grid, ps)
    f.write("lat", lat, ("y", "x"), {"units": "degrees_north",
                                     "standard_name": "latitude",
                                     "bounds": "lat_bnds"})
    f.write("lon", lon, ("y", "x"), {"units": "degrees_east",
                                     "standard_name": "longitude",
                                     "bounds": "lon_bnds"})
    lon_b, lat_b = prj.lonlat_bounds_for_grid(grid, ps)
    if not f.has_dimension("nv4"):
        f.define_dimension("nv4", 4)
    f.write("lat_bnds", lat_b, ("y", "x", "nv4"), {"units": "degrees_north"})
    f.write("lon_bnds", lon_b, ("y", "x", "nv4"), {"units": "degrees_east"})


def _write_diagnostics(f, grid: Grid, values: dict, n: int):
    from ..model import diagnostics as dg
    for name, v in values.items():
        d = dg.SPATIAL[name]
        dims = _XY
        if v.ndim == 3 and v.shape[-1] == grid.Mz:
            dims = _XY + ("z",)
            if not f.has_dimension("z"):
                f.define_dimension("z", grid.Mz, grid.z, attrs={
                    "units": "m", "axis": "Z", "positive": "up"})
        elif v.ndim == 3 and name == "litho_temp":
            dims = _XY + ("zb",)
        elif v.ndim == 3:
            # a layer-indexed field (isochrone_depth)
            dims = _XY + ("nl",)
            if not f.has_dimension("nl"):
                f.define_dimension("nl", v.shape[-1])
        f.write(name, v[None], dims,
                {"units": d.units, "long_name": d.long_name}, time_index=n)


def save_state(path: str, state: S.ModelState, grid: Grid, t: float,
               config: Optional[Config] = None, format: str = "netcdf4",
               extra_2d: Optional[dict] = None,
               diagnostics: Optional[dict] = None,
               series: Optional[dict] = None):
    """Write the state at model time ``t``. ``format="netcdf3"`` writes
    classic CDF-2 (PISM ``-o_format``).

    extra_2d: time-independent 2D fields ``{name: (array, attrs)}``;
    series: 1D variables on dimensions of their own ``{name: (dim, array,
    attrs)}`` (the inversion's objective history);
    diagnostics: ``{name: array}`` of ``diagnostic_values``, written in the
    same pass (the ``-o_size`` sets; a classic file cannot be appended to)."""
    with File(path, "w", format=format) as f:
        _setup_dims(f, grid, config)
        n = f.append_time(t)
        g = state.geometry
        for var, field, attrs in (
                ("thk", g.ice_thickness,
                 {"units": "m", "standard_name": "land_ice_thickness"}),
                ("topg", g.bed_elevation,
                 {"units": "m", "standard_name": "bedrock_altitude"}),
                ("sea_level", g.sea_level, {"units": "m"}),
                ("Href", g.ice_area_specific_volume, {"units": "m"}),
                ("usurf", g.ice_surface_elevation,
                 {"units": "m", "standard_name": "surface_altitude"}),
                ("mask", g.cell_type,
                 {"long_name": "ice-type (ice-free/grounded/floating/ocean)"})):
            f.write(var, _host(field)[None], _XY, attrs, time_index=n)
        for field, (var, attrs, rank) in _STATE_VARS.items():
            val = getattr(state, field)
            if val is None:
                continue
            dims = _XY if rank == 2 else _XY + (
                "zb" if field == "bedrock_temperature" else "z",)
            f.write(var, _host(val)[None], dims, attrs, time_index=n)
        if state.iso_layers is not None:
            f.define_dimension("nl", int(state.iso_layers.shape[-1]))
            f.write("isochronal_layer_thickness",
                    _host(state.iso_layers)[None], _XY + ("nl",),
                    {"units": "m"}, time_index=n)
            f.set_global_attr("iso_top", int(state.iso_top))
        for name, (arr, attrs) in (extra_2d or {}).items():
            f.write(name, _host(arr).astype(np.float64), ("y", "x"),
                    attrs or {})
        if diagnostics:
            _write_diagnostics(f, grid, diagnostics, n)
        for name, (dim, arr, attrs) in (series or {}).items():
            arr = _host(arr).astype(np.float64)
            f.define_dimension(dim, len(arr))
            f.write(name, arr, (dim,), attrs or {})
        if config is not None:
            f.set_global_attr("pism_config", config.to_json())
            write_projection(f, grid, config)
        f.set_global_attr("source", "pism_tpu")
        f.set_global_attr("grid_json", _grid_json(grid))
        if config is not None:
            # PISM run_info.*: provenance attributes in every output
            for key, attr in (("run_info.title", "title"),
                              ("run_info.institution", "institution"),
                              ("run_info.command", "command")):
                val = config.get_string(key)
                if val:
                    f.set_global_attr(attr, val)


def _grid_json(grid: Grid) -> str:
    return json.dumps({
        "Mx": grid.Mx, "My": grid.My, "Mz": grid.Mz, "Mbz": grid.Mbz,
        "Lx": grid.Lx, "Ly": grid.Ly, "Lz": grid.Lz, "Lbz": grid.Lbz,
        "x0": grid.x0, "y0": grid.y0,
        "vertical_spacing": grid.vertical_spacing, "lam": grid.lam,
        "periodicity": grid.periodicity,
    })


def load_grid(path: str) -> Grid:
    with File(path, "r") as f:
        return Grid(**json.loads(f.get_global_attr("grid_json")))


def load_config(path: str) -> Config:
    with File(path, "r") as f:
        s = f.get_global_attr("pism_config")
    return Config.from_json(s) if s else Config()


def load_state(path: str, config: Optional[Config] = None, device="cuda"):
    """Returns (state, t): the last record of every saved field, cast to
    the configured ``runtime.float_dtype`` on ``device`` (a float32 run's
    state comes back float32 even from a float64 file)."""
    cfg = config or load_config(path)
    fdt = torch.float32 \
        if cfg.get_string("runtime.float_dtype") == "float32" \
        else torch.float64
    device = torch.device(device)
    with File(path, "r") as f:
        def field(var):
            return torch.as_tensor(f.read(var)[-1], dtype=fdt, device=device)

        t = float(f.read("time")[-1])
        geom = S.new_geometry(
            field("thk"), field("topg"), sea_level=field("sea_level"),
            Href=field("Href"),
            ice_density=cfg.get_number("constants.ice.density"),
            ocean_density=cfg.get_number("constants.sea_water.density"),
            ice_free_thickness=cfg.get_number(
                "geometry.ice_free_thickness_standard"),
            subgl=cfg.get_flag("geometry.grounded_cell_fraction"))
        kw = {name: field(var) for name, (var, _, _) in _STATE_VARS.items()
              if f.has_variable(var)}
        if f.has_variable("isochronal_layer_thickness"):
            kw["iso_layers"] = field("isochronal_layer_thickness")
            kw["iso_top"] = int(f.get_global_attr("iso_top"))
    for name in _LEVEL_MAJOR:
        if name in kw:
            # the level-major layout the column solves leave (util/
            # tridiag.py): a restart reads the field as the uninterrupted
            # run holds it
            kw[name] = kw[name].movedim(-1, 0).contiguous().movedim(0, -1)
    return S.ModelState(geometry=geom, **kw), t


def diagnostic_values(names, state, model, t: float) -> dict:
    """Host arrays of the spatial diagnostics ``names`` (the ``-o_size``
    sets), skipping those that are undefined for this run: a name that is
    not a spatial diagnostic, one that needs a field the configuration
    does not carry, or one that is NaN everywhere."""
    from ..model import diagnostics as dg

    values = {}
    for name in names:
        if name not in dg.SPATIAL:
            continue
        try:
            v = _host(dg.SPATIAL[name].func(state, model, t))
        except (TypeError, AttributeError):
            continue
        if v.size and np.isnan(v).all():
            continue
        values[name] = v
    return values


def append_diagnostics(path: str, names, state, model, t: float):
    """Append the spatial diagnostics ``names`` to a NetCDF-4 state file
    (record 0). A classic file is written in one pass instead:
    ``save_state(..., diagnostics=diagnostic_values(...))``."""
    values = diagnostic_values(names, state, model, t)
    with File(path, "a") as f:
        _write_diagnostics(f, model.grid, values, 0)
