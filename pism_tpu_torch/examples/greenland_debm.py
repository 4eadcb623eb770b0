"""Synthetic Greenland with the dEBM-simple surface model (Zeitz et al.
2021), twin of the JAX package's ``examples/greenland_debm.py``.

The synthetic Greenland geometry and hybrid SSA+SIA / enthalpy chain of
``setups.hybrid_greenland_model`` (thickness calving at 50 m), with the
surface mass balance of the diurnal energy balance model: insolation- and
temperature-driven melt with the melt-albedo feedback (``-surface
debm_simple``) over the SeaRISE-Greenland atmosphere. ``--warming`` adds a
uniform air-temperature offset, which lowers the summer albedo and so
amplifies the melt; ``--paleo`` takes the Berger orbit instead of the
present-day one.

``main`` runs a 10 a spin-up (or ``--years``, if shorter) and then
``--years`` through ``IceModel.step_once`` and prints the JAX example's
JSON line: the volume, the minimum and the margin's mean summer albedo and
the maximum summer melt, evaluated at the next mid-summer instant with the
albedo brought to the melt by three fixed-point passes
(``summer_albedo``). ``synthesize_data_file`` writes the geometry as a
data file with a polar-stereographic projection and ``cli_argv`` is the
command line that runs the chain from it:

  python -m pism_tpu_torch -i g.nc -bootstrap -Mx 76 -My 141 -Mz 41 \\
      -Lx 750 -Ly 1400 -Lz 4000 -stress_balance ssa+sia -pseudo_plastic \\
      -atmosphere searise_greenland,orographic_precipitation \\
      -surface debm_simple -o_size medium ...

Usage: python -m pism_tpu_torch.examples.greenland_debm [--km 20]
           [--years 100] [--warming 0] [--float32] [--paleo]
           [--platform cpu]
"""

import argparse
import json
import math
import time

import numpy as np

SPY = 3.15569259747e7


def greenland_debm_model(dtype: str = "float64", km: float = 20.0,
                         warming: float = 0.0, paleo: bool = False,
                         device="cuda"):
    """(model, initial state, grid) of the example's chain on the ``km``
    grid (76x141x41 at 20 km), the state prepared in float64 and cast to
    ``dtype`` as the JAX example casts it."""
    import torch

    from pism_tpu_torch import Config, Grid
    from pism_tpu_torch.coupler import atmosphere as atm
    from pism_tpu_torch.coupler.debm import DEBMSimple
    from pism_tpu_torch.coupler.ocean import Constant as OceanConstant
    from pism_tpu_torch.model.icemodel import IceModel
    from pism_tpu_torch.setups import to_dtype
    from pism_tpu_torch.state import ModelState, new_geometry

    device = torch.device(device)
    dx = km * 1e3
    Lx, Ly = 750e3, 1400e3
    Mx = int(2 * Lx / dx) + 1
    My = int(2 * Ly / dx) + 1
    grid = Grid(Mx=Mx, My=My, Lx=Lx, Ly=Ly, Mz=41, Lz=4000.0)
    cfg = Config({
        "stress_balance.model": "ssa+sia",
        "energy.model": "enthalpy",
        "basal_resistance.pseudo_plastic.enabled": True,
        "basal_resistance.pseudo_plastic.q": 0.25,
        "basal_yield_stress.model": "mohr_coulomb",
        "calving.methods": "thickness_calving",
        "calving.thickness_calving.threshold": 50.0,
        "geometry.remove_icebergs": True,
        "geometry.part_grid.enabled": True,
        "time_stepping.skip.enabled": True,
        "time_stepping.skip.max": 10,
        "runtime.float_dtype": dtype,
        "runtime.device_loop": True,
        "surface.debm_simple.paleo.enabled": bool(paleo),
    })
    X, Y = np.meshgrid(grid.x, grid.y)
    r2 = (X / (0.55 * Lx)) ** 2 + (Y / (0.8 * Ly)) ** 2
    bed = 400.0 - 900.0 * r2 + 150.0 * np.sin(X / 120e3) * np.cos(Y / 160e3)
    H = 2800.0 * np.maximum(1.0 - r2, 0.0) ** 1.5 * (bed > -600)
    lat = 60.0 + (Y + Ly) / (2 * Ly) * 23.0     # 60N..83N
    lon = -42.0 + X / Lx * 10.0
    precip = np.clip(0.6 - 0.25 * (lat - 60.0) / 23.0, 0.05, None) / SPY

    def t64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    a = atm.SeariseGreenland(latitude=t64(lat), longitude=t64(lon),
                             precipitation=t64(precip))
    if warming:
        a = atm.DeltaT(inner=a, offset=lambda t: warming)
    surface = DEBMSimple(atmosphere=a, latitude=t64(lat), config=cfg)
    model = IceModel(grid=grid, config=cfg, surface=surface,
                     ocean=OceanConstant(config=cfg), device=device)
    state = model.prepare_state(ModelState(geometry=new_geometry(
        t64(H), t64(bed))))
    if dtype == "float32":
        state = to_dtype(state, torch.float32)
    return model, state, grid


#: polar stereographic with a false northing that puts the synthetic
#: 1500 x 2800 km domain between 60 and 80 N (EPSG:3413's parameters)
GREENLAND_PROJ = "+proj=stere +lat_0=90 +lat_ts=70 +lon_0=-45 +k=1 " \
    "+x_0=0 +y_0=2000000 +ellps=WGS84 +units=m"


def synthesize_data_file(path, km, format="netcdf4"):
    """The synthetic Greenland data file of
    ``std_greenland_workflow.synthesize_bootstrap_file`` (thk, topg,
    precipitation, ice_surface_temp) with ``GREENLAND_PROJ`` and its lat
    and lon, so that the outputs of a run carry the same latitude (a
    restart's dEBM reads it from there). Returns the grid's (Mx, My)."""
    import os
    import tempfile

    from pism_tpu_torch.grid import Grid
    from pism_tpu_torch.io.nc4 import File
    from pism_tpu_torch.util import projection as prj

    from .std_greenland_workflow import LX, LY, synthesize_bootstrap_file

    fd, tmp = tempfile.mkstemp(suffix=".nc", dir=os.path.dirname(
        os.path.abspath(path)))
    os.close(fd)
    try:
        nx, ny = synthesize_bootstrap_file(tmp, km, "netcdf3")
        with File(tmp, "r") as f:
            x, y = f.read("x"), f.read("y")
            fields = {n: (f.read(n), f.read_attrs(n).get("units", ""))
                      for n in ("thk", "topg", "precipitation",
                                "ice_surface_temp")}
    finally:
        os.remove(tmp)
    lon, lat = prj.lonlat_for_grid(Grid(Mx=nx, My=ny, Lx=LX, Ly=LY),
                                   prj.from_proj_string(GREENLAND_PROJ))
    with File(path, "w", format=format) as f:
        f.define_dimension("y", ny, y, attrs={"units": "m"})
        f.define_dimension("x", nx, x, attrs={"units": "m"})
        for name, (a, units) in fields.items():
            f.write(name, a, ("y", "x"), {"units": units})
        f.write("lat", lat, ("y", "x"), {"units": "degree_north"})
        f.write("lon", lon, ("y", "x"), {"units": "degree_east"})
        f.set_global_attr("proj", GREENLAND_PROJ)
    return nx, ny


def cli_argv(data, out, km, years, o_format="netcdf4", Mz=41,
             dtype="float64", extra=()):
    """The command line of the chain from ``data``: bootstrap with the
    SeaRISE atmosphere (its inputs from ``data``), orographic
    precipitation and dEBM, SSA+SIA, ``-o_size medium`` with the dEBM
    diagnostics added to the medium set."""
    from .std_greenland_workflow import LX, LY
    nx = int(2 * LX / (km * 1e3)) + 1
    ny = int(2 * LY / (km * 1e3)) + 1
    medium = ("velsurf_mag velbar_mag climatic_mass_balance "
              "ice_surface_temp insolation surface_albedo")
    return ["-i", data, "-bootstrap", "-Mx", str(nx), "-My", str(ny),
            "-Mz", str(Mz), "-Lx", f"{LX / 1e3:g}", "-Ly", f"{LY / 1e3:g}",
            "-Lz", "4000", "-stress_balance", "ssa+sia",
            "-pseudo_plastic",
            "-atmosphere", "searise_greenland,orographic_precipitation",
            "-surface", "debm_simple",
            "-config", f"atmosphere.searise_greenland.file={data}",
            "-config", f"runtime.float_dtype={dtype}",
            "-config", f"output.sizes.medium={medium}",
            "-o_size", "medium", "-y", f"{years:g}", "-o", out,
            "-o_format", o_format, *extra]


def summer_albedo(surface, state, t):
    """(albedo, melt [m/s ice equivalent]) at the mid-summer instant after
    model time ``t``: the stored albedo is the last interval's (often
    winter's albedo_max), so the feedback is evaluated there, the albedo
    brought to the melt by three fixed-point passes."""
    t_summer = (math.floor(t / SPY) + 0.55) * SPY
    geom = state.geometry
    a = surface.atmosphere(geom, t_summer)
    frac = t_summer / SPY - math.floor(t_summer / SPY)
    T = a.temperature + (a.temperature_july - a.temperature) \
        * math.cos(2.0 * math.pi * (frac - 0.5))
    M = surface.melt_components(t_summer, T, geom.ice_surface_elevation,
                                state.surface_albedo)[3]
    alb = None
    for _ in range(3):
        alb = surface.albedo_from_melt(M)
        M = surface.melt_components(t_summer, T, geom.ice_surface_elevation,
                                    alb)[3]
    return alb, M


def summary(model, state, t):
    """The JAX example's numbers of a state: volume [1e6 km^3], the
    minimum and margin-mean summer albedo and the maximum summer melt
    [m/a] over the ice."""
    import torch

    grid = model.grid
    H = state.geometry.ice_thickness.double()
    alb, M = summer_albedo(model.surface, state, t)
    ice = H > 1.0
    margin = ice & (H < 1500.0)
    return {
        "volume_1e6_km3": float(H.sum()) * grid.dx * grid.dy / 1e15,
        "summer_albedo_min": round(float(alb[ice].min()), 3),
        "summer_albedo_margin_mean": round(float(alb[margin].double().mean()),
                                           3) if bool(margin.any()) else None,
        "summer_melt_max_m_a": round(float(M[ice].max()) * SPY, 2),
        "nan": bool(torch.isnan(H).any()),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--km", type=float, default=20.0)
    ap.add_argument("--years", type=float, default=100.0)
    ap.add_argument("--warming", type=float, default=0.0,
                    help="uniform air-temperature offset [K]")
    ap.add_argument("--platform", default=None,
                    help="cpu runs on the CPU; the default is the card")
    ap.add_argument("--float32", action="store_true")
    ap.add_argument("--paleo", action="store_true",
                    help="Berger orbital insolation instead of present-day")
    args = ap.parse_args(argv)

    import torch

    device = "cpu" if args.platform == "cpu" else "cuda"
    model, state, grid = greenland_debm_model(
        "float32" if args.float32 else "float64", args.km, args.warming,
        args.paleo, device)
    print(f"grid: {grid.Mx} x {grid.My} x 41 ({args.km} km)")
    spin = min(10.0, args.years)
    tic = time.time()
    state, t, stats = model.step_once(state, 0.0, spin * SPY)
    print(f"{spin:g}y spin: {time.time() - tic:.0f} s")
    tic = time.time()
    state, t, stats = model.step_once(state, t, args.years * SPY)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - tic
    s = summary(model, state, t)
    print(json.dumps({
        "model_years": args.years,
        "steps": int(stats.nsteps),
        "wall_s": round(wall, 1),
        "model_years_per_hour": round(args.years / wall * 3600.0, 1),
        "volume_1e6_km3": s["volume_1e6_km3"],
        "summer_albedo_min": s["summer_albedo_min"],
        "summer_albedo_margin_mean": s["summer_albedo_margin_mean"],
        "summer_melt_max_m_a": s["summer_melt_max_m_a"],
        "nan": s["nan"],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
