"""The synthetic Antarctica PISM-PIK chain (BASELINE config 4), twin of the
JAX package's ``examples/antarctica_pik.py``.

PISM's Antarctic setup (``examples/searise-antarctica``, the PIK additions
of Winkelmann et al. 2011) needs the ALBMAP/SeaRISE dataset, which is not
in the repository, so the geometry is synthetic: a 4,000 x 4,000 km marine
ice sheet on an overdeepened bed with two embayments that grow ice
shelves (``setups.antarctic_geometry``). The chain: hybrid SSA+SIA,
enthalpy, pseudo-plastic Mohr-Coulomb sliding, PICO sub-shelf melt, eigen
and thickness calving with iceberg removal, part-grid, the sub-grid
grounding line, Lingle-Clark bed deformation, the PIK surface on a uniform
atmosphere.

``main`` runs ``setups.antarctica_pik_model`` through ``IceModel.step_once``
(a first 10 a segment, then 25 a segments to ``--years``) and prints the
JAX example's JSON keys. ``synthesize_data_file`` writes the same geometry
as a PISM data file (thk, topg, precipitation, lat, lon, theta_ocean,
salinity_ocean, two drainage basins; Antarctic polar-stereographic
``proj``) for the command line, and ``bootstrap_argv`` is the command line
that bootstraps it with the PIK flags:

  python -m pism_tpu_torch -i ant.nc -bootstrap -Mx 251 -My 251 -Mz 31 \\
      -Lx 2000 -Ly 2000 -Lz 5000 -stress_balance ssa+sia -pik \\
      -atmosphere pik -surface pik -ocean pico \\
      -calving eigen_calving,thickness_calving -bed_def lc ...

Usage: python -m pism_tpu_torch.examples.antarctica_pik [--km 16]
           [--years 300] [--platform cpu] [--float32] [--skip 10]
"""

import argparse
import json
import os
import subprocess
import time

import numpy as np

SPY = 3.15569259747e7
#: Antarctic polar stereographic (EPSG:3031), the ALBMAP/Bedmap grids' own
ANTARCTIC_PROJ = "+proj=stere +lat_0=-90 +lat_ts=-71 +lon_0=0 +k=1 +x_0=0 " \
    "+y_0=0 +ellps=WGS84 +units=m"
L = 2000e3                          # half extent of the domain [m]


def model_grid(km, Mz=31):
    from pism_tpu_torch.grid import Grid
    Mx = int(2 * L / (km * 1e3)) + 1
    return Grid(Mx=Mx, My=Mx, Lx=L, Ly=L, Mz=Mz, Lz=5000.0)


def synthesize_data_file(path, km, format="netcdf4", theta_offset=0.0):
    """The chain's geometry as a data file on the ``km`` grid: thk, topg,
    precipitation (0.25 m a-1 ice equivalent over ice and land, none over
    the ice-free ocean, as the accumulation maps of Antarctic datasets
    have it), lat/lon from ``ANTARCTIC_PROJ``, theta_ocean and salinity_ocean per
    basin (warm shelf water, ``theta_offset`` [K] warmer: an ensemble
    member's file), and basins 1 (x < 0) and 2. Returns the grid's Mx.

    The example's uniform atmosphere rains on the ocean too, and the mass
    step applies it there as the JAX package does, so there every ocean
    cell holds a floating film of ice after the first step and no calving
    front is left; with this file the calving laws have fronts to act on."""
    from pism_tpu_torch.io.nc4 import File
    from pism_tpu_torch.setups import antarctic_geometry
    from pism_tpu_torch.util import projection as prj

    grid = model_grid(km)
    H, bed, _ = antarctic_geometry(grid)
    lon, lat = prj.lonlat_for_grid(grid,
                                  prj.from_proj_string(ANTARCTIC_PROJ))
    X = np.meshgrid(grid.x, grid.y)[0]
    basins = np.where(X < 0.0, 1.0, 2.0)
    # warm water on the continental shelf (0.5 and 1 degC, as Circumpolar
    # Deep Water brings it): PICO's box cascade, taken cell by cell with
    # the local pressure as the JAX package takes it, turns non-finite
    # where water colder than the deep drafts' freezing point refreezes
    theta = np.where(basins == 1.0, 273.65, 274.15) + theta_offset
    salinity = np.where(basins == 1.0, 34.65, 34.7)
    with File(path, "w", format=format) as f:
        f.define_dimension("y", grid.My, grid.y, attrs={"units": "m"})
        f.define_dimension("x", grid.Mx, grid.x, attrs={"units": "m"})
        f.write("thk", H, ("y", "x"), {"units": "m"})
        f.write("topg", bed, ("y", "x"), {"units": "m"})
        f.write("precipitation",
                np.where((H <= 0.0) & (bed < 0.0), 0.0, 0.25 * 910.0),
                ("y", "x"), {"units": "kg m-2 year-1"})
        f.write("lat", lat, ("y", "x"), {"units": "degree_north"})
        f.write("lon", lon, ("y", "x"), {"units": "degree_east"})
        f.write("theta_ocean", theta, ("y", "x"), {"units": "K"})
        f.write("salinity_ocean", salinity, ("y", "x"), {"units": "g/kg"})
        f.write("basins", basins, ("y", "x"), {})
        f.set_global_attr("proj", ANTARCTIC_PROJ)
    return grid.Mx


def bootstrap_argv(data, out, km, years, o_format="netcdf4", Mz=31,
                   dtype="float32", extra=()):
    """The PIK chain's command line bootstrapping ``data`` onto the ``km``
    grid for ``years``: the example's config through the PIK flags, PICO
    and the atmosphere's precipitation from the data file (so that a plain
    ``-i`` restart finds them again); ``extra`` is appended (a
    ``-platform``, more ``-config``)."""
    Mx = int(2 * L / (km * 1e3)) + 1
    return ["-i", data, "-bootstrap", "-Mx", str(Mx), "-My", str(Mx),
            "-Mz", str(Mz), "-Lx", f"{L / 1e3:g}", "-Ly", f"{L / 1e3:g}",
            "-Lz", "5000", "-stress_balance", "ssa+sia", "-pik",
            "-atmosphere", "pik", "-surface", "pik", "-ocean", "pico",
            "-calving", "eigen_calving,thickness_calving", "-bed_def", "lc",
            "-pseudo_plastic", "-pseudo_plastic_q", "0.75",
            "-skip", "-skip_max", "10",
            "-config", "calving.eigen_calving.K=1e17",
            "-config", "calving.thickness_calving.threshold=150",
            "-config", f"ocean.pico.file={data}",
            "-config", f"atmosphere.searise_greenland.file={data}",
            "-config", f"runtime.float_dtype={dtype}",
            "-y", f"{years:g}", "-o", out, "-o_format", o_format,
            "-verbose", "1", *extra]


def couplers(config, grid, data, device="cuda"):
    """The couplers the command line builds for ``bootstrap_argv``'s run
    of ``data``, from Python: (surface, ocean) through the factory, the
    surface's latitude read from ``data`` as the command line reads it."""
    import torch

    from pism_tpu_torch.coupler import factory as cf
    from pism_tpu_torch.io.bootstrap import read_and_regrid

    fdt = torch.float32 \
        if config.get_string("runtime.float_dtype") == "float32" \
        else torch.float64
    lat = read_and_regrid(data, grid, ["lat"])["lat"]
    atm = cf.atmosphere_from_config(
        config, cf.inputs_from_files(config, grid, "atmosphere", device))
    surface = cf.surface_from_config(
        config, {"latitude": torch.as_tensor(lat).to(device=device,
                                                     dtype=fdt)},
        atmosphere=atm)
    ocean = cf.ocean_from_config(
        config, cf.inputs_from_files(config, grid, "ocean", device),
        grid=grid)
    return surface, ocean


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--km", type=float, default=16.0)
    ap.add_argument("--years", type=float, default=300.0)
    ap.add_argument("--platform", default=None,
                    help="cpu runs on the CPU; the default is the card")
    ap.add_argument("--float32", action="store_true")
    ap.add_argument("--skip", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    from pism_tpu_torch import setups
    from pism_tpu_torch import state as S
    from pism_tpu_torch.model.icemodel import _merge_stats

    device = "cpu" if args.platform == "cpu" else "cuda"
    model, state, grid = setups.antarctica_pik_model(
        "float32" if args.float32 else "float64", km=args.km, device=device,
        extra_cfg={"time_stepping.skip.enabled": args.skip > 1,
                   "time_stepping.skip.max": max(args.skip, 1)})
    print(f"grid: {grid.Mx} x {grid.My} x {grid.Mz} ({args.km:g} km)")
    commit = subprocess.run(
        ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
        text=True, cwd=os.path.dirname(os.path.abspath(__file__))
    ).stdout.strip()

    tic = time.time()
    state, t, _ = model.step_once(state, 0.0, 10.0 * SPY)
    print(f"first 10 a: {time.time() - tic:.1f} s")
    tic = time.time()
    nsteps, seg = 0, None
    t_end = args.years * SPY
    while t < t_end - 1.0:
        state, t, stats = model.step_once(state, t, min(25.0 * SPY, t_end - t))
        nsteps += stats.nsteps
        seg = _merge_stats(seg, stats)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.time() - tic
    H = state.geometry.ice_thickness.double()
    floating = S.floating_ice(state.geometry.cell_type)
    print(json.dumps({
        "model_years": args.years,
        "steps": nsteps,
        "wall_s": round(wall, 1),
        "model_years_per_hour": round((args.years - 10.0) / wall * 3600.0, 1)
        if wall > 0 else None,
        "volume_1e6_km3": float(H.sum()) * grid.dx * grid.dy / 1e15,
        "shelf_area_1e3_km2": float(floating.sum()) * grid.dx * grid.dy / 1e9,
        "max_speed_m_a": float(state.u_ssa.abs().max()) * SPY,
        "nan": bool(torch.isnan(H).any()),
        "commit": commit,
        "steps_per_model_year": round(nsteps / max(args.years - 10.0, 1e-9),
                                      2),
        "dt_limit_hits": seg.limit_hits_dict() if seg is not None else {},
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
