"""PISM's ``examples/std-greenland`` tutorial, end to end through the
port's command line (twin of ``examples/std_greenland_workflow.py``).

The tutorial (PISM manual "Getting started", the ``spinup.sh`` G20km runs)
bootstraps from the SeaRISE Greenland dataset and spins up in stages, each
restarting from the previous stage's file:

  1. bootstrap and a short SIA smoothing run  (``-bootstrap``);
  2. thermal evolution with fixed geometry    (``geometry.update.enabled
     = false``);
  3. the hybrid SSA+SIA pseudo-plastic spin-up (``-stress_balance ssa+sia
     -pseudo_plastic -pseudo_plastic_q 0.25 -skip -skip_max 10``).

The real dataset (``pism_Greenland_5km_v1.1.nc``) is not in the repository,
so the data file is synthesized with the same variables (thk, topg,
precipitation, ice_surface_temp, lat, lon) and formula as the JAX
example's; ``-atmosphere searise_greenland`` reads lat/lon/precipitation
from it and ``-surface pdd`` melts with the Calov-Greve scheme. Unlike the
JAX example, the model grid spans the file's extent (``-Lx 750 -Ly 1400``),
so ``--km 20`` is the tutorial's 20 km grid, 76 x 141, and the file's own
resolution is the identity regrid. The data file carries SeaRISE's
polar-stereographic ``proj`` attribute, as the real file does, so every
output carries lat/lon and their bounds from it. ``--o_format netcdf3``
writes every file, the data file included, as classic NetCDF (no h5py
needed).

Usage: python -m pism_tpu_torch.examples.std_greenland_workflow [--km 20]
           [--quick] [--workdir DIR] [--platform cpu] [--o_format netcdf3]
"""

import argparse
import json
import os
import time

import numpy as np

#: SeaRISE Greenland's grid: polar stereographic, standard parallel 71 N,
#: central meridian 39 W (PROJ string)
SEARISE_PROJ = "+proj=stere +lat_0=90 +lat_ts=71 +lon_0=-39 +k=1 +x_0=0 " \
    "+y_0=0 +ellps=WGS84 +units=m"
LX, LY = 750e3, 1400e3     # the data file's half extents [m]


def synthesize_bootstrap_file(path, km, format="netcdf4", proj=None):
    """Greenland-scale synthetic input with the SeaRISE variable set, on a
    grid of ``km`` spacing; returns its (nx, ny)."""
    from pism_tpu_torch.io.nc4 import File

    nx = int(2 * LX / (km * 1e3)) + 1
    ny = int(2 * LY / (km * 1e3)) + 1
    x = np.linspace(-LX, LX, nx)
    y = np.linspace(-LY, LY, ny)
    X, Y = np.meshgrid(x, y)
    r2 = (X / (0.55 * LX)) ** 2 + (Y / (0.8 * LY)) ** 2
    bed = 400.0 - 900.0 * r2 + 150.0 * np.sin(X / 120e3) * np.cos(Y / 160e3)
    thk = 2800.0 * np.maximum(1.0 - r2, 0.0) ** 1.5 * (bed > -600)
    lat = 60.0 + (Y + LY) / (2 * LY) * 23.0          # 60N..83N
    lon = -45.0 + X / (111e3 * np.cos(np.radians(72.0)))
    # precipitation: wetter in the (warmer) south, drier interior north
    precip = (1500.0 - 1100.0 * (lat - 60.0) / 23.0) * np.exp(
        -np.maximum(bed + thk, 0.0) / 2500.0)        # kg m-2 year-1
    t_sfc = 273.15 + 30.0 - 0.85 * (lat - 60.0) \
        - 0.0075 * np.maximum(bed + thk, 0.0)        # lapse + latitude

    with File(path, "w", format=format) as f:
        f.define_dimension("y", ny, y, attrs={"units": "m"})
        f.define_dimension("x", nx, x, attrs={"units": "m"})
        f.write("thk", thk, ("y", "x"), {"units": "m"})
        f.write("topg", bed, ("y", "x"), {"units": "m"})
        f.write("precipitation", precip, ("y", "x"),
                {"units": "kg m-2 year-1"})
        f.write("ice_surface_temp", np.minimum(t_sfc, 273.15), ("y", "x"),
                {"units": "K"})
        f.write("lat", lat, ("y", "x"), {"units": "degree_north"})
        f.write("lon", lon, ("y", "x"), {"units": "degree_east"})
        if proj:
            f.set_global_attr("proj", proj)
    return nx, ny


def stage_argv(boot, files, km, years, o_format="netcdf4", Mz=41,
               dtype="float32", platform=None):
    """The three stages' command lines: bootstrap + SIA smoothing, no-mass
    thermal, hybrid spin-up; ``files`` are their outputs, ``years`` their
    lengths."""
    nx = int(2 * LX / (km * 1e3)) + 1
    ny = int(2 * LY / (km * 1e3)) + 1
    pre, nomass, spun = files
    y1, y2, y3 = years
    # every stage re-reads the parameterization's inputs (lat/lon and
    # precipitation) from the data file, as the tutorial's script passes
    # $PISM_DATANAME to each stage
    common = ["-atmosphere", "searise_greenland", "-surface", "pdd",
              "-config", f"runtime.float_dtype={dtype}", "-verbose", "1",
              "-config", f"atmosphere.searise_greenland.file={boot}",
              "-o_format", o_format]
    if platform:
        common += ["-platform", platform]
    return (
        ["-i", boot, "-bootstrap", "-Mx", str(nx), "-My", str(ny),
         "-Mz", str(Mz), "-Lx", f"{LX / 1e3:g}", "-Ly", f"{LY / 1e3:g}",
         "-Lz", "4000", "-stress_balance", "sia", "-y", f"{y1:g}",
         "-o", pre] + common,
        ["-i", pre, "-y", f"{y2:g}", "-o", nomass,
         "-config", "geometry.update.enabled=false"] + common,
        ["-i", nomass, "-y", f"{y3:g}", "-o", spun,
         "-stress_balance", "ssa+sia", "-pseudo_plastic",
         "-pseudo_plastic_q", "0.25", "-skip", "-skip_max", "10",
         "-config", "geometry.update.enabled=true"] + common)


def volume_of(path):
    """(ice volume [km^3], last thickness record) of an output file."""
    from pism_tpu_torch.io.nc4 import File
    with File(path, "r") as f:
        thk = np.asarray(f.read("thk"), float)
        if thk.ndim == 3:
            thk = thk[-1]
        x = np.asarray(f.read("x"), float)
        y = np.asarray(f.read("y"), float)
    dx, dy = x[1] - x[0], y[1] - y[0]
    return float(np.nan_to_num(thk).sum() * dx * dy / 1e9), thk


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--km", type=float, default=20.0)
    ap.add_argument("--quick", action="store_true",
                    help="tiny stage lengths (smoke runs)")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--platform", default=None,
                    help="cpu runs on the CPU; the default is the card")
    ap.add_argument("--o_format", default="netcdf4",
                    choices=("netcdf4", "netcdf3"))
    args = ap.parse_args(argv)

    from pism_tpu_torch import cli

    work = args.workdir or f"std_greenland_{args.km:g}km"
    os.makedirs(work, exist_ok=True)
    boot = os.path.join(work, "g_boot.nc")
    files = tuple(os.path.join(work, n)
                  for n in ("g_pre.nc", "g_nomass.nc", "g_spunup.nc"))
    years = (2.0, 5.0, 5.0) if args.quick else (100.0, 500.0, 200.0)
    nx, ny = synthesize_bootstrap_file(boot, args.km, args.o_format,
                                       SEARISE_PROJ)
    print(f"bootstrap file: {boot} ({nx} x {ny} @ {args.km:g} km)")
    tic = time.time()
    volumes = []
    names = ("bootstrap smoothing", "no-mass thermal", "hybrid spinup")
    for k, (argv_k, name, path, y) in enumerate(zip(
            stage_argv(boot, files, args.km, years, args.o_format,
                       platform=args.platform), names, files, years)):
        rc = cli.main(argv_k)
        if rc != 0:
            raise SystemExit(f"stage {k + 1} ({name}) failed")
        volumes.append(volume_of(path)[0])
        print(f"stage {k + 1} ({name} {y:g} a): volume {volumes[-1]:10.1f} "
              "km^3")
    v1, v2, v3 = volumes
    thk = volume_of(files[-1])[1]
    ok = (np.isfinite(thk).all() and v3 > 0.2 * v1
          and abs(v2 - v1) < 0.02 * v1)   # no-mass must not move mass
    print(json.dumps({
        "workflow": "std-greenland (synthetic)", "km": args.km,
        "stages_years": list(years),
        "volumes_km3": [round(v, 1) for v in volumes],
        "wall_s": round(time.time() - tic, 1), "ok": bool(ok),
    }))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
