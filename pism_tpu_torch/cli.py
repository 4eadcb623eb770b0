"""The command line (port of ``pism_tpu/cli.py``; PISM's ``pismv``
verification runs, the EISMINT II experiments, bootstrapping and restarts).

Routes of the port:

- ``-test A/D/H/L``: the verification runner (``verification/runner.py``);
- ``-test B/C``: the Halfar similarity solutions with an error report;
- ``-eisII A/B/C/D/F``: EISMINT II from zero ice, or, with ``-i``, from a
  saved state (experiments B-D restart from A's end state);
- ``-i FILE -bootstrap``: a state from a data file on its own grid
  (``io/bootstrap.py``) on the grid of ``-Mx/-My/-Mz/-Lx/-Ly/-Lz``;
- ``-i FILE``: continue a state saved by either package; the coupler
  chains stored in its config are rebuilt (zero SMB without one).

With each route, ``-regrid_file``/``-regrid_vars`` replace 2D fields by
ones regridded from another file, the coupler flags (``-atmosphere``,
``-surface``, ``-ocean``, ``-sea_level``) build chains through
``coupler/factory.py``, and ``stress_balance.ssa.dirichlet_bc`` reads the
SSA's Dirichlet velocities from ``-i``.

Every parser option of the JAX CLI parses. The options that need a module
the port does not carry yet raise NotImplementedError naming the ROADMAP
item that brings it. Fields live on the card (``cuda``) unless
``-platform cpu`` is given; without a card the run raises.

Examples:
  python -m pism_tpu_torch -test B -Mx 61 -y 1000 -o b.nc -o_format netcdf3
  python -m pism_tpu_torch -eisII A -y 1000 -o a.nc -o_format netcdf3 \\
      -ts_file ts.nc -ts_times 0:100:1000 -extra_file ex.nc \\
      -extra_times 0:500:1000
  python -m pism_tpu_torch -i a.nc -y 100 -o b.nc -o_format netcdf3
  python -m pism_tpu_torch -i g_boot.nc -bootstrap -Mx 76 -My 141 -Mz 41 \\
      -Lx 750 -Ly 1400 -Lz 4000 -stress_balance sia \\
      -atmosphere searise_greenland -surface pdd -y 100 -o g_pre.nc \\
      -o_format netcdf3
  python -m pism_tpu_torch -i ant.nc -bootstrap -Mx 251 -My 251 -Mz 31 \\
      -Lx 2000 -Ly 2000 -Lz 5000 -stress_balance ssa+sia -pik \\
      -atmosphere pik -surface pik -ocean pico \\
      -calving eigen_calving,thickness_calving -bed_def lc \\
      -config ocean.pico.file=ant.nc \\
      -config atmosphere.searise_greenland.file=ant.nc -y 10 -o ant_10.nc
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import time as _wall

import numpy as np

from .config import Config
from .grid import Grid
from .util.timecal import Calendar, Time

SEC_PER_YEAR = 3.15569259747e7

_TIME_KEYWORDS = {"yearly": 1.0, "monthly": 1.0 / 12.0,
                  "daily": 1.0 / 365.0, "hourly": 1.0 / 8760.0}


def parse_times(spec: str, year_length: float, start=None, end=None):
    """PISM-style time list: "a:step:b" (step a number of model years or a
    keyword yearly/monthly/daily/hourly), a bare keyword (covers the whole
    run [start, end], in model years), or a comma list of model years."""
    if ":" in spec:
        a, step, b = spec.split(":")
        a, b = float(a), float(b)
        st = _TIME_KEYWORDS.get(step, None)
        st = float(step) if st is None else st
        return [t * year_length for t in np.arange(a, b + st / 2, st)]
    if spec in _TIME_KEYWORDS:
        if start is None or end is None:
            raise ValueError(f"bare {spec!r} needs a known run interval")
        st = _TIME_KEYWORDS[spec]
        a = np.ceil(start / st) * st     # align to keyword multiples
        return [t * year_length for t in np.arange(a, end + st / 2, st)]
    return [float(s) * year_length for s in spec.split(",")]


_PARAM_SHORTHANDS = [
    ("-sia_e", "stress_balance.sia.enhancement_factor", float),
    ("-ssa_e", "stress_balance.ssa.enhancement_factor", float),
    ("-pseudo_plastic_q", "basal_resistance.pseudo_plastic.q", float),
    ("-pseudo_plastic_uthreshold",
     "basal_resistance.pseudo_plastic.u_threshold", float),
    ("-plastic_phi", "basal_yield_stress.mohr_coulomb.till_phi_default",
     float),
    ("-till_effective_fraction_overburden",
     "basal_yield_stress.mohr_coulomb.till_effective_fraction_overburden",
     float),
    ("-thickness_calving_threshold", "calving.thickness_calving.threshold",
     float),
    ("-eigen_calving_K", "calving.eigen_calving.K", float),
    ("-sia_flow_law", "stress_balance.sia.flow_law", str),
    ("-ssa_flow_law", "stress_balance.ssa.flow_law", str),
    ("-ssa_method", "stress_balance.ssa.method", str),
]


def build_parser():
    p = argparse.ArgumentParser(prog="pism_tpu_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("-i", metavar="FILE", help="restart from a model-state file")
    p.add_argument("-bootstrap", action="store_true",
                   help="treat -i as a bootstrap file (regrid 2D fields, heuristics for the rest)")
    p.add_argument("-eisII", metavar="EXP",
                   help="EISMINT II experiment (A-L, incl. the sector-sliding E)")
    p.add_argument("-test", metavar="LETTER",
                   help="verification test (A-P, V)")
    p.add_argument("-y", type=float, default=None, help="run length [years]")
    p.add_argument("-ys", type=float, default=None, help="start time [years]")
    p.add_argument("-ye", type=float, default=None, help="end time [years]")
    p.add_argument("-o", default="out.nc", help="output (model state) file")
    p.add_argument("-Mx", type=int, default=None)
    p.add_argument("-My", type=int, default=None)
    p.add_argument("-Mz", type=int, default=None)
    p.add_argument("-Lx", type=float, default=None,
                   help="half-width of the domain [km] (with -bootstrap)")
    p.add_argument("-Ly", type=float, default=None,
                   help="half-length of the domain [km] (with -bootstrap)")
    p.add_argument("-Lz", type=float, default=None,
                   help="height of the computational box [m]")
    p.add_argument("-extra_file", default=None)
    p.add_argument("-extra_times", default=None)
    p.add_argument("-extra_vars", default=None,
                   help="comma list of -extra_file diagnostics (default: "
                        "config output.extra.vars or thk,usurf,velbar_mag,"
                        "mask)")
    p.add_argument("-ts_file", default=None)
    p.add_argument("-ts_times", default=None)
    p.add_argument("-ts_vars", default=None,
                   help="scalar time-series quantities (instantaneous or "
                        "interval-averaged tendency_* rates; default: "
                        "config output.timeseries.variables)")
    p.add_argument("-save_file", default=None,
                   help="snapshot file pattern (e.g. snap_{kyr:.1f}.nc)")
    p.add_argument("-view", default=None, metavar="VAR[,VAR...]",
                   help="runtime map viewer (PISM -view)")
    p.add_argument("-save_times", default=None,
                   help="snapshot times [years] (a:step:b or comma list)")
    p.add_argument("-backup_interval", type=float, default=0.0,
                   help="wall-clock hours between backups")
    for flag, key, typ in _PARAM_SHORTHANDS:
        p.add_argument(flag, type=typ, default=None, help=f"sets {key}")
    p.add_argument("-pseudo_plastic", action="store_true",
                   help="sets basal_resistance.pseudo_plastic.enabled")
    p.add_argument("-config", action="append", default=[],
                   metavar="KEY=VALUE", help="config override (repeatable)")
    p.add_argument("-config_override", metavar="FILE", default=None,
                   help="merge config overrides from a file (.json dict or a "
                        "NetCDF file carrying a stored config)")
    p.add_argument("-atmosphere", default=None,
                   help="atmosphere model chain (e.g. uniform,delta_T)")
    p.add_argument("-surface", default=None,
                   help="surface model chain (e.g. simple | pdd,cache)")
    p.add_argument("-ocean", default=None,
                   help="ocean model chain (e.g. constant | pik,cache)")
    p.add_argument("-sea_level", default=None, help="sea level model chain")
    p.add_argument("-stress_balance", default=None,
                   help="none|prescribed_sliding|sia|ssa|ssa+sia|"
                        "weertman_sliding|blatter")
    p.add_argument("-energy", default=None, help="none | cold | enthalpy")
    p.add_argument("-hydrology", default=None,
                   help="null | routing | distributed | steady")
    p.add_argument("-calving", default=None,
                   help="comma list: thickness_calving,eigen_calving,"
                        "vonmises_calving,hayhurst_calving,float_kill,"
                        "ocean_kill,prescribed_retreat")
    p.add_argument("-bed_def", default=None, help="none | iso | lc | given")
    p.add_argument("-skip", action="store_true",
                   help="enable mass-transport subcycling between expensive "
                        "energy/stress-balance updates")
    p.add_argument("-skip_max", type=int, default=None)
    p.add_argument("-pik", action="store_true",
                   help="enable the PIK marine mechanisms at once: "
                        "-cfbc -part_grid -kill_icebergs -subgl")
    p.add_argument("-cfbc", action="store_true",
                   help="calving-front stress boundary condition")
    p.add_argument("-part_grid", action="store_true",
                   help="sub-grid front advance (Albrecht part-grid)")
    p.add_argument("-kill_icebergs", action="store_true",
                   help="remove floating cells not connected to grounded ice")
    p.add_argument("-subgl", action="store_true",
                   help="sub-grid grounding line (grounded cell fraction "
                        "scales basal drag)")
    p.add_argument("-max_dt", type=float, default=None,
                   help="maximum time step [years]")
    p.add_argument("-no_model_strip", type=float, default=None, metavar="KM",
                   help="regional mode: freeze a strip this wide [km] along "
                        "the domain boundary (PISM -regional)")
    p.add_argument("-regional", action="store_true",
                   help="regional (outlet-glacier) mode")
    p.add_argument("-o_format", default="netcdf4",
                   choices=("netcdf4", "netcdf3"),
                   help="output format: netcdf4 (HDF5, needs h5py) | netcdf3 "
                        "(classic CDF-2; PISM -o_format)")
    p.add_argument("-o_size", default="small",
                   choices=("small", "medium", "big"),
                   help="output-file size: small = model state only (the "
                        "restartable checkpoint), medium adds common 2D "
                        "diagnostics, big adds the 3D fields (PISM -o_size)")
    p.add_argument("-inverse", action="store_true",
                   help="run a basal yield stress / hardness inversion")
    p.add_argument("-inv_data", metavar="FILE", default=None,
                   help="file with observed velocities")
    p.add_argument("-inv_design", default=None, help="tauc | hardav")
    p.add_argument("-inv_method", default=None, help="lbfgs | adam")
    p.add_argument("-regrid_file", metavar="FILE", default=None,
                   help="after -i, replace selected 2D fields with regridded "
                        "values from FILE (PISM -regrid_file)")
    p.add_argument("-regrid_vars", default="thk",
                   help="comma list of variables for -regrid_file")
    p.add_argument("-profile", metavar="LOGDIR", default=None,
                   help="write a torch.profiler trace of the run to "
                        "LOGDIR/trace.json (PISM -profile)")
    p.add_argument("-platform", default=None,
                   help="cpu puts every field on the CPU; the default (or "
                        "cuda) puts them on the card")
    p.add_argument("-verbose", type=int, default=2)
    p.add_argument("-list_params", action="store_true",
                   help="print every configuration parameter and exit")
    p.add_argument("-list_diagnostics", action="store_true",
                   help="print all available diagnostics and exit")
    return p


def _apply_config_overrides(cfg: Config, pairs):
    for pair in pairs:
        k, v = pair.split("=", 1)
        for conv in (int, float):
            try:
                if conv is int and ("." in v or "e" in v.lower()):
                    continue
                cfg.update({k: conv(v)})
                break
            except (ValueError, KeyError):
                continue
        else:
            if v in ("true", "false", "yes", "no"):
                cfg.update({k: v in ("true", "yes")})
            else:
                cfg.update({k: v})


def _unported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not implemented in pism_tpu_torch (ROADMAP Queue 1 "
        f"item {item})")


def _refuse_unported(args):
    """Options that need a module the port does not carry yet."""
    for flag, item in (("list_params", "4"), ("list_diagnostics", "3"),
                       ("regional", "7"), ("no_model_strip", "7"),
                       ("inverse", "10"), ("view", "4")):
        if getattr(args, flag) not in (None, False):
            raise _unported(f"-{flag}", item)
    if args.test and args.test.upper() not in tuple("ABCDHL"):
        raise _unported(f"-test {args.test}", "5")


def _regrid(args, grid, state):
    """PISM ``-regrid_file``/``-regrid_vars``: the named 2D fields replaced
    by values regridded from another file where those are not NaN (the
    regridder clamps to the file's edges, so only NaN data keeps the
    restored values)."""
    import torch

    from .io.bootstrap import read_and_regrid
    from .io.checkpoint import _STATE_VARS
    from .util.logger import log

    names = [s.strip() for s in args.regrid_vars.split(",") if s.strip()]
    fields = read_and_regrid(args.regrid_file, grid, variables=names)
    geom = state.geometry
    by_var = {v[0]: k for k, v in _STATE_VARS.items() if v[2] == 2}
    by_var.update(thk="ice_thickness", topg="bed_elevation")
    for var, arr in fields.items():
        if var not in by_var:
            print(f"warning: -regrid_vars {var!r} is not a regriddable 2D "
                  "state variable; skipped", file=sys.stderr)
            continue
        name = by_var[var]
        owner = geom if var in ("thk", "topg") else state
        old = getattr(owner, name)
        if old is None:
            old = torch.zeros_like(geom.ice_thickness)
        new = torch.as_tensor(arr).to(old.device)
        new = torch.where(torch.isnan(new), old, new.to(old.dtype))
        if owner is geom:
            geom = geom.replace(**{name: new})
        else:
            state = state.replace(**{name: new})
    log.message(2, "regridded %s from %s", ",".join(fields), args.regrid_file)
    return state.replace(geometry=geom)


def _couplers(args, cfg, grid, device):
    """The coupler chains of the flags, or on a ``-i`` restart of the
    chains stored in the file's config: ``(surface, ocean, sea_level)``,
    each None where nothing selects one."""
    import torch

    from .coupler import factory as cf
    from .io.bootstrap import (latitude_from_projection,
                               lonlat_from_projection, read_and_regrid,
                               read_forcing_fields)

    nd = cfg.non_default()
    atm_sel = args.atmosphere or (args.i and nd.get("atmosphere.models"))
    surf_sel = args.surface or (args.i and not args.eisII
                                and nd.get("surface.models"))
    ocean_sel = args.ocean or (args.i and nd.get("ocean.models"))
    sl_sel = args.sea_level or (args.i and nd.get("sea_level.models"))
    fdt = torch.float32 if cfg.get_string("runtime.float_dtype") == "float32" \
        else torch.float64

    def field(a):
        return torch.as_tensor(a).to(device=device, dtype=fdt)

    surface = ocean = sea_level = atm = None
    if atm_sel:
        cfg.update({"atmosphere.models": atm_sel})
        inputs = cf.inputs_from_files(cfg, grid, "atmosphere", device)
        if args.i and str(atm_sel).split(",")[0] in ("searise_greenland",
                                                     "pik"):
            # PISM reads the parameterization's inputs (lat/lon and the
            # precipitation map) from the input file when no forcing file
            # gives them; lat/lon from its projection if it has none
            flds = read_and_regrid(args.i, grid, variables=[
                "lat", "latitude", "lon", "longitude"])
            lat = flds.get("lat", flds.get("latitude"))
            lon = flds.get("lon", flds.get("longitude"))
            if (lat is None or lon is None) and cfg.get_flag(
                    "grid.recompute_longitude_and_latitude"):
                lon_p, lat_p = lonlat_from_projection(args.i, grid)
                lat = lat if lat is not None else lat_p
                lon = lon if lon is not None else lon_p
            if lat is not None:
                inputs.setdefault("latitude", field(lat))
            if lon is not None:
                inputs.setdefault("longitude", field(lon))
            if "precipitation" not in inputs:
                pf, _ = read_forcing_fields(args.i, grid, ["precipitation"])
                if "precipitation" in pf:
                    p = pf["precipitation"]
                    inputs["precipitation"] = field(p[-1] if p.ndim == 3
                                                    else p)
        atm = cf.atmosphere_from_config(cfg, inputs=inputs, grid=grid)
    elif surf_sel and any(m in surf_sel for m in ("simple", "pdd", "pik")):
        # a restored surface chain that needs an atmosphere whose own chain
        # is the default (not stored as non-default): built from the config
        atm = cf.atmosphere_from_config(
            cfg, inputs=cf.inputs_from_files(cfg, grid, "atmosphere", device),
            grid=grid)
    if surf_sel:
        cfg.update({"surface.models": surf_sel})
        inputs = cf.inputs_from_files(cfg, grid, "surface", device)
        if args.i and "pik" in surf_sel:
            # the latitude-dependent surface model reads lat from the input
            # file (PISM's mandatory lat/lon), else from its projection
            flds = read_and_regrid(args.i, grid,
                                   variables=["lat", "latitude"])
            lat = flds.get("lat", flds.get("latitude"))
            if lat is None and cfg.get_flag(
                    "grid.recompute_longitude_and_latitude"):
                lat = latitude_from_projection(args.i, grid)
            if lat is not None:
                inputs["latitude"] = field(lat)
        surface = cf.surface_from_config(cfg, inputs=inputs, atmosphere=atm)
    elif atm is not None:
        from .coupler.surface import Simple
        surface = Simple(atmosphere=atm)
    if ocean_sel:
        cfg.update({"ocean.models": ocean_sel})
        ocean = cf.ocean_from_config(
            cfg, inputs=cf.inputs_from_files(cfg, grid, "ocean", device),
            grid=grid)
    if sl_sel:
        cfg.update({"sea_level.models": sl_sel})
        sea_level = cf.sea_level_from_config(
            cfg, inputs=cf.inputs_from_files(cfg, grid, "sea_level", device))
    return surface, ocean, sea_level


def _dirichlet_bc(args, grid, model, device, dtype):
    """PISM ``-ssa_dirichlet_bc``: ``bc_mask`` and ``u_bc``/``v_bc`` (m/year
    in files) from ``-i`` fix the SSA velocity where the mask is set."""
    import torch

    from .io.bootstrap import read_and_regrid

    flds = read_and_regrid(args.i, grid,
                           ["bc_mask", "u_bc", "v_bc", "u_ssa_bc", "v_ssa_bc"])
    bcm = flds.get("bc_mask")
    ub = flds.get("u_bc", flds.get("u_ssa_bc"))
    vb = flds.get("v_bc", flds.get("v_ssa_bc"))
    if bcm is None or ub is None or vb is None:
        raise SystemExit("-config stress_balance.ssa.dirichlet_bc=True needs "
                         "bc_mask, u_bc and v_bc variables in the -i file")
    if model.ssa is None:
        raise SystemExit("ssa.dirichlet_bc needs an SSA stress balance")
    model.ssa.bc_mask = torch.as_tensor(np.nan_to_num(bcm) > 0.5,
                                        device=device)
    model.ssa.bc_u = torch.as_tensor(np.nan_to_num(ub) / SEC_PER_YEAR).to(
        device=device, dtype=dtype)
    model.ssa.bc_v = torch.as_tensor(np.nan_to_num(vb) / SEC_PER_YEAR).to(
        device=device, dtype=dtype)


def _device(platform):
    """The torch device of every field: the card unless ``-platform cpu``;
    without a card this raises instead of running on the CPU."""
    import torch

    name = (platform or "cuda").lower()
    if name == "cpu":
        return torch.device("cpu")
    if name not in ("cuda", "gpu"):
        raise ValueError(f"-platform {platform!r}: expected cpu or cuda")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available; pass -platform cpu "
                           "to run on the CPU")
    return torch.device("cuda")


def _configure(args, cfg) -> None:
    """The flags' config parameters, set on ``cfg``."""
    if args.i and not cfg.get_string("grid.projection"):
        # the input file's grid mapping carries over to the outputs
        from .io.nc4 import File
        with File(args.i, "r") as f:
            proj = f.get_global_attr("proj")
        if proj is not None:
            cfg.update({"grid.projection": str(proj)})

    if args.config_override:
        if args.config_override.endswith(".json"):
            import json
            with open(args.config_override) as f:
                cfg.update(json.load(f))
        else:
            from .io import checkpoint as ckpt
            cfg.update(ckpt.load_config(args.config_override).non_default())
    # component-selection shorthands -> config parameters
    for flag, key in (("stress_balance", "stress_balance.model"),
                      ("energy", "energy.model"),
                      ("hydrology", "hydrology.model"),
                      ("calving", "calving.methods"),
                      ("bed_def", "bed_deformation.model")):
        if getattr(args, flag):
            cfg.update({key: getattr(args, flag)})
    if args.skip:
        cfg.update({"time_stepping.skip.enabled": True})
    if args.skip_max is not None:
        cfg.update({"time_stepping.skip.enabled": True,
                    "time_stepping.skip.max": args.skip_max})
    for flag, key, _typ in _PARAM_SHORTHANDS:
        val = getattr(args, flag.lstrip("-"))
        if val is not None:
            cfg.update({key: val})
    if args.pseudo_plastic:
        cfg.update({"basal_resistance.pseudo_plastic.enabled": True})
    if args.pik or args.cfbc:
        cfg.update({"stress_balance.calving_front_stress_bc": True})
    if args.pik or args.part_grid:
        cfg.update({"geometry.part_grid.enabled": True})
    if args.pik or args.kill_icebergs:
        cfg.update({"geometry.remove_icebergs": True})
    if args.pik or args.subgl:
        cfg.update({"geometry.grounded_cell_fraction": True})
    if args.max_dt is not None:   # stored in years
        cfg.update({"time_stepping.maximum_time_step": args.max_dt})
    _apply_config_overrides(cfg, args.config)

    # every option is a config parameter, so the stored config in the
    # outputs reflects the run's settings
    if args.platform:
        cfg.update({"runtime.platform": args.platform})
    if args.profile:
        cfg.update({"runtime.profile.directory": args.profile})
    if args.ts_vars:
        cfg.update({"output.timeseries.variables": args.ts_vars})
    cfg.update({"run_info.command": " ".join(sys.argv)})
    cfg.update({"runtime.verbosity": args.verbose})
    if args.i:
        cfg.update({"input.file": args.i})
    cfg.update({"input.bootstrap": bool(args.bootstrap)})
    if args.regrid_file:
        cfg.update({"input.regrid.file": args.regrid_file,
                    "input.regrid.vars": args.regrid_vars})
    cfg.update({"output.file": args.o})
    if args.ys is not None:
        cfg.update({"time.start": args.ys})
    if args.ye is not None:
        cfg.update({"time.end": args.ye})
    if args.y is not None:
        cfg.update({"time.run_length": args.y})


def bootstrap_config(argv):
    """The config a ``-i FILE -bootstrap`` run of ``argv`` runs with, its
    coupler selections included (what the run's outputs store), without
    bootstrapping or running."""
    args = build_parser().parse_args(argv)
    cfg = Config()
    _apply_config_overrides(cfg, args.config)
    _configure(args, cfg)
    for sel, key in ((args.atmosphere, "atmosphere.models"),
                     (args.surface, "surface.models"),
                     (args.ocean, "ocean.models"),
                     (args.sea_level, "sea_level.models")):
        if sel:
            cfg.update({key: sel})
    return cfg


def main(argv=None):
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    device = _device(args.platform)

    import torch

    from .io import checkpoint as ckpt
    from .model.icemodel import IceModel
    from .model.output import OutputManager
    from .setups import halfar_report
    from .state import ModelState, map_tensors, new_geometry
    from .util.logger import log, set_verbosity

    set_verbosity(args.verbose)

    t0 = 0.0
    sol = None
    if args.eisII:
        from .verification import eismint2
        if args.i:  # restart experiment B/C/D/... from an A state: the
            # climate setup lives on the restored grid
            grid0 = ckpt.load_grid(args.i)
            es = eismint2.setup(args.eisII, Mx=grid0.Mx, Mz=grid0.Mz,
                                Lz=grid0.Lz, device=device)
            grid, cfg, surface = es.grid, es.config, es.surface
            state, t0 = ckpt.load_state(args.i, config=cfg, device=device)
        else:
            es = eismint2.setup(args.eisII, Mx=args.Mx or 61,
                                Mz=args.Mz or 61, device=device)
            grid, cfg, state, surface = es.grid, es.config, es.state, es.surface
    elif args.test and args.test.upper() in tuple("ADHL"):
        # pismv-style single-test runs with an error report (runner.py)
        from .verification import runner
        over = Config({})
        _apply_config_overrides(over, args.config or [])
        runner.run_test(args.test, Mx=args.Mx, My=args.My, Mz=args.Mz,
                        years=args.y, config=over.non_default() or None,
                        device=device)
        return 0
    elif args.test:
        from .coupler.surface import FunctionSurface
        from .verification import halfar
        sol = halfar.test_B() if args.test.upper() == "B" else halfar.test_C()
        Mx = args.Mx or 61
        grid = Grid(Mx=Mx, My=args.My or Mx, Lx=900e3, Ly=900e3)
        cfg = Config({
            "stress_balance.model": "sia",
            "stress_balance.sia.flow_law": "isothermal_glen",
            "flow_law.isothermal_Glen.ice_softness": halfar.A_SOFTNESS,
            "energy.model": "none"})
        t0 = sol.t0
        H0 = torch.as_tensor(sol.thickness(t0, grid.radius),
                             dtype=torch.float64, device=device)
        state = ModelState(geometry=new_geometry(H0, torch.zeros_like(H0)))
        lam = sol.lam

        def smb(geometry, t):
            # lam / t is a host float, so the SMB keeps the field dtype
            H = geometry.ice_thickness
            return lam / t * H, torch.full_like(H, 263.15)

        surface = FunctionSurface(smb)
    elif args.i and args.bootstrap:
        from .coupler.surface import Uniform
        from .io.bootstrap import bootstrap
        cfg = Config()
        # the grid's parameters must be set before it is built (the
        # overrides are applied again later with everything else)
        _apply_config_overrides(cfg, args.config)
        grid = Grid(Mx=args.Mx or cfg.get_int("grid.Mx"),
                    My=args.My or cfg.get_int("grid.My"),
                    Lx=args.Lx * 1e3 if args.Lx else cfg.get_number("grid.Lx"),
                    Ly=args.Ly * 1e3 if args.Ly else cfg.get_number("grid.Ly"),
                    Mz=args.Mz or cfg.get_int("grid.Mz"),
                    Lz=args.Lz or cfg.get_number("grid.Lz"),
                    registration=cfg.get_string("grid.registration"))
        state = bootstrap(args.i, grid, cfg, device=device)
        surface = Uniform(smb=0.0)
    elif args.i:
        from .coupler.surface import Uniform
        grid = ckpt.load_grid(args.i)
        cfg = ckpt.load_config(args.i)
        state, t0 = ckpt.load_state(args.i, config=cfg, device=device)
        surface = Uniform(smb=0.0)  # continuation runs should supply forcing
    else:
        print("error: need one of -i, -eisII, -test", file=sys.stderr)
        return 1

    if args.regrid_file:
        state = _regrid(args, grid, state)
    _configure(args, cfg)

    # the coupler flags; restarts rebuild the chains stored in the config
    surf, ocean, sea_level = _couplers(args, cfg, grid, device)
    surface = surf if surf is not None else surface
    if cfg.get_int("grid.Nx") or cfg.get_int("grid.Ny"):
        raise _unported("a device mesh (grid.Nx / grid.Ny)", "4")

    # -ys/-ye/-y fall back to time.{start,end,run_length}
    yl = SEC_PER_YEAR
    ys_cfg = cfg.get_number("time.start", "years")
    ye_cfg = cfg.get_number("time.end", "years")
    ys = args.ys * yl if args.ys is not None else (
        ys_cfg * yl if cfg.is_set("time.start") else t0)
    if args.ye is not None:
        ye = args.ye * yl
    elif args.y is not None:
        ye = ys + args.y * yl
    elif cfg.is_set("time.end") and ye_cfg > ys_cfg:
        ye = ye_cfg * yl
    elif cfg.is_set("time.run_length"):
        ye = ys + cfg.get_number("time.run_length", "years") * yl
    else:
        ye = ys
    run_time = Time(start=ys, end=ye,
                    calendar=Calendar(cfg.get_string("time.calendar")),
                    reference_date=cfg.get_string("time.reference_date"))

    model = IceModel(grid=grid, config=cfg, surface=surface, ocean=ocean,
                     sea_level=sea_level, device=device)
    # the fields take the configured dtype (the EISMINT II and Halfar
    # states are built in float64 before -config is read)
    fdt = torch.float32 if cfg.get_string("runtime.float_dtype") == "float32" \
        else torch.float64
    state = map_tensors(state, lambda x: x.to(device=device, dtype=fdt)
                        if x.is_floating_point() else x.to(device))

    if not cfg.get_flag("stress_balance.ssa.read_initial_guess") \
            and (state.u_ssa is not None or state.v_ssa is not None):
        # cold-start the SSA instead of warm-starting from the input file
        state = state.replace(u_ssa=None, v_ssa=None)
    if cfg.get_flag("stress_balance.ssa.dirichlet_bc") and args.i:
        _dirichlet_bc(args, grid, model, device, fdt)

    # output flags fall back to their config parameters; the CLI values
    # mirror back in for provenance
    extra_file = args.extra_file or cfg.get_string("output.extra.file") or None
    extra_times_s = args.extra_times or cfg.get_string("output.extra.times")
    extra_vars_s = args.extra_vars or cfg.get_string("output.extra.vars") \
        or "thk,usurf,velbar_mag,mask"
    ts_file = args.ts_file or cfg.get_string("output.timeseries.filename") \
        or None
    ts_times_s = args.ts_times or cfg.get_string("output.timeseries.times")
    save_file = args.save_file or cfg.get_string("output.snapshot.file") \
        or None
    save_times_s = args.save_times or cfg.get_string("output.snapshot.times")
    backup_h = args.backup_interval \
        or cfg.get_number("output.backup_interval", "hours") \
        or cfg.get_number("output.checkpoint.interval", "hours")
    cfg.update({
        "output.extra.file": extra_file or "",
        "output.extra.times": extra_times_s or "",
        "output.extra.vars": extra_vars_s,
        "output.timeseries.filename": ts_file or "",
        "output.timeseries.times": ts_times_s or "",
        "output.snapshot.file": save_file or "",
        "output.snapshot.times": save_times_s or "",
        "output.backup_interval": backup_h,
    })
    if cfg.get_string("output.runtime.viewer.variables"):
        raise _unported("output.runtime.viewer.variables (-view)", "4")

    def times(spec):
        return parse_times(spec, yl, ys / yl, ye / yl) if spec else ()

    out = OutputManager(
        grid=grid, config=cfg,
        extra_times=times(extra_times_s),
        extra_vars=tuple(extra_vars_s.split(",")), extra_file=extra_file,
        ts_times=times(ts_times_s),
        ts_vars=tuple(cfg.get_string("output.timeseries.variables").split(",")),
        ts_file=ts_file,
        snapshot_times=times(save_times_s),
        snapshot_file=save_file or "snapshots_{kyr:.3f}.nc",
        backup_interval=backup_h * 3600.0,
        async_io=cfg.get_flag("output.async"),
        format=args.o_format)

    wall0 = _wall.time()
    t_reached = run_time.start
    vscale = 10.0 ** cfg.get_number("output.runtime.volume_scale_factor_log10")
    ascale = 10.0 ** cfg.get_number("output.runtime.area_scale_factor_log10")
    tunit = cfg.get_string("output.runtime.time_unit_name") or "a"
    tcal = cfg.get_flag("output.runtime.time_use_calendar")
    h_std = cfg.get_number("output.ice_free_thickness_standard")

    def report(state_, t, stats):
        nonlocal t_reached
        t_reached = t
        if log.verbosity >= 2:
            H = state_.geometry.ice_thickness
            vol, area = torch.stack([
                torch.sum(H).to(torch.float64),
                torch.sum((H > h_std).to(torch.float32)).to(torch.float64)
            ]).tolist()
            vol *= grid.dx * grid.dy / 1e9 / vscale
            area *= grid.dx * grid.dy / 1e6 / ascale
            tstamp = run_time.date_string(t) if tcal \
                else f"{t / yl:12.2f} {tunit}"
            log.message(
                2, "t = %s   steps = %7d   volume = %14.1f km3   "
                "area = %12.1f km2   wall = %7.1f s",
                tstamp, int(stats.nsteps), vol, area, _wall.time() - wall0)

    from .util.signals import SignalMonitor
    prof = contextlib.nullcontext()
    if args.profile:
        from .util.profiling import trace
        prof = trace(args.profile)
    try:
        with SignalMonitor() as sigs, prof:
            state, stats = model.run(state, run_time, output=out,
                                     callback=report, signals=sigs)
    finally:
        out.close()
    if cfg.get_flag("time_stepping.count_time_steps") and stats is not None:
        log.message(1, "count_time_steps: %d adaptive steps (binding "
                    "limits: %s)", int(stats.nsteps),
                    stats.limit_hits_dict())
    # -o_size medium: the diagnostics go into the state file in the same
    # pass (a classic file cannot be appended to)
    diagnostics = None
    if args.o_size == "big":
        raise _unported("-o_size big (the 3D diagnostics)", "3")
    if args.o_size == "medium":
        names = cfg.get_string("output.sizes.medium").split()
        diagnostics = ckpt.diagnostic_values(names, state, model, t_reached)
    ckpt.save_state(args.o, state, grid, t_reached, config=cfg,
                    format=args.o_format, diagnostics=diagnostics)
    cfg.update({"output.size": args.o_size, "output.format": args.o_format})
    if sol is not None:
        halfar_report(sol, state, grid, t_reached)
    log.message(1, "done; state written to %s", args.o)
    return 0


if __name__ == "__main__":
    sys.exit(main())
