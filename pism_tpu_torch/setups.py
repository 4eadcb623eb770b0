"""Model setups.

``hybrid_greenland_model`` is the synthetic-Greenland hybrid chain that
``bench.py`` measures (``bench.py:151-193``), reproduced number for number:
extents, grid, config, geometry, latitude/longitude/precipitation, and the
float64 -> float32 cast after ``prepare_state``. ``eismint2_model`` is
``bench.py``'s second chain, EISMINT II experiment A (``bench.py:95-103``).
``halfar_model`` is the isothermal verification chain, Halfar tests B and
C, with ``halfar_report`` its error report.

Each takes ``mesh``, a ``parallel.mesh.Mesh`` (e.g.
``make_mesh(["cuda:0"] * 4, (2, 2))``), which decomposes the model's kernel
routes. ``hybrid_greenland_model`` then rounds My and Mx up to mesh
multiples as ``bench.py:154-157`` does (a row or column of extra ocean at
the domain edge); the SIA-only setups keep their grid, since the sharded
SIA kernels pad internally.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import Config
from .coupler.atmosphere import SeariseGreenland
from .coupler.ocean import Constant as OceanConstant
from .coupler.pdd import TemperatureIndex
from .grid import Grid
from .model.icemodel import IceModel
from .state import ModelState, map_tensors, new_geometry

SPY = 3.15569259747e7


def to_dtype(state: ModelState, dtype) -> ModelState:
    """Cast every float64 field of the state to ``dtype``."""
    return map_tensors(state, lambda x: x.to(dtype)
                       if x.dtype == torch.float64 else x)


def hybrid_greenland_model(dtype: str, km: float = 20.0, device="cuda",
                           extra_cfg=None, mesh=None):
    """The north-star chain: returns (model, initial state, grid).

    ``dtype``: "float32" or "float64" field precision; ``device``: the torch
    device every field lives on; ``mesh``: see the module's docstring."""
    device = torch.device(device)
    Lx, Ly = 750e3, 1400e3
    Mx = int(2 * Lx / (km * 1e3)) + 1
    My = int(2 * Ly / (km * 1e3)) + 1
    if mesh is not None:
        ny, nx = mesh.shape["y"], mesh.shape["x"]
        My += (-My) % ny
        Mx += (-Mx) % nx
    grid = Grid(Mx=Mx, My=My, Lx=Lx, Ly=Ly, Mz=41, Lz=4000.0)
    cfg = Config({
        "stress_balance.model": "ssa+sia",
        "energy.model": "enthalpy",
        "basal_resistance.pseudo_plastic.enabled": True,
        "basal_resistance.pseudo_plastic.q": 0.25,
        "basal_yield_stress.model": "mohr_coulomb",
        "calving.methods": "thickness_calving",
        "geometry.remove_icebergs": True,
        "geometry.part_grid.enabled": True,
        "time_stepping.skip.enabled": True,
        "time_stepping.skip.max": 10,
        "runtime.float_dtype": dtype,
        "runtime.device_loop": True,
    })
    if extra_cfg:
        cfg.update(extra_cfg)

    X, Y = np.meshgrid(grid.x, grid.y)
    r2 = (X / (0.55 * Lx)) ** 2 + (Y / (0.8 * Ly)) ** 2
    bed = 400.0 - 900.0 * r2 + 150.0 * np.sin(X / 120e3) * np.cos(Y / 160e3)
    H = 2800.0 * np.maximum(1.0 - r2, 0.0) ** 1.5 * (bed > -600)
    lat = 60.0 + (Y + Ly) / (2 * Ly) * 23.0
    lon = -42.0 + X / Lx * 10.0
    precip = np.clip(0.6 - 0.25 * (lat - 60.0) / 23.0, 0.05, None) / SPY

    def t64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    atm = SeariseGreenland(latitude=t64(lat), longitude=t64(lon),
                           precipitation=t64(precip))
    surface = TemperatureIndex(atmosphere=atm, config=cfg)
    model = IceModel(grid=grid, config=cfg, surface=surface,
                     ocean=OceanConstant(config=cfg), device=device, mesh=mesh)
    state = model.prepare_state(ModelState(geometry=new_geometry(
        t64(H), t64(bed))))
    if dtype == "float32":
        state = to_dtype(state, torch.float32)
    return model, state, grid


#: EISMINT II's bed is flat, so the bed smoother's theta is exactly 1 and
#: switching it off is the same physics; without theta the SIA kernel K3
#: takes the flux (the JAX package's default 5 km range declines it)
EISMINT2_CFG = {"stress_balance.sia.bed_smoother.range": 0.0}


def eismint2_model(dtype: str, Mx: int = 61, Mz: int = 61, device="cuda",
                   extra_cfg=None, mesh=None):
    """EISMINT II experiment A from zero ice: returns (model, initial
    state, grid). The config is the JAX setup's plus ``EISMINT2_CFG`` and
    ``extra_cfg``; ``dtype`` is "float32" or "float64"."""
    from .verification import eismint2

    es = eismint2.setup("A", Mx=Mx, Mz=Mz, Lz=5000.0,
                        dtype=getattr(torch, dtype), device=device)
    es.config.update({"runtime.float_dtype": dtype, **EISMINT2_CFG,
                      **(extra_cfg or {})})
    model = IceModel(grid=es.grid, config=es.config, surface=es.surface,
                     device=device, mesh=mesh)
    return model, es.state, es.grid


#: The Halfar dome's bed is flat, so the bed smoother's theta is exactly 1
#: and switching it off is the same physics; without theta the isothermal
#: SIA kernel K4 takes the flux (the default 5 km range declines it)
HALFAR_CFG = {"stress_balance.sia.bed_smoother.range": 0.0}


def halfar_model(test: str = "B", Mx: int = 61, dtype: str = "float64",
                 device="cuda", extra_cfg=None, t_start=None, mesh=None):
    """Halfar similarity test B (zero accumulation) or C (M = 5 H / t) on
    an Mx x Mx grid over the 1800 km square, from the exact dome at
    ``t_start`` (seconds; default the solution's t0): the CLI's
    ``-test B/C`` setup (``pism_tpu/cli.py:454-478``) with
    ``tests/test_halfar.py``'s Mahaffy gradients and ``HALFAR_CFG``.
    Returns (model, initial state, grid, solution). ``dtype`` is "float32"
    or "float64"."""
    from .coupler.surface import FunctionSurface
    from .verification import halfar

    name = test.upper()
    if name not in ("B", "C"):
        raise NotImplementedError(f"Halfar test {test!r} (supported: B, C)")
    sol = halfar.test_B() if name == "B" else halfar.test_C()
    device = torch.device(device)
    grid = Grid(Mx=Mx, My=Mx, Lx=900e3, Ly=900e3)
    cfg = Config({
        "stress_balance.model": "sia",
        "stress_balance.sia.flow_law": "isothermal_glen",
        "flow_law.isothermal_Glen.ice_softness": halfar.A_SOFTNESS,
        "stress_balance.sia.surface_gradient_method": "mahaffy",
        "energy.model": "none",
        "runtime.float_dtype": dtype,
        **HALFAR_CFG,
    })
    if extra_cfg:
        cfg.update(extra_cfg)
    lam = sol.lam

    def smb(geometry, t):
        H = geometry.ice_thickness
        return lam / t * H, torch.full_like(H, 263.15)

    model = IceModel(grid=grid, config=cfg, surface=FunctionSurface(smb),
                     device=device, mesh=mesh)
    t_start = sol.t0 if t_start is None else t_start
    H0 = torch.as_tensor(sol.thickness(t_start, grid.radius),
                         dtype=torch.float64, device=device)
    state = model.prepare_state(ModelState(geometry=new_geometry(
        H0, torch.zeros_like(H0))))
    if dtype == "float32":
        state = to_dtype(state, torch.float32)
    return model, state, grid, sol


def halfar_report(sol, state: ModelState, grid, t: float) -> dict:
    """The CLI's error report of a Halfar run (``pism_tpu/cli.py:973-982``):
    prints the pismv-style table at model time ``t`` and returns
    ``halfar.error_norms`` against the exact thickness."""
    from .verification import halfar
    from .verification.runner import _report

    He = sol.thickness(t, grid.radius)
    e = halfar.error_norms(
        state.geometry.ice_thickness.double().cpu().numpy(), He)
    test = "B" if sol.lam == 0.0 else "C"
    _report(f"test {test} (Halfar, t = {t / SPY:.0f} a)",
            [("geometry", {"prcnt_volume": 100.0 * e["rel_volume"],
                           "max_H": e["max_H"], "avg_H": e["avg_H"],
                           "dome_H": e["dome_H"]})])
    return e
