"""Model setups.

``hybrid_greenland_model`` is the synthetic-Greenland hybrid chain that
``bench.py`` measures (``bench.py:151-193``), reproduced number for number:
extents, grid, config, geometry, latitude/longitude/precipitation, and the
float64 -> float32 cast after ``prepare_state``; its ``hydrology`` and
``frontal_melt`` options add PISM's ``-hydrology`` choice and the
discharge-routing frontal melt to that chain. ``eismint2_model`` is
``bench.py``'s second chain, EISMINT II experiment A (``bench.py:95-103``).
``halfar_model`` is the isothermal verification chain, Halfar tests B and
C, with ``halfar_report`` its error report. ``antarctica_pik_model`` is
the PISM-PIK Antarctic chain of ``examples/antarctica_pik.py:61-117``
(BASELINE config 4): PICO, eigen and thickness calving, Lingle-Clark and
the PIK surface on a synthetic marine ice sheet. ``mismip3d_model`` is
MISMIP3d's Stnd experiment of ``examples/mismip3d.py:59-146`` (BASELINE
config 2) and ``mismip_model`` MISMIP experiment 1 of
``verification/mismip.py`` on its periodic grid: the isothermal SSA+SIA
with no energy model and a given or constant yield stress.
``paleo_ensemble_model`` is the paleo parameter ensemble of
``examples/paleo_ensemble.py`` (BASELINE config 5): thermo-coupled SIA
members that differ in a temperature offset, stacked on a member axis for
``parallel.ensemble.EnsembleRunner``; ``hybrid_ensemble_model`` the hybrid
chain's ensemble, members that differ in their till friction angle;
``antarctica_pik_ensemble_model`` the PISM-PIK chain's ensemble of BASELINE
config 5's name, members that differ in PICO's ocean temperature.

Each takes ``mesh``, a ``parallel.mesh.Mesh`` (e.g.
``make_mesh(["cuda:0"] * 4, (2, 2))``), which decomposes the model's kernel
routes. ``hybrid_greenland_model`` then rounds My and Mx up to mesh
multiples as ``bench.py:154-157`` does (a row or column of extra ocean at
the domain edge); the SIA-only setups keep their grid, since the sharded
SIA kernels pad internally.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import Config
from .coupler.atmosphere import SeariseGreenland
from .coupler.ocean import Constant as OceanConstant
from .coupler.pdd import TemperatureIndex
from .grid import Grid
from .model.icemodel import IceModel
from .state import ModelState, grounded_ice, map_tensors, new_geometry

SPY = 3.15569259747e7


#: the column tracers on the hybrid chain (``hybrid_greenland_model``'s
#: ``extra_cfg``): the age with its age-coupled SIA enhancement (the ice
#: of the initial state dated 15 ka, glacial, e_sia = 1; new ice Holocene,
#: e = 3), isochrones deposited every 0.25 a, cryo-hydrologic warming,
#: k(T) and the upstream vertical velocity
TRACER_CFG = {
    "age.enabled": True,
    "age.initial_value": 15000.0,
    "stress_balance.sia.e_age_coupling": True,
    "stress_balance.sia.enhancement_factor_interglacial": 3.0,
    "age.isochrones.enabled": True,
    "age.isochrones.deposition_times": "0.25:0.25:10",
    "energy.ch_warming.enabled": True,
    "energy.temperature_dependent_conductivity": True,
    "stress_balance.vertical_velocity_approximation": "upstream",
}

#: the fracture density with the SSA's softening on the PISM-PIK chain
#: (``antarctica_pik_model``'s ``extra_cfg``; add
#: ``fracture_density.fd2d_scheme``, on by default, to pick the transport)
FRACTURE_CFG = {
    "fracture_density.enabled": True,
    "fracture_density.softening_lower_limit": 0.5,
}


def to_dtype(state: ModelState, dtype) -> ModelState:
    """Cast every float64 field of the state to ``dtype``."""
    return map_tensors(state, lambda x: x.to(dtype)
                       if x.dtype == torch.float64 else x)


def hybrid_greenland_model(dtype: str, km: float = 20.0, device="cuda",
                           extra_cfg=None, mesh=None, hydrology=None,
                           frontal_melt=None):
    """The north-star chain: returns (model, initial state, grid).

    ``dtype``: "float32" or "float64" field precision; ``device``: the torch
    device every field lives on; ``mesh``: see the module's docstring.
    ``hydrology``: PISM's ``-hydrology`` choice (``routing``,
    ``distributed`` or ``steady``; None keeps the null model), fed by the
    PDD's runoff (``surface_input_from_runoff``), from a till saturated
    under the grounded ice (as a spun-up till is where water reaches the
    bed; an empty till would hold all the water of the first years), with
    the routed water weakening the till (``add_transportable_water``);
    ``frontal_melt="routing"``: the discharge-routing frontal melt on a
    synthetic thermal forcing, 1-4 K, warmer to the south."""
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
    if hydrology is not None:
        cfg.update({"hydrology.model": hydrology,
                    "hydrology.surface_input_from_runoff": True,
                    "basal_yield_stress.add_transportable_water": True})
    if frontal_melt is not None:
        cfg.update({"frontal_melt.models": frontal_melt})
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
    fm = None
    if frontal_melt is not None:
        from .coupler.frontalmelt import frontal_melt_from_config
        theta = 1.0 + 3.0 * (83.0 - lat) / 23.0
        fm = frontal_melt_from_config(cfg, grid,
                                      inputs={"theta_ocean": t64(theta)})
    model = IceModel(grid=grid, config=cfg, surface=surface,
                     ocean=OceanConstant(config=cfg), device=device, mesh=mesh,
                     frontal_melt=fm)
    geometry = new_geometry(t64(H), t64(bed))
    tillwat = None
    if hydrology is not None:
        tillwat = torch.where(grounded_ice(geometry.cell_type),
                              cfg.get_number("hydrology.tillwat_max"), 0.0
                              ).to(torch.float64)
    state = model.prepare_state(ModelState(geometry=geometry, tillwat=tillwat))
    if dtype == "float32":
        state = to_dtype(state, torch.float32)
    return model, state, grid


#: The hybrid ensemble's members' till friction angles span [15, 40] degrees
TILL_PHI_RANGE = (15.0, 40.0)


def hybrid_ensemble_model(members: int, km: float = 20.0,
                          dtype: str = "float32", device="cuda",
                          extra_cfg=None):
    """An ensemble of the hybrid chain (``hybrid_greenland_model``: SSA+SIA,
    enthalpy, SeaRISE air and the PDD, the constant ocean, thickness
    calving and iceberg removal, part-grid, pseudo-plastic Mohr-Coulomb
    sliding, skip 10) whose members differ only in their till friction
    angle: member b's ``till_phi`` is phi_b everywhere, the phi_b evenly
    spaced over ``TILL_PHI_RANGE``. The JAX package's Mohr-Coulomb reads the
    same field (``pism_tpu/state.py:187``). Returns (model, batched state,
    grid, phi (numpy)); ``EnsembleRunner(model)`` runs it."""
    from .parallel.ensemble import broadcast_state

    model, state, grid = hybrid_greenland_model(dtype, km, device=device,
                                                extra_cfg=extra_cfg)
    phi = np.linspace(*TILL_PHI_RANGE, members)
    batched = broadcast_state(state, members)
    field = torch.tensor(phi, dtype=getattr(torch, dtype),
                         device=torch.device(device))
    return (model, batched.replace(till_phi=field[:, None, None].expand(
        members, *grid.shape2).contiguous()), grid, phi)


#: The bed of EISMINT II A-H is flat, so the bed smoother's theta is exactly
#: 1 and switching it off is the same physics; without theta the SIA kernel
#: K3 takes the flux (the JAX package's default 5 km range declines it).
#: Not for I-L, whose beds make theta differ from 1.
EISMINT2_CFG = {"stress_balance.sia.bed_smoother.range": 0.0}


def eismint2_model(dtype: str, Mx: int = 61, Mz: int = 61, device="cuda",
                   extra_cfg=None, mesh=None, experiment: str = "A"):
    """An EISMINT II experiment from zero ice (B-E restart from A's state:
    pass that state to the model instead): returns (model, initial state,
    grid). The config is the JAX setup's plus ``extra_cfg``, and on the
    flat beds (A-H) ``EISMINT2_CFG``. I-L keep the JAX setup's 5 km bed
    smoother: their beds make theta differ from 1, so the SIA takes the
    plain route there, as in the JAX package. ``dtype`` is "float32" or
    "float64"."""
    from .verification import eismint2

    es = eismint2.setup(experiment, Mx=Mx, Mz=Mz, Lz=5000.0,
                        dtype=getattr(torch, dtype), device=device)
    flat = "bed" not in eismint2.EXPERIMENTS[experiment.upper()]
    es.config.update({"runtime.float_dtype": dtype,
                      **(EISMINT2_CFG if flat else {}), **(extra_cfg or {})})
    model = IceModel(grid=es.grid, config=es.config, surface=es.surface,
                     device=device, mesh=mesh, sliding_mu=es.sliding_mu)
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


def halfar_ensemble_model(members: int = 8, Mx: int = 61,
                          dtype: str = "float64", device="cuda",
                          extra_cfg=None):
    """An ensemble of Halfar test B domes (the JAX package's
    ``tests/test_ensemble.py``): members with SMB scales 0, 1, 2, ... of
    0.3 m/a, the member's scale riding in on ``ice_area_specific_volume``,
    on ``halfar_model``'s grid and config (Mahaffy gradients, ``HALFAR_CFG``:
    the isothermal kernel K4's route in float32). Returns (model, batched
    state, grid, solution, scales (numpy))."""
    from .coupler.surface import FunctionSurface
    from .parallel.ensemble import broadcast_state

    model, state, grid, sol = halfar_model("B", Mx, dtype, device=device,
                                           extra_cfg=extra_cfg)

    def smb(geometry, t):
        scale = geometry.ice_area_specific_volume[0, 0]
        H = geometry.ice_thickness
        return scale * 0.3 / SPY * torch.ones_like(H), torch.full_like(H, 253.15)

    model = dataclasses.replace(model, surface=FunctionSurface(smb))
    scales = np.arange(members, dtype=np.float64)
    batched = broadcast_state(state, members)
    Href = torch.tensor(scales, dtype=getattr(torch, dtype),
                        device=torch.device(device))
    batched = batched.replace(geometry=batched.geometry.replace(
        ice_area_specific_volume=Href[:, None, None].expand(
            members, *grid.shape2).contiguous()))
    return model, batched, grid, sol, scales


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


def antarctic_geometry(grid):
    """The JAX example's synthetic Antarctica on ``grid`` (numpy float64):
    (thickness, bed, latitude). A marine ice sheet on an overdeepened bed
    with two embayments (Ross and Weddell analogs) that grow shelves."""
    X, Y = np.meshgrid(grid.x, grid.y)
    r = np.sqrt(X ** 2 + Y ** 2)
    theta = np.arctan2(Y, X)
    # continent: bed above sea level inside ~1300 km, marine margins
    bed = 900.0 - 1500.0 * (r / 1500e3) ** 2 \
        + 120.0 * np.sin(X / 180e3) * np.sin(Y / 230e3)
    for ang, width in ((-1.6, 0.5), (2.4, 0.6)):
        emb = np.exp(-((theta - ang) / width) ** 2) * (r / 1800e3).clip(0, 1)
        bed = bed - 1100.0 * emb
    H = np.where(r < 1500e3,
                 3300.0 * np.maximum(1.0 - r / 1700e3, 0.0) ** 0.8, 0.0)
    H = np.where(bed < -1400.0, 0.0, H)         # no seed ice in deep ocean
    lat = -90.0 + r / 111.2e3                    # degrees south
    return H, bed, lat


#: the JAX example's config (``examples/antarctica_pik.py:67-85``)
ANTARCTICA_PIK_CFG = {
    "stress_balance.model": "ssa+sia",
    "energy.model": "enthalpy",
    "basal_resistance.pseudo_plastic.enabled": True,
    "basal_resistance.pseudo_plastic.q": 0.75,
    "basal_yield_stress.model": "mohr_coulomb",
    "hydrology.model": "null",
    "calving.methods": "eigen_calving,thickness_calving",
    "calving.eigen_calving.K": 1.0e17,
    "calving.thickness_calving.threshold": 150.0,
    "geometry.remove_icebergs": True,
    "geometry.part_grid.enabled": True,
    "geometry.grounded_cell_fraction": True,
    "bed_deformation.model": "lc",
    "time_stepping.skip.enabled": True,
    "time_stepping.skip.max": 10,
    "runtime.device_loop": True,
}


def antarctica_pik_model(dtype: str, km: float = 16.0, device="cuda",
                         extra_cfg=None, Mz: int = 31):
    """The PISM-PIK Antarctic chain of ``examples/antarctica_pik.py``: a
    4,000 x 4,000 km domain at ``km`` spacing (251 x 251 x 31 at 16 km),
    the hybrid SSA+SIA stress balance, enthalpy, pseudo-plastic
    Mohr-Coulomb sliding, PICO, eigen and thickness calving with iceberg
    removal, part-grid, the sub-grid grounding line, Lingle-Clark, and the
    PIK surface on a uniform atmosphere. Returns (model, initial state,
    grid); ``dtype`` is "float32" or "float64" (the state is prepared in
    float64 and cast, as the example does)."""
    from .coupler.atmosphere import Uniform as AtmUniform
    from .coupler.pico import Pico
    from .coupler.surface import PIK as SurfacePIK

    device = torch.device(device)
    dx = km * 1e3
    L = 2000e3                       # half-width: 4000 x 4000 km domain
    Mx = int(2 * L / dx) + 1
    grid = Grid(Mx=Mx, My=Mx, Lx=L, Ly=L, Mz=Mz, Lz=5000.0)
    cfg = Config(dict(ANTARCTICA_PIK_CFG, **{"runtime.float_dtype": dtype}))
    if extra_cfg:
        cfg.update(extra_cfg)
    H, bed, lat = antarctic_geometry(grid)

    def t64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    surface = SurfacePIK(
        atmosphere=AtmUniform(temperature=248.0, precipitation=0.25 / SPY),
        latitude=t64(lat))
    ocean = Pico(temperature_ocean=torch.full(grid.shape2, 271.45,
                                              dtype=torch.float64,
                                              device=device),
                 salinity_ocean=torch.full(grid.shape2, 34.65,
                                           dtype=torch.float64, device=device),
                 config=cfg, grid=grid)
    model = IceModel(grid=grid, config=cfg, surface=surface, ocean=ocean,
                     device=device)
    state = model.prepare_state(ModelState(geometry=new_geometry(
        t64(H), t64(bed))))
    if dtype == "float32":
        state = to_dtype(state, torch.float32)
    return model, state, grid


def _prepared(model, state, dtype):
    """``model.prepare_state`` in float64, then the cast to ``dtype``."""
    state = model.prepare_state(state)
    if dtype == "float32":
        state = to_dtype(state, torch.float32)
    return state


def mismip3d_model(dtype: str, km: float = 1.0, device="cuda",
                   extra_cfg=None):
    """MISMIP3d's Stnd experiment (``verification/mismip.py``
    ``setup_3d``): the [-800, 800] x [-50, 50] km channel at ``km``
    spacing (1601 x 101 at 1 km) from the near-steady Vialov profile, with
    the uniform friction ``TAU_C0`` through ``GivenYieldStress``. Returns
    (model, initial state, grid); ``dtype`` is "float32" or "float64".
    P75S and P75R swap the yield stress:
    ``dataclasses.replace(model, yield_stress=...)``."""
    from .physics.basal import GivenYieldStress
    from .verification import mismip

    ms = mismip.setup_3d(km * 1e3, float32=dtype == "float32", device=device)
    if extra_cfg:
        ms.config.update(extra_cfg)
    model = IceModel(grid=ms.grid, config=ms.config, surface=ms.surface,
                     calving=ms.calving,
                     yield_stress=GivenYieldStress(
                         ms.config,
                         tau_c=np.full(ms.grid.shape2, mismip.TAU_C0)),
                     device=device)
    return model, _prepared(model, ms.state, dtype), ms.grid


def mismip_model(dtype: str, Mx: int = 151, My: int = 7, device="cuda",
                 extra_cfg=None):
    """MISMIP experiment 1 (``verification/mismip.py``) on its periodic-y
    grid of Mx x My cells over [-1500, 1500] km: returns (model, initial
    state, grid); ``dtype`` is "float32" or "float64"; ``extra_cfg``
    overrides the setup's config (say, another ``stress_balance.model``)."""
    from .verification import mismip

    ms = mismip.setup(Mx=Mx, My=My, device=device)
    ms.config.update({"runtime.float_dtype": dtype, **(extra_cfg or {})})
    model = IceModel(grid=ms.grid, config=ms.config, surface=ms.surface,
                     calving=ms.calving, device=device)
    return model, _prepared(model, ms.state, dtype), ms.grid


#: The paleo ensemble's members' temperature offsets span [-8, 4] K
#: (``examples/paleo_ensemble.py:73``)
PALEO_DT_RANGE = (-8.0, 4.0)


def paleo_smb(geometry, t):
    """The paleo ensemble's climate of one member
    (``examples/paleo_ensemble.py:75-84``): the member's offset dT rides in
    on ``ice_area_specific_volume`` (unused by the SIA chains); a lapse-rate
    temperature, precipitation scaled by exp(0.07 dT), and warming
    ablation. Returns (smb [m/s], ice surface temperature [K])."""
    dT = geometry.ice_area_specific_volume[0, 0]   # the member's parameter
    h = geometry.ice_surface_elevation
    T = 248.0 - 6.0e-3 * h + dT
    precip = 0.35 / SPY * torch.exp(0.07 * dT)
    # crude height-desert + warming ablation
    melt = 1.0e-9 * torch.clamp(T - 263.15, min=0.0)
    smb = precip - melt
    return (torch.broadcast_to(smb, h.shape),
            torch.broadcast_to(torch.clamp(T, max=273.15), h.shape))


def paleo_ensemble_model(members: int = 16, km: float = 40.0, dtype=None,
                         device="cuda", extra_cfg=None, Mz: int = 21):
    """The paleo ensemble of ``examples/paleo_ensemble.py:56-105``, number
    for number: the 1600 km square at ``km`` spacing (41 x 41 x 21 at 40
    km, Lz 4 km), SIA with enthalpy, a parabolic dome on a bowl-shaped bed,
    ``FunctionSurface(paleo_smb)``, and ``members`` offsets dT evenly over
    ``PALEO_DT_RANGE``. The initial state is prepared in float64 (its
    enthalpy from dT = 0), cast to ``dtype`` (default: float32 on the card,
    float64 on the CPU, as the example chooses), replicated per member,
    and each member's dT written into its ``ice_area_specific_volume``.
    ``Mz`` cuts the column for small test grids. Returns (model, batched
    state, grid, dT (numpy))."""
    from .coupler.surface import FunctionSurface
    from .parallel.ensemble import broadcast_state

    device = torch.device(device)
    if dtype is None:
        dtype = "float64" if device.type == "cpu" else "float32"
    dx = km * 1e3
    L = 800e3
    Mx = int(2 * L / dx) + 1
    grid = Grid(Mx=Mx, My=Mx, Lx=L, Ly=L, Mz=Mz, Lz=4000.0)
    cfg = Config({
        "stress_balance.model": "sia",
        "energy.model": "enthalpy",
        "runtime.float_dtype": dtype,
    })
    if extra_cfg:
        cfg.update(extra_cfg)
    X, Y = np.meshgrid(grid.x, grid.y)
    r = np.sqrt(X ** 2 + Y ** 2)
    H0 = np.where(r < 500e3, 2500.0 * (1 - (r / 600e3) ** 2), 0.0).clip(0)
    bed = 100.0 - 300.0 * (r / 800e3) ** 2
    model = IceModel(grid=grid, config=cfg, surface=FunctionSurface(paleo_smb),
                     device=device)
    geom = new_geometry(torch.tensor(H0, device=device),
                        torch.tensor(bed, device=device))
    state = _prepared(model, ModelState(geometry=geom), dtype)
    dT = np.linspace(*PALEO_DT_RANGE, members)
    batched = broadcast_state(state, members)
    Href = torch.tensor(dT, dtype=getattr(torch, dtype), device=device)
    batched = batched.replace(geometry=batched.geometry.replace(
        ice_area_specific_volume=Href[:, None, None].expand(
            members, *grid.shape2).contiguous()))
    return model, batched, grid, dT


#: The Antarctic ensemble's members' ocean warming spans [0, 2] K: the JAX
#: hysteresis sweep's ocean forcing, 0.25 dT for dT in [0, 8] K
#: (``examples/hysteresis.py:98-101``)
PIK_THETA_RANGE = (0.0, 2.0)


def antarctica_pik_ensemble_model(members: int, km: float = 16.0,
                                  dtype: str = "float32", device="cuda",
                                  data=None, extra_cfg=None, Mz: int = 31):
    """An ensemble of the PISM-PIK chain as a user runs it from a data file
    (``examples/antarctica_pik.py``: ``synthesize_data_file``, the config
    the command line builds from ``bootstrap_argv`` with the bed updated
    every year, ``io.bootstrap.bootstrap`` and the couplers of
    ``couplers``; 251 x 251 x 31 at 16 km): SSA+SIA, enthalpy,
    pseudo-plastic Mohr-Coulomb sliding, PICO on two basins, eigen and
    thickness calving with iceberg removal, part-grid, the sub-grid
    grounding line, Lingle-Clark and the PIK surface. Member b's PICO
    ambient temperature is the file's theta_ocean + dT_b, dT_b evenly over
    ``PIK_THETA_RANGE`` (formed in float64, as the file of
    ``synthesize_data_file(..., theta_offset=dT_b)`` would be read), so
    member b is the run of that file. ``data``: the data file (default: one
    synthesized at ``km`` into a temporary directory); ``extra_cfg`` on
    top of the command line's config. Returns (model, batched state, grid,
    dT (numpy)); ``EnsembleRunner(model)`` runs it."""
    import os
    import tempfile

    from .cli import bootstrap_config
    from .examples.antarctica_pik import (bootstrap_argv, couplers,
                                          model_grid, synthesize_data_file)
    from .io.bootstrap import bootstrap, read_forcing_fields
    from .parallel.ensemble import broadcast_state

    device = torch.device(device)
    with tempfile.TemporaryDirectory() as d:
        if data is None:
            data = os.path.join(d, "ant.nc")
            synthesize_data_file(data, km, "netcdf3")
        cfg = bootstrap_config(bootstrap_argv(
            data, os.path.join(d, "unused.nc"), km, 0.0, "netcdf3", Mz=Mz,
            dtype=dtype,
            extra=("-config", "bed_deformation.update_interval=1")))
        if extra_cfg:
            cfg.update(extra_cfg)
        grid = model_grid(km, Mz)
        surface, ocean = couplers(cfg, grid, data, device)
        theta = read_forcing_fields(data, grid, ["theta_ocean"])[0][
            "theta_ocean"]
        dT = np.linspace(*PIK_THETA_RANGE, members)
        ocean = dataclasses.replace(ocean, member_temperature=torch.as_tensor(
            theta[None] + dT[:, None, None]).to(device=device,
                                                dtype=getattr(torch, dtype)))
        model = IceModel(grid=grid, config=cfg, surface=surface, ocean=ocean,
                         device=device)
        state = model.prepare_state(bootstrap(data, grid, cfg, device=device))
    return model, broadcast_state(state, members), grid, dT
