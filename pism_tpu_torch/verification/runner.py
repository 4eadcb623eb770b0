"""Verification runs by letter (port of ``pism_tpu/verification/runner.py``
for the SIA letters of PISM's ``pismv``): set up an exact-solution test by
letter, run it, and print a pismv-style numerical-error report.

Ported letters: A (steady cap, fixed margin), D (compensatory
oscillation), E (test A's cap with prescribed sliding in a sector), F
(thermo-coupled steady dome, the manufactured-solution analog), G (test F
plus a time-periodic wobble), H (moving margin with pointwise isostasy),
K (cold conduction column with the bedrock thermal layer), L (steady cap
on a non-flat bed), O (warm-based conduction column, exact basal melt
rate) and P (the routing hydrology against its radial steady state,
``hydrology_exact.py``). B and C, the Halfar similarity solutions, are
``setups.halfar_model`` (the CLI's ``-test B/C`` route); I, J, M, V and N
are ``ssa_tests.py``. The Blatter problems run as ``blatter_xz`` and
``blatter_xz_cfbc`` (``blatter_xz.py``), as the JAX package's runner takes
them. Every other letter raises ``NotImplementedError``.

Every run's fields are float64 on ``device`` (default ``"cuda"``; pass
``device="cpu"`` for a run on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

SPY = 3.15569259747e7

SUPPORTED = "ADEFGHKLOP"


def _report(title, rows):
    """Print a pismv-style error table: rows = [(group, {name: value})]."""
    print(f"NUMERICAL ERRORS in {title} evaluated at final time "
          "(relative to exact solution):")
    for group, vals in rows:
        names = "".join(f"{k:>16s}" for k in vals)
        nums = "".join(f"{v:16.6f}" for v in vals.values())
        print(f"{group:<10s}:{names}\n{'':<10s} {nums}")
    print("NUM ERRORS DONE")


def _geometry_errors(H_num, H_exact):
    from .halfar import error_norms
    e = error_norms(H_num, H_exact)
    return {
        "prcnt_volume": 100.0 * e["rel_volume"],
        "max_H": e["max_H"],
        "avg_H": e["avg_H"],
        "dome_H": e["dome_H"],
    }


def _isothermal_config(extra=None):
    from ..config import Config
    from . import halfar
    cfg = Config({
        "stress_balance.model": "sia",
        "stress_balance.sia.flow_law": "isothermal_glen",
        "flow_law.isothermal_Glen.ice_softness": halfar.A_SOFTNESS,
        "energy.model": "none",
    })
    if extra:
        cfg.update(extra)
    return cfg


def _ocean_kill(grid, cfg, L, device):
    from ..model.calving import CalvingModel
    cfg.update({"calving.methods": "ocean_kill"})
    return CalvingModel(grid=grid, config=cfg, ocean_kill_mask=torch.as_tensor(
        grid.radius > L, device=device))


def _run_sia(grid, cfg, state, surface, t0, years, calving=None,
             device="cuda", **model_kw):
    from ..model.icemodel import IceModel
    model = IceModel(grid=grid, config=cfg, surface=surface, calving=calving,
                     device=device, **model_kw)
    state, tf, stats = model.step_once(state, t0, years * SPY)
    return state, stats


def _f64(a, device):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=device)


def _constant_surface(M):
    from ..coupler.surface import FunctionSurface
    return FunctionSurface(
        lambda g, t: (M, torch.full_like(g.ice_thickness, 263.15)))


def _state(H, bed, device):
    from ..state import ModelState, new_geometry
    return ModelState(geometry=new_geometry(_f64(H, device), _f64(bed, device)))


def run_A(Mx=61, years=1000.0, config=None, device="cuda"):
    """Steady cap with fixed margin: hold the exact profile."""
    from ..grid import Grid
    from . import exact_steady as es

    cap = es.test_A()
    grid = Grid(Mx=Mx, My=Mx, Lx=900e3, Ly=900e3)
    cfg = _isothermal_config(config)
    He = cap.thickness(grid.radius)
    surface = _constant_surface(_f64(cap.accumulation(grid.radius), device))
    state = _state(He, np.zeros(grid.shape2), device)
    state, stats = _run_sia(grid, cfg, state, surface, 0.0, years,
                            calving=_ocean_kill(grid, cfg, cap.L, device),
                            device=device)
    errs = _geometry_errors(state.geometry.ice_thickness.cpu().numpy(), He)
    _report(f"test A (steady cap, {years:.0f} a, {Mx}x{Mx})",
            [("geometry", errs)])
    return errs


def run_E(Mx=61, years=1000.0, config=None, device="cuda"):
    """Test E: the steady test-A cap with prescribed basal sliding in an
    annular sector and compensatory accumulation (Bueler et al. 2005;
    ``pismv -test E`` prescribes the sliding velocity too)."""
    from ..grid import Grid
    from . import exact_steady as es

    sc = es.test_E()
    grid = Grid(Mx=Mx, My=Mx, Lx=900e3, Ly=900e3)
    cfg = _isothermal_config(config)
    cfg.update({"stress_balance.model": "prescribed_sliding+sia"})
    X, Y = np.meshgrid(grid.x, grid.y)
    He = sc.thickness(grid.radius)
    ub, vb = sc.sliding_velocity(X, Y)
    surface = _constant_surface(_f64(sc.accumulation(X, Y), device))
    state = _state(He, np.zeros(grid.shape2), device)
    state, stats = _run_sia(grid, cfg, state, surface, 0.0, years,
                            calving=_ocean_kill(grid, cfg, sc.cap.L, device),
                            device=device, prescribed_u=_f64(ub, device),
                            prescribed_v=_f64(vb, device))
    errs = _geometry_errors(state.geometry.ice_thickness.cpu().numpy(), He)
    base = {"max_ub(m/a)": float(np.abs(ub).max() * SPY),
            "max_vb(m/a)": float(np.abs(vb).max() * SPY)}
    _report(f"test E (sliding sector cap, {years:.0f} a, {Mx}x{Mx})",
            [("geometry", errs), ("base slide", base)])
    return errs


def run_D(Mx=61, years=2500.0, config=None, device="cuda"):
    """Compensatory accumulation oscillation (default: half a period)."""
    from ..coupler.surface import FunctionSurface
    from ..grid import Grid
    from . import exact_steady as es

    H_exact, M_comp = es.make_test_D()
    cap = es.SteadyCap()
    grid = Grid(Mx=Mx, My=Mx, Lx=900e3, Ly=900e3)
    cfg = _isothermal_config(config)
    r = _f64(grid.radius, device)
    H0 = H_exact(0.0, grid.radius)
    surface = FunctionSurface(
        lambda g, t: (M_comp(t, r), torch.full_like(g.ice_thickness, 263.15)))
    state = _state(H0, np.zeros(grid.shape2), device)
    state, stats = _run_sia(grid, cfg, state, surface, 0.0, years,
                            calving=_ocean_kill(grid, cfg, cap.L, device),
                            device=device)
    He = H_exact(years * SPY, grid.radius)
    errs = _geometry_errors(state.geometry.ice_thickness.cpu().numpy(), He)
    _report(f"test D (oscillating cap, {years:.0f} a, {Mx}x{Mx})",
            [("geometry", errs)])
    return errs


def _manufactured(ms, Mx, Mz, years, config, device):
    """Run a manufactured thermo-coupled dome (tests F and G) through
    ``IceModel.run``: the "pb" SIA on the prescribed enthalpy, no energy
    model. Returns (the initial thickness as numpy, final state, grid)."""
    from ..config import Config
    from ..grid import Grid
    from ..model.icemodel import IceModel
    from ..util.timecal import Time

    grid = Grid(Mx=Mx, My=Mx, Lx=750e3, Ly=750e3, Mz=Mz, Lz=3500.0)
    cfg = Config({"stress_balance.model": "sia",
                  "stress_balance.sia.flow_law": "pb",
                  "energy.model": "none"})
    if config:
        cfg.update(config)
    state, surface = ms.setup(grid, cfg, device=device)
    H0 = state.geometry.ice_thickness.cpu().numpy()
    model = IceModel(grid=grid, config=cfg, surface=surface, device=device)
    state, stats = model.run(state, Time(0.0, years * SPY))
    return H0, state, grid


def run_F(Mx=61, Mz=31, years=200.0, config=None, device="cuda"):
    """Thermo-coupled steady dome (manufactured-solution analog of F)."""
    from .manufactured import ManufacturedThermoSIA

    He, state, _ = _manufactured(ManufacturedThermoSIA(), Mx, Mz, years,
                                 config, device)
    errs = _geometry_errors(state.geometry.ice_thickness.cpu().numpy(), He)
    _report(f"test F (thermo-coupled dome, {years:.0f} a, {Mx}x{Mx}x{Mz})",
            [("geometry", errs)])
    return errs


def run_G(Mx=61, Mz=31, years=None, config=None, device="cuda"):
    """Test F plus a time-periodic wobble; by default one whole period,
    after which the exact solution is the initial state again."""
    from .manufactured import ManufacturedThermoSIAPeriodic

    ms = ManufacturedThermoSIAPeriodic()
    if years is None:
        years = ms.period / SPY
    _, state, grid = _manufactured(ms, Mx, Mz, years, config, device)
    He = ms.thickness_t(torch.tensor(years * SPY, dtype=torch.float64),
                        torch.as_tensor(grid.radius)).numpy()
    errs = _geometry_errors(state.geometry.ice_thickness.cpu().numpy(), He)
    _report(f"test G (periodic thermo dome, {years:.0f} a, {Mx}x{Mx}x{Mz})",
            [("geometry", errs)])
    return errs


def run_H(Mx=61, years=None, config=None, device="cuda"):
    """Moving margin + pointwise isostasy (similarity solution)."""
    from ..coupler.surface import FunctionSurface
    from ..grid import Grid
    from . import exact_steady as es
    from . import halfar

    sol = es.test_H()
    flat = sol.flat
    t0 = 0.6 * flat.t0
    t1 = flat.t0 if years is None else t0 + years * SPY
    grid = Grid(Mx=Mx, My=Mx, Lx=900e3, Ly=900e3)
    cfg = _isothermal_config({
        "bed_deformation.model": "iso",
        "bed_deformation.lithosphere_density": halfar.RHO_ICE / sol.f,
    })
    if config:
        cfg.update(config)
    H0 = sol.thickness(t0, grid.radius)
    b0 = sol.bed(t0, grid.radius)
    lam = sol.lam

    def smb(g, t):
        return lam / t * g.ice_thickness, \
            torch.full_like(g.ice_thickness, 263.15)

    state = _state(H0, b0, device)
    state, stats = _run_sia(grid, cfg, state, FunctionSurface(smb), t0,
                            (t1 - t0) / SPY, device=device)
    He = sol.thickness(t1, grid.radius)
    Hn = state.geometry.ice_thickness.cpu().numpy()
    errs = _geometry_errors(Hn, He)
    bn = state.geometry.bed_elevation.cpu().numpy()
    icy = Hn > 1.0
    bed_err = float(np.max(np.abs(bn + sol.f * Hn)[icy])) if icy.any() else 0.0
    _report(f"test H (isostasy similarity, {(t1 - t0) / SPY:.0f} a, "
            f"{Mx}x{Mx})",
            [("geometry", errs), ("bed", {"max|b + f H|": bed_err})])
    return errs


def run_L(Mx=61, years=1000.0, config=None, device="cuda"):
    """Steady cap over a non-flat bed (exact profile via the radial ODE)."""
    from ..grid import Grid
    from . import exact_steady as es

    cap = es.test_L()
    grid = Grid(Mx=Mx, My=Mx, Lx=900e3, Ly=900e3)
    cfg = _isothermal_config(config)
    He = cap.solve(grid.radius)
    surface = _constant_surface(
        _f64(np.where(grid.radius < cap.L, cap.M0, 0.0), device))
    state = _state(He, cap.bed(grid.radius), device)
    state, stats = _run_sia(grid, cfg, state, surface, 0.0, years,
                            calving=_ocean_kill(grid, cfg, cap.L, device),
                            device=device)
    errs = _geometry_errors(state.geometry.ice_thickness.cpu().numpy(), He)
    _report(f"test L (cap on non-flat bed, {years:.0f} a, {Mx}x{Mx})",
            [("geometry", errs)])
    return errs


def _column(cfg, Mz, H0, device, **grid_kw):
    """A 3x3 column grid of ice H0 thick and its energy model, with zero
    velocities and strain heating: (grid, EC, energy model, state without
    enthalpy, the SIA3D of zeros, the ice pressure on the levels)."""
    from ..grid import Grid
    from ..model.energy import EnergyModel
    from ..ops.sia3d import SIA3D
    from ..physics.enthalpy_converter import EnthalpyConverter

    grid = Grid(Mx=3, My=3, Lx=10e3, Ly=10e3, Mz=Mz, Lz=1.15 * H0, **grid_kw)
    EC = EnthalpyConverter.from_config(cfg)
    em = EnergyModel(grid=grid, config=cfg, EC=EC)
    state = _state(np.full(grid.shape2, H0), np.zeros(grid.shape2), device)
    zeros3 = torch.zeros(grid.shape3, dtype=torch.float64, device=device)
    zero = torch.zeros((), dtype=torch.float64, device=device)
    sia3 = SIA3D(u=zeros3, v=zeros3, w=zeros3, strain_heating=zeros3,
                 max_u=zero, max_v=zero)
    z = torch.as_tensor(grid.z, dtype=torch.float64, device=device)
    p = EC.pressure(torch.clamp(state.geometry.ice_thickness[..., None] - z,
                                min=0.0))
    return grid, EC, em, state, sia3, p


def _conduct(em, state, sia3, Ts, G, dt, nsteps):
    """``nsteps`` energy steps of ``dt`` under surface temperature Ts and
    geothermal flux G (the JAX runner's ``lax.scan``): (final enthalpy,
    the last step's basal melt rate)."""
    H = state.geometry.ice_thickness
    T_sfc, Gf = torch.full_like(H, Ts), torch.full_like(H, G)
    E, melt = state.enthalpy, None
    for _ in range(nsteps):
        res = em.step(state.replace(enthalpy=E), sia3, T_sfc, dt,
                      geothermal_flux=Gf)
        E, melt = res.enthalpy, res.basal_melt_rate
    return E, melt


def run_K(Mz=41, years=300000.0, config=None, device="cuda"):
    """Cold conduction column: steady linear profile with slope G/k_i,
    plus the bedrock thermal layer carrying exactly G."""
    from ..config import Config
    from ..model.btu import btu_from_config

    cfg = Config(config or {})
    k_i = cfg.get_number("constants.ice.thermal_conductivity")
    H0, G, Ts = 1000.0, 0.02, 233.15
    grid, EC, em, state, sia3, p = _column(cfg, Mz, H0, device, Mbz=11,
                                           Lbz=1000.0)
    state = state.replace(enthalpy=EC.enthalpy(torch.full_like(p, Ts), 0.0, p))
    E_fin, _ = _conduct(em, state, sia3, Ts, G, years * SPY / 200, 200)
    zn = np.asarray(grid.z)
    in_ice = zn <= H0 - 1.0
    T = EC.temperature(E_fin[1, 1], p[1, 1]).cpu().numpy()
    T_exact = Ts + G / k_i * (H0 - zn)
    ice_err = float(np.max(np.abs(T - T_exact)[in_ice]))
    # bedrock: the steady linear profile carrying exactly G
    btu = btu_from_config(grid, cfg)
    k_b = cfg.get_number("energy.bedrock_thermal.conductivity")
    H = state.geometry.ice_thickness
    T_top, Gf = torch.full_like(H, 260.0), torch.full_like(H, G)
    bed_T = btu.init_temperature(T_top, Gf)
    for _ in range(200):
        bed_T, flux = btu.step(bed_T, T_top, Gf, 2000.0 * SPY)
    flux_err = abs(float(flux[1, 1]) - G)
    dT_err = abs(float(bed_T[1, 1, 0] - bed_T[1, 1, -1]) - G * 1000.0 / k_b)
    errs = {"maxT_ice": ice_err, "bed_flux_err": flux_err,
            "bed_dT_err": dT_err}
    _report(f"test K (cold two-layer column, {years:.0f} a, Mz={Mz})",
            [("temp", errs)])
    return errs


def run_O(Mz=41, years=300000.0, config=None, device="cuda"):
    """Warm-based conduction column: steady basal melt = flux imbalance
    over rho_i L."""
    from ..config import Config

    cfg = Config(config or {})
    k_i = cfg.get_number("constants.ice.thermal_conductivity")
    rho_i = cfg.get_number("constants.ice.density")
    Lf = cfg.get_number("constants.fresh_water.latent_heat_of_fusion")
    H0, G = 1000.0, 0.042
    grid, EC, em, state, sia3, p = _column(cfg, Mz, H0, device)
    Tm_base = float(EC.melting_temperature(EC.pressure(H0)))
    Ts = Tm_base - 5.0
    # start temperate
    state = state.replace(enthalpy=EC.enthalpy(EC.melting_temperature(p),
                                               0.0, p))
    _, melt = _conduct(em, state, sia3, Ts, G, years * SPY / 200, 200)
    M_exact = (G - k_i * (Tm_base - Ts) / H0) / (rho_i * Lf)
    M = float(melt[1, 1])
    errs = {"bmelt": M * SPY, "bmelt_exact": M_exact * SPY,
            "prcnt_err": 100.0 * abs(M - M_exact) / M_exact}
    _report(f"test O (steady basal melt, {years:.0f} a, Mz={Mz})",
            [("bmelt", errs)])
    return errs


def run_P(Mx=51, years=2.5, config=None, device="cuda"):
    """Routing hydrology against the exact radial steady state: weekly
    steps of ``Routing`` alone from a dry layer under a saturated till."""
    from ..config import Config
    from ..grid import Grid
    from ..physics.hydrology import Routing
    from ..state import ModelState, new_geometry
    from .hydrology_exact import RoutingSteady

    sol = RoutingSteady()
    grid = Grid(Mx=Mx, My=Mx, Lx=30e3, Ly=30e3)
    cfg = Config({
        "hydrology.model": "routing",
        "hydrology.tillwat_decay_rate": 0.0,
        "hydrology.hydraulic_conductivity": sol.k,
        "hydrology.alpha": sol.alpha,
        "hydrology.beta": sol.beta,
    })
    if config:
        cfg.update(config)
    r = grid.radius
    W_max = cfg.get_number("hydrology.tillwat_max")

    def t64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    state = ModelState(
        geometry=new_geometry(t64(sol.thickness(r)), t64(sol.bed(r))),
        tillwat=t64(np.full(grid.shape2, W_max)),
        basal_melt_rate=t64(np.where(r < sol.R_i, sol.melt, 0.0)),
        hydro_W=t64(np.zeros(grid.shape2)))
    hydro = Routing(grid=grid, config=cfg)
    week = 7.0 * 24 * 3600.0
    for _ in range(int(years * SPY / week)):
        state = hydro.step(state, week)
    W = state.hydro_W.cpu().numpy()
    We = sol.water_thickness(r)
    sel = (r > 0.2 * sol.R_i) & (r < 0.9 * sol.R_i)
    rel = np.abs(W[sel] - We[sel]) / We[sel]
    errs = {"max_W": float(np.abs(W[sel] - We[sel]).max()),
            "avg_W": float(np.abs(W[sel] - We[sel]).mean()),
            "median_rel_prcnt": 100.0 * float(np.median(rel))}
    _report(f"test P (routing steady state, {years:.1f} a, {Mx}x{Mx})",
            [("hydro W", errs)])
    return errs


def run_test(letter, *, Mx=None, My=None, Mz=None, years=None, config=None,
             device="cuda"):
    """Dispatch a verification run by pismv letter (A, D, E, F, G, H, K, L,
    O, P, blatter_xz, blatter_xz_cfbc). Returns the error dict (also
    printed as a pismv-style table). The
    runs are on square grids, so ``My`` is accepted, as the JAX package's
    runner accepts it, and unused; ``Mz`` sets F, G, K and O's levels and
    ``Mx`` is unused by K and O."""
    if str(letter).lower() in ("blatter_xz", "blatter_xz_cfbc"):
        # the JAX runner's rows; Mz, which it leaves to its rule, sets a
        # single row's levels
        from .blatter_xz import run_blatter_xz, run_blatter_xz_cfbc
        kw = {"config": config, "device": device}
        if Mx is not None:
            kw["Mx_list"] = (Mx,)
        if Mz is not None:
            kw["Mz_list"] = (Mz,)
        fn = run_blatter_xz if str(letter).lower() == "blatter_xz" \
            else run_blatter_xz_cfbc
        return fn(**kw)
    letter = str(letter).upper()
    fn = {"A": run_A, "D": run_D, "E": run_E, "F": run_F, "G": run_G,
          "H": run_H, "K": run_K, "L": run_L, "O": run_O,
          "P": run_P}.get(letter)
    if fn is None:
        raise NotImplementedError(
            f"verification test {letter!r} is not implemented in "
            f"pism_tpu_torch (supported: {', '.join(SUPPORTED)}; B and C are "
            "setups.halfar_model)")
    kw = {"config": config, "device": device}
    if years is not None:
        kw["years"] = years
    if Mx is not None and letter not in "KO":
        kw["Mx"] = Mx
    if Mz is not None and letter in "FGKO":
        kw["Mz"] = Mz
    return fn(**kw)
