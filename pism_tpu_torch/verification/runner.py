"""Verification runs by letter (port of ``pism_tpu/verification/runner.py`` for
the isothermal SIA letters of PISM's ``pismv``): set up an exact-solution
test by letter, run it through ``IceModel.step_once``, and print a
pismv-style numerical-error report.

Ported letters: A (steady cap, fixed margin), D (compensatory
oscillation), H (moving margin with pointwise isostasy) and L (steady cap
on a non-flat bed). B and C, the Halfar similarity solutions, are
``setups.halfar_model`` (the CLI's ``-test B/C`` route). Every other letter
raises ``NotImplementedError``.

Every run's fields are float64 on ``device`` (default ``"cuda"``; pass
``device="cpu"`` for a run on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

SPY = 3.15569259747e7

SUPPORTED = "ADHL"


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
             device="cuda"):
    from ..model.icemodel import IceModel
    model = IceModel(grid=grid, config=cfg, surface=surface, calving=calving,
                     device=device)
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


def run_test(letter, *, Mx=None, My=None, Mz=None, years=None, config=None,
             device="cuda"):
    """Dispatch a verification run by pismv letter (A, D, H, L). Returns the
    error dict (also printed as a pismv-style table). ``My`` and ``Mz`` are
    accepted as the JAX package's runner accepts them; the ported letters
    run on square 2D grids, so they use neither."""
    letter = str(letter).upper()
    fn = {"A": run_A, "D": run_D, "H": run_H, "L": run_L}.get(letter)
    if fn is None:
        raise NotImplementedError(
            f"verification test {letter!r} is not implemented in "
            f"pism_tpu_torch (supported: {', '.join(SUPPORTED)}; B and C are "
            "setups.halfar_model)")
    kw = {"config": config, "device": device}
    if years is not None:
        kw["years"] = years
    if Mx is not None:
        kw["Mx"] = Mx
    return fn(**kw)
