"""The SSA verification tests I, J, M, V and N by letter (the ``-test``
branches of ``pism_tpu/cli.py:288-451``): each builds its grid, config,
Dirichlet ring and exact solution as the JAX command line does, runs one
``SSAFD`` solve on ``device`` (default ``"cuda"``) in float64, and returns
the solution, the solve's diagnostics and the JAX command line's report
line. Test I takes ``stress_balance.ssa.method = fem`` too: one
``SSAFEM`` solve.

- I: Schoof's plastic-till stream (exact drag Jacobian, periodic in x,
  prescribed driving stress);
- J: the manufactured periodic shelf (``ssa_manufactured.py``, the ``mg``
  preconditioner) at Mx and 2 (Mx - 1) + 1 points, with the rate;
- M: the annular shelf with the staircase calving front;
- V: van der Veen's unconfined shelf (calving-front stress BC, periodic
  in y);
- N: the Bodvardsson plastic-till stream ending in a calving front (exact
  drag Jacobian, periodic in y).

``config``: overrides of the test's config (the command line's ``-config``
pairs as a dict).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

SPY = 3.15569259747e7


@dataclass
class SSATestResult:
    letter: str
    report: str
    grid: object
    u: object = None           # (My, Mx) tensors, m/s (J: the finer grid's
    v: object = None           # error only)
    info: object = None        # the solve's diagnostics (J: a list of two)
    errors: dict = None        # the report's numbers


def _config(defaults, config):
    from ..config import Config
    cfg = Config(defaults)
    if config:
        cfg.update(config)
    return cfg


def _f64(a, device):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64, device=device)


def _solve(grid, cfg, B, H, bed, device, tau_c=None, bc=None, bc_u=None,
           bc_v=None, taud=None, cls=None):
    """One solve (SSAFD, or ``cls``) of the test's float64 fields on
    ``device``: (u, v, the solve's diagnostics)."""
    from ..model.ssa import SSAFD
    from ..physics.rheology import IsothermalGlen
    from ..state import ModelState, new_geometry

    f = lambda a: None if a is None else _f64(a, device)   # noqa: E731
    ssa = (cls or SSAFD)(grid=grid, config=cfg,
                flow_law=IsothermalGlen(A=float(B) ** -3.0),
                bc_mask=None if bc is None else torch.as_tensor(
                    bc, device=device),
                bc_u=f(bc_u), bc_v=f(bc_v),
                taud_x=None if taud is None else f(taud[0]),
                taud_y=None if taud is None else f(taud[1]))
    geom = new_geometry(f(H), f(bed))
    return ssa.solve(ModelState(geometry=geom), f(tau_c), diagnostics=True)


def ssa_test_I(Mx=None, My=None, config=None, device="cuda"):
    from ..config import require
    from ..grid import Grid
    from ..model.ssa import SSAFD
    from ..model.ssafem import SSAFEM
    from .ssa_exact import ExactI

    ti = ExactI()
    Mx, My = Mx or 11, My or 61
    grid = Grid(Mx=Mx, My=My, Lx=10e3, Ly=60e3, periodicity="x")
    # fully converged; plastic drag dominates test I, so the exact drag
    # Jacobian (frozen beta stagnates here)
    cfg = _config({"stress_balance.ssa.fd.velocity_change_rtol": 0.0,
                   "stress_balance.ssa.fd.drag_jacobian": "exact"}, config)
    require(cfg, "stress_balance.ssa.method", ("fd", "fem"))
    cls = SSAFEM if cfg.get_string("stress_balance.ssa.method") == "fem" \
        else SSAFD
    tau_c = np.tile(ti.tau_c(grid.y)[:, None], (1, Mx))
    bc = np.zeros(grid.shape2, bool)
    bc[0, :] = bc[-1, :] = True
    zero = np.zeros(grid.shape2)
    u, v, info = _solve(
        grid, cfg, ti.B, np.full(grid.shape2, ti.H0), zero, device,
        tau_c=tau_c, bc=bc, bc_u=zero, bc_v=zero,
        taud=(np.full(grid.shape2, ti.f), zero), cls=cls)
    un = u.cpu().numpy()
    uex = ti.velocity(grid.y)
    err = np.abs(un[:, Mx // 2] - uex) * SPY
    report = (f"test I ({cls.__name__}): max |u| = "
              f"{float(np.abs(un).max()) * SPY:.2f} "
              f"m/a (exact {float(np.abs(uex).max()) * SPY:.2f}); max error "
              f"= {err.max():.3f} m/a, avg = {err.mean():.3f} m/a")
    return SSATestResult("I", report, grid, u, v, info,
                         {"max": err.max(), "avg": err.mean()})


def ssa_test_J(Mx=None, My=None, config=None, device="cuda"):
    from .ssa_manufactured import ManufacturedSSA

    m = ManufacturedSSA()
    Mx = Mx or 61
    Mx2 = 2 * (Mx - 1) + 1
    err, grid, info = m.solve_on(Mx, device, diagnostics=True, config=config)
    err2, _, info2 = m.solve_on(Mx2, device, diagnostics=True, config=config)
    rate = np.log2(err / max(err2, 1e-30))
    report = (f"test J (manufactured periodic shelf, {Mx} -> {Mx2} points): "
              f"max velocity error = {err * SPY:.3f} -> {err2 * SPY:.3f} m/a "
              f"(rate {rate:.2f})")
    return SSATestResult("J", report, grid, info=[info, info2],
                         errors={"max": err * SPY, "max2": err2 * SPY,
                                 "rate": rate})


def ssa_test_M(Mx=None, My=None, config=None, device="cuda"):
    from ..grid import Grid
    from .ssa_exact import ExactM

    tm = ExactM()
    Mx = Mx or 61
    grid = Grid(Mx=Mx, My=Mx, Lx=750e3, Ly=750e3)
    cfg = _config({"stress_balance.ssa.fd.velocity_change_rtol": 0.0}, config)
    X, Y = np.meshgrid(np.asarray(grid.x), np.asarray(grid.y))
    R = np.hypot(X, Y)
    Rs = np.maximum(R, 1.0)
    u_ex = tm.velocity(R)
    bc = R <= tm.Rg + grid.dx
    H = np.where(R <= tm.Rc, tm.H0m, 0.0)
    u, v, info = _solve(
        grid, cfg, tm.B, H, np.full(grid.shape2, -3000.0), device, bc=bc,
        bc_u=np.where(bc, u_ex * X / Rs, 0.0),
        bc_v=np.where(bc, u_ex * Y / Rs, 0.0))
    spd = np.hypot(u.cpu().numpy(), v.cpu().numpy())
    sel = (R > tm.Rg + grid.dx) & (R < tm.Rc - grid.dx)
    err = np.abs(spd[sel] - u_ex[sel]) * SPY
    report = (f"test M (SSAFD, annulus + staircase CFBC): max speed = "
              f"{spd.max() * SPY:.2f} m/a (exact front "
              f"{tm.velocity(tm.Rc) * SPY:.2f}); max error = "
              f"{err.max():.2f} m/a, avg = {err.mean():.2f} m/a")
    return SSATestResult("M", report, grid, u, v, info,
                         {"max": err.max(), "avg": err.mean()})


def ssa_test_V(Mx=None, My=None, config=None, device="cuda"):
    from ..grid import Grid
    from .ssa_exact import ExactV

    tv = ExactV()
    Mx, My = Mx or 101, My or 5
    L = 300e3
    grid = Grid(Mx=Mx, My=My, Lx=L / 2, Ly=50e3, periodicity="y")
    cfg = _config({"stress_balance.ssa.fd.velocity_change_rtol": 0.0}, config)
    x = np.asarray(grid.x) + L / 2
    jf = int(0.85 * Mx)
    H = np.zeros(grid.shape2)
    H[:, :jf] = np.tile(tv.thickness(x[:jf])[None, :], (My, 1))
    bc = np.zeros(grid.shape2, bool)
    bc[:, 0] = True
    u_in = np.zeros(grid.shape2)
    u_in[:, 0] = tv.velocity(x[0])
    u, v, info = _solve(
        grid, cfg, tv.B, H, np.full(grid.shape2, -3000.0), device, bc=bc,
        bc_u=u_in, bc_v=np.zeros(grid.shape2))
    un = u.cpu().numpy()
    uex = tv.velocity(x[:jf])
    err = np.abs(un[My // 2, :jf] - uex) * SPY
    report = (f"test V (SSAFD, CFBC): front u = "
              f"{float(un[My // 2, jf - 1]) * SPY:.2f} m/a (exact "
              f"{uex[-1] * SPY:.2f}); max error = {err.max():.3f} m/a, "
              f"avg = {err.mean():.3f} m/a")
    return SSATestResult("V", report, grid, u, v, info,
                         {"max": err.max(), "avg": err.mean()})


def ssa_test_N(Mx=None, My=None, config=None, device="cuda"):
    from ..grid import Grid
    from .ssa_exact import ExactN

    tn = ExactN()
    Mx, My = Mx or 221, My or 5
    grid = Grid(Mx=Mx, My=My, Lx=440e3, Ly=50e3, periodicity="y")
    cfg = _config({"stress_balance.ssa.fd.drag_jacobian": "exact"}, config)
    x = np.asarray(grid.x)
    H = np.tile(tn.thickness(x)[None, :], (My, 1))
    tau = np.tile(tn.tau_c(x)[None, :], (My, 1))
    bc = np.zeros(grid.shape2, bool)
    bc[:, Mx // 2] = True
    zero = np.zeros(grid.shape2)
    u, v, info = _solve(grid, cfg, tn.B, H, np.full(grid.shape2, -tn.depth),
                        device, tau_c=tau, bc=bc, bc_u=zero, bc_v=zero)
    un = u.cpu().numpy()
    uex = tn.velocity(x)
    sel = np.abs(x) <= tn.xc - 2 * grid.dx
    err = np.abs(un[My // 2] - uex)[sel] * SPY
    report = (f"test N (SSAFD, plastic till + CFBC, exact drag Jacobian): "
              f"max u = {un[My // 2].max() * SPY:.1f} m/a (exact "
              f"{uex.max() * SPY:.1f}); interior max error = "
              f"{err.max():.2f} m/a, avg = {err.mean():.2f} m/a "
              f"({int(info['newton_iters'])} Newton sweeps)")
    return SSATestResult("N", report, grid, u, v, info,
                         {"max": err.max(), "avg": err.mean()})


def run_test(letter, Mx=None, My=None, config=None, device="cuda"):
    """Run test ``letter`` (one of I, J, M, V, N), print its report line and
    return its :class:`SSATestResult`."""
    fn = {"I": ssa_test_I, "J": ssa_test_J, "M": ssa_test_M, "V": ssa_test_V,
          "N": ssa_test_N}[letter.upper()]
    res = fn(Mx=Mx, My=My, config=config, device=device)
    print(res.report)
    return res
