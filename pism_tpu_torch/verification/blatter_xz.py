"""Blatter verification problems in the XZ plane (port of
``pism_tpu/verification/blatter_xz.py``), each a float64 solve on
``device`` (default ``"cuda"``):

- :func:`solve_xz`: the manufactured periodic slab. Linear rheology (n =
  1), stress-free surface and bed, the compensatory body force of the
  continuous operator applied to u*(x, z) = U0 sin(kx)(c0 + cos(pi z/H)).
- :func:`solve_xz_cfbc`: an unconfined floating slab closed by the
  depth-varying calving-front stress condition, whose exact strain rate is
  van der Veen's u_x* = A (rho_i g (1 - rho_i/rho_w) H / 4)^n.

``run_blatter_xz`` and ``run_blatter_xz_cfbc`` print the JAX package's
refinement tables; ``Mz_list`` sets the levels of each row where the JAX
runner's rule would (``(Mx + 1) // 2 + 1``, or 13 for the CFBC row).
"""

from __future__ import annotations

import numpy as np

SPY = 3.15569259747e7
RHO_I, RHO_W, GRAV = 910.0, 1028.0, 9.81


def _f64(a, device):
    import torch
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float64,
                           device=device)


def solve_xz(Mx: int, Mz: int, device="cuda", info: dict = None):
    """One manufactured-XZ solve; returns (max_err [m/a], scale [m/a]).
    ``info``, when given, takes the solve's Newton sweeps and Krylov
    iterations."""
    from ..config import Config
    from ..grid import Grid
    from ..model.blatter import BlatterSolver
    from ..physics.rheology import IsothermalGlen
    from ..state import ModelState, new_geometry

    H0, Lx = 1000.0, 50e3
    U0, c0 = 100.0 / SPY, 2.0
    A1 = 1e-14                       # linear softness [Pa-1 s-1]
    nu0 = 0.5 / A1
    grid = Grid(Mx=Mx, My=5, Lx=Lx, Ly=25e3, Mz=Mz, Lz=H0,
                vertical_spacing="equal", periodicity="xy")
    k = 2.0 * np.pi / (Mx * grid.dx)   # one wavelength per periodic wrap
    X = np.asarray(grid.x)[None, :, None]
    Z = np.asarray(grid.z)[None, None, :]
    u_exact = np.broadcast_to(
        U0 * np.sin(k * X) * (c0 + np.cos(np.pi * Z / H0)),
        (grid.My, Mx, Mz))
    fx = np.broadcast_to(
        nu0 * U0 * np.sin(k * X) * (
            4.0 * k ** 2 * (c0 + np.cos(np.pi * Z / H0))
            + (np.pi / H0) ** 2 * np.cos(np.pi * Z / H0)),
        (grid.My, Mx, Mz))
    cfg = Config({"stress_balance.ssa.Glen_exponent": 1.0,
                  "stress_balance.ssa.fd.beta_floor": 1e-8,
                  "stress_balance.ssa.fd.newton_rtol": 1e-10,
                  "basal_resistance.pseudo_plastic.enabled": True})
    zero2 = _f64(np.zeros(grid.shape2), device)
    geom = new_geometry(_f64(np.full(grid.shape2, H0), device), zero2)
    solver = BlatterSolver(grid=grid, config=cfg,
                           flow_law=IsothermalGlen(A=A1, n=1.0),
                           taud_x=zero2, taud_y=zero2,
                           body_force_x=_f64(fx, device),
                           body_force_y=_f64(np.zeros(grid.shape3), device))
    u, v, d = solver.solve(ModelState(geometry=geom), zero2, diagnostics=True)
    if info is not None:
        info.update(newton_iters=d["newton_iters"],
                    krylov_iters=d["krylov_iters"])
    err = float(np.abs(u.cpu().numpy() - u_exact).max()) * SPY
    return err, float(np.abs(u_exact).max()) * SPY


def solve_xz_cfbc(Mx: int, Mz: int, device="cuda", info: dict = None):
    """One floating-slab CFBC solve; returns (strain_err_rel, ux_exact
    [1/s]): the mid-shelf, mid-depth strain rate against van der Veen's.
    The error lives in the per-level front-face quadrature of the
    depth-varying stress condition, so it converges under Mz refinement
    and is nearly independent of dx."""
    from ..config import Config
    from ..grid import Grid
    from ..model.blatter import BlatterSolver
    from ..physics.rheology import IsothermalGlen
    from ..state import ModelState, new_geometry

    import torch

    H0 = 500.0
    A3 = 1e-16 / SPY
    Lx = 60e3
    grid = Grid(Mx=Mx, My=6, Lx=Lx, Ly=15e3, Mz=Mz, Lz=H0,
                vertical_spacing="equal", periodicity="y")
    n_ocean = max(Mx // 4, 3)
    n_anchor = 3
    H = np.full((6, Mx), H0)
    H[:, -n_ocean:] = 0.0
    bed = np.full((6, Mx), -2000.0)
    geom = new_geometry(_f64(H, device), _f64(bed, device))
    bc = np.zeros((6, Mx), bool)
    bc[:, :n_anchor] = True
    solver = BlatterSolver(grid=grid, config=Config(),
                           flow_law=IsothermalGlen(A=A3),
                           bc_mask=torch.as_tensor(bc, device=device))
    u, v, d = solver.solve(ModelState(geometry=geom),
                           _f64(np.zeros(grid.shape2), device),
                           diagnostics=True)
    if info is not None:
        info.update(newton_iters=d["newton_iters"],
                    krylov_iters=d["krylov_iters"])
    u = u.cpu().numpy()

    theta = 1.0 - RHO_I / RHO_W
    ux = A3 * (RHO_I * GRAV * theta * H0 / 4.0) ** 3
    front = Mx - n_ocean - 1                # last icy column
    mid = (n_anchor + front) // 2
    kmid = Mz // 2
    got = (u[3, mid + 1, kmid] - u[3, mid - 1, kmid]) / (2.0 * grid.dx)
    return abs(float(got) - ux) / ux, ux


def run_blatter_xz(Mx_list=(17, 33, 65), config=None, device="cuda",
                   Mz_list=None):
    """The pismv-style refinement table of the manufactured XZ problem."""
    rows = []
    for j, Mx in enumerate(Mx_list):
        Mz = (Mx + 1) // 2 + 1 if Mz_list is None else Mz_list[j]
        err, scale = solve_xz(Mx, Mz, device)
        rows.append({"Mx": Mx, "Mz": Mz, "max_u_err_m_a": round(err, 4),
                     "rel": round(err / scale, 5)})
    _print_table("Blatter manufactured XZ (BlatterTestXZ role)", rows)
    return {"test": "blatter_xz", "rows": rows}


def run_blatter_xz_cfbc(Mz_list=(7, 13, 25, 49), config=None,
                        Mx_list=None, device="cuda"):
    """The vertical-refinement table of the floating-slab CFBC problem; a
    single horizontal size from the runner takes Mz = 13 unless
    ``Mz_list`` is given with it."""
    if Mx_list is not None and Mz_list == (7, 13, 25, 49):
        Mz_list = (13,)
    rows = []
    for Mz in Mz_list:
        Mx = 49 if Mx_list is None else Mx_list[0]
        err_rel, ux = solve_xz_cfbc(Mx, Mz, device)
        rows.append({"Mx": Mx, "Mz": Mz,
                     "strain_rate_rel_err": round(err_rel, 5),
                     "ux_exact_per_a": round(ux * SPY, 6)})
    print("verification: Blatter XZ calving-front stress BC "
          "(van der Veen, Mz refinement)")
    print("   Mx    Mz    |du/dx - ux*|/ux*")
    for r in rows:
        print(f"  {r['Mx']:4d}  {r['Mz']:4d}    {r['strain_rate_rel_err']:.5f}")
    return {"test": "blatter_xz_cfbc", "rows": rows}


def _print_table(title, rows):
    print(f"verification: {title}")
    print("   Mx    Mz    max|u-u*| [m/a]   relative")
    for r in rows:
        print(f"  {r['Mx']:4d}  {r['Mz']:4d}    {r['max_u_err_m_a']:14.4f}"
              f"   {r['rel']:.5f}")
