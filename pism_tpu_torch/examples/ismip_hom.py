"""ISMIP-HOM experiments A and C (Pattyn et al. 2008) on the port's
Blatter-Pattyn solver (the twin of the JAX package's
``examples/ismip_hom.py``).

Experiment A: no-slip flow over sinusoidal basal bumps,
    zb = zs - 1000 + 500 sin(wx) sin(wy),  zs tilted 0.5 degrees.
Experiment C: sliding over a flat bed with a sinusoidal linear friction
coefficient, beta2 = 1000 + 1000 sin(wx) sin(wy) [Pa a m-1], tilt 0.1
degrees.

Both are solved in the mean-slope frame (a flat surface, a prescribed
driving stress, the bumps in the thickness), periodic over the domain
length L, in float64. Each line is a JSON record of the surface velocity
along y = L/4 (umin, umax, umean [m/a]), the Newton sweeps, the Krylov
iterations and the solve's seconds; for A also the ratio of the transect's
maximum to the analytic SIA surface velocity.

Usage: python -m pism_tpu_torch.examples.ismip_hom [--exp A|C]
           [--L 5,10,20,40,80,160] [--Mx 40] [--Mz 16] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

SPY = 3.15569259747e7
RHO, G = 910.0, 9.81
A_GLEN = 1e-16 / SPY     # Pa^-3 s^-1 (the ISMIP-HOM value)


def setup(exp, L_km, Mx, Mz, device="cuda"):
    """(solver, state, tau_c, H, jrow): experiment ``exp`` at L = ``L_km``
    on an Mx x Mx x Mz periodic grid; ``jrow`` the transect's row."""
    import torch

    from ..config import Config
    from ..grid import Grid
    from ..model.blatter import BlatterSolver
    from ..physics.rheology import IsothermalGlen
    from ..state import ModelState, new_geometry

    L = L_km * 1e3
    H0 = 1000.0
    alpha = np.deg2rad(0.5 if exp == "A" else 0.1)
    grid = Grid(Mx=Mx, My=Mx, Lx=L / 2, Ly=L / 2, Mz=Mz, Lz=2000.0,
                vertical_spacing="equal", periodicity="xy")
    # the periodic wrap length is Mx dx: its wavenumber keeps the fields
    # exactly periodic on the grid
    w = 2.0 * np.pi / (Mx * grid.dx)
    X, Y = np.meshgrid(grid.x, grid.y)
    cfg = Config({"basal_resistance.plastic.regularization": 1e-4,
                  "basal_resistance.pseudo_plastic.enabled": exp == "C",
                  "basal_resistance.pseudo_plastic.q": 1.0,
                  "basal_resistance.pseudo_plastic.u_threshold": 100.0})
    if exp == "A":
        H = H0 - 500.0 * np.sin(w * X) * np.sin(w * Y)
        tau_c = np.full(grid.shape2, 1e8)            # no slip
    else:
        H = np.full(grid.shape2, H0)
        beta2 = (1000.0 + 1000.0 * np.sin(w * X) * np.sin(w * Y)) * SPY
        # pseudo-plastic with q = 1: beta = tau_c / u_threshold
        tau_c = beta2 * (100.0 / SPY)

    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    # the mean-slope frame: a flat surface at 2000 m, the bumps in the bed
    geom = new_geometry(f64(H), f64(2000.0 - H))
    taud = RHO * G * H * np.tan(alpha)
    solver = BlatterSolver(grid=grid, config=cfg,
                           flow_law=IsothermalGlen(A=A_GLEN),
                           taud_x=f64(taud), taud_y=f64(np.zeros(grid.shape2)))
    jrow = int(round(Mx * 0.75)) % Mx               # y = +L/4 from center
    return solver, ModelState(geometry=geom), f64(tau_c), H, jrow


def run_one(exp, L_km, Mx, Mz, device="cuda", raw=False):
    """One experiment's record (the JAX example's keys, rounded as it
    rounds, plus Krylov iterations and seconds); ``raw`` adds the
    unrounded transect and velocity field under ``"_us"`` and ``"_u"``."""
    import torch

    solver, state, tau_c, H, jrow = setup(exp, L_km, Mx, Mz, device)
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    u, v, info = solver.solve(state, tau_c, diagnostics=True)
    u = u.cpu().numpy() * SPY
    seconds = time.perf_counter() - t0
    us = u[jrow, :, -1]
    out = {"L_km": L_km, "umin": round(float(us.min()), 2),
           "umax": round(float(us.max()), 2),
           "umean": round(float(us.mean()), 2),
           "newton_iters": int(info["newton_iters"]),
           "krylov_iters": int(info["krylov_iters"]),
           "seconds": round(seconds, 3)}
    if exp == "A":
        # the SIA limit: u_s = 2A/(n+1) (rho g sin a)^n H^(n+1)
        alpha = np.deg2rad(0.5)
        u_sia = 2.0 * A_GLEN / 4.0 * (RHO * G * np.sin(alpha)) ** 3 \
            * H[jrow, :] ** 4 * SPY
        out["max_over_sia"] = round(float(us.max() / u_sia.max()), 3)
    if raw:
        out["_us"], out["_u"] = us, u
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", default="A", choices=("A", "C"))
    ap.add_argument("--L", default="5,10,20,40,80,160")
    ap.add_argument("--Mx", type=int, default=40)
    ap.add_argument("--Mz", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    print(f"ISMIP-HOM experiment {args.exp} (Blatter-Pattyn, "
          f"{args.Mx}x{args.Mx}x{args.Mz}, surface transect y = L/4)")
    records = []
    for L_km in (float(s) for s in args.L.split(",")):
        records.append(run_one(args.exp, L_km, args.Mx, args.Mz,
                               args.device))
        print(json.dumps(records[-1]))
    return records


if __name__ == "__main__":
    main()
