"""Manufactured-solution verification of the nonlinear SSA (port of
``pism_tpu/verification/ssa_manufactured.py``; the role of PISM's periodic
shelf test J).

A doubly periodic manufactured solution that exercises the full nonlinear
operator: variable thickness, Glen viscosity with the Schoof
regularization, both momentum components coupled, and linear basal drag.
The compensatory driving stress comes from the continuous equations with
exact pointwise derivatives (``torch.func.grad`` on the closed-form fields,
float64 on the CPU; the JAX package nests ``jax.grad``):

    taud* = -div(2 nu H [2 e_xx + e_yy, e_xy; e_xy, 2 e_yy + e_xx]) + beta u*

so the discrete solution converges to (u*, v*) at the scheme's order
(O(h^2) centered differences). The continuous viscosity takes the solver's
Schoof regularization and additive nuH epsilon (both from the config), and
the field period is the grid's wrap distance Mx*dx.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SPY = 3.15569259747e7


class ManufacturedSSA:
    """Closed-form periodic fields and their compensatory source."""

    def __init__(self, L=400.0e3, H0=800.0, H1=100.0,
                 U0=300.0 / SPY, V0=200.0 / SPY,
                 A=1.0e-16 / SPY, n=3.0,
                 tau_c=5.0e4, u_threshold=100.0 / SPY):
        self.L = L
        self.H0, self.H1 = H0, H1
        self.U0, self.V0 = U0, V0
        self.A, self.n = A, n
        self.B = A ** (-1.0 / n)
        self.tau_c = tau_c
        self.u_threshold = u_threshold
        self.beta = tau_c / u_threshold       # pseudo-plastic q = 1
        # set per grid in solve_on
        self.k = np.pi / L
        self.eps_reg2 = 0.0
        self.epsilon_nuH = 0.0

    # closed-form fields (0-dim float64 tensors, or numpy arrays) ----------
    def u(self, x, y):
        return self.U0 * torch.sin(self.k * x) * torch.cos(self.k * y)

    def v(self, x, y):
        return self.V0 * torch.cos(self.k * x) * torch.sin(self.k * y)

    def H(self, x, y):
        return self.H0 + self.H1 * torch.cos(self.k * x) * torch.cos(self.k * y)

    # continuous operator ---------------------------------------------------
    def _stress(self, x, y):
        grad = torch.func.grad
        ux = grad(self.u, 0)(x, y)
        uy = grad(self.u, 1)(x, y)
        vx = grad(self.v, 0)(x, y)
        vy = grad(self.v, 1)(x, y)
        eps2 = ux ** 2 + vy ** 2 + ux * vy + 0.25 * (uy + vx) ** 2 \
            + self.eps_reg2
        nu = 0.5 * self.B * eps2 ** ((1.0 - self.n) / (2.0 * self.n))
        nuH = nu * self.H(x, y) + self.epsilon_nuH
        Txx = nuH * (4.0 * ux + 2.0 * vy)
        Tyy = nuH * (4.0 * vy + 2.0 * ux)
        Txy = nuH * (uy + vx)
        return Txx, Txy, Tyy

    def _taud_point(self, x, y):
        grad = torch.func.grad
        dTxx_dx = grad(lambda a, b_: self._stress(a, b_)[0], 0)(x, y)
        dTxy_dy = grad(lambda a, b_: self._stress(a, b_)[1], 1)(x, y)
        dTxy_dx = grad(lambda a, b_: self._stress(a, b_)[1], 0)(x, y)
        dTyy_dy = grad(lambda a, b_: self._stress(a, b_)[2], 1)(x, y)
        fx = -(dTxx_dx + dTxy_dy) + self.beta * self.u(x, y)
        fy = -(dTxy_dx + dTyy_dy) + self.beta * self.v(x, y)
        return torch.stack((fx, fy))

    def taud(self, X, Y):
        """Compensatory driving stress (what the discrete b must be) at the
        points (X, Y) (numpy arrays of one shape): (fx, fy) as numpy
        float64 arrays."""
        X = torch.as_tensor(np.asarray(X, float), dtype=torch.float64)
        Y = torch.as_tensor(np.asarray(Y, float), dtype=torch.float64)
        f = torch.func.vmap(self._taud_point)(X.reshape(-1), Y.reshape(-1))
        return (f[:, 0].reshape(X.shape).numpy(),
                f[:, 1].reshape(X.shape).numpy())

    # discrete solve ----------------------------------------------------------
    def config(self, overrides=None):
        """The solve's config: linear pseudo-plastic drag, the multigrid
        preconditioner and a Schoof regularization comparable to the
        typical strain rate (the manufactured strain field passes through
        zeros, where the production-tiny regularization spikes the Glen
        viscosity; the continuous form takes the same value, so this still
        verifies the discretization exactly)."""
        from ..config import Config
        cfg = Config({
            "basal_resistance.pseudo_plastic.enabled": True,
            "basal_resistance.pseudo_plastic.q": 1.0,
            "basal_resistance.pseudo_plastic.u_threshold":
                self.u_threshold * SPY,
            "stress_balance.ssa.fd.preconditioner": "mg",
            "stress_balance.ssa.Schoof_regularizing_velocity": 100.0,  # m/a
            "stress_balance.ssa.Schoof_regularizing_length": 100.0,    # km
        })
        if overrides:
            cfg.update(overrides)
        return cfg

    def solve_on(self, Mx, device="cuda", diagnostics=False, config=None):
        """Solve the discrete SSA on an Mx x Mx periodic grid on ``device``;
        return (max_error [m/s], grid), and the solve's diagnostics with
        ``diagnostics``. ``config``: overrides of ``config()``'s values."""
        from ..grid import Grid
        from ..model.ssa import SSAFD
        from ..physics.rheology import IsothermalGlen
        from ..state import ModelState, new_geometry

        grid = Grid(Mx=Mx, My=Mx, Lx=self.L, Ly=self.L, periodicity="xy")
        cfg = self.config(config)
        # match the solver's regularizations and the grid's wrap period
        svel = cfg.get_number("stress_balance.ssa.Schoof_regularizing_velocity",
                              "m s-1")
        slen = cfg.get_number("stress_balance.ssa.Schoof_regularizing_length",
                              "m")
        self.eps_reg2 = (svel / slen) ** 2
        self.epsilon_nuH = cfg.get_number("stress_balance.ssa.epsilon")
        self.k = 4.0 * math.pi / (Mx * grid.dx)   # two periods per wrap

        X, Y = np.meshgrid(grid.x, grid.y)
        fx, fy = self.taud(X, Y)
        Xt = torch.as_tensor(X, dtype=torch.float64)
        Yt = torch.as_tensor(Y, dtype=torch.float64)

        def field(a):
            return torch.as_tensor(a, dtype=torch.float64, device=device)

        H = field(self.H(Xt, Yt))
        geom = new_geometry(H, torch.zeros_like(H))   # grounded, bed = 0
        ssa = SSAFD(grid=grid, config=cfg, flow_law=IsothermalGlen(A=self.A),
                    taud_x=field(fx), taud_y=field(fy))
        u, v, info = ssa.solve(ModelState(geometry=geom),
                               torch.full_like(H, self.tau_c),
                               diagnostics=True)
        u_ex, v_ex = field(self.u(Xt, Yt)), field(self.v(Xt, Yt))
        err = float(torch.maximum((u - u_ex).abs().max(),
                                  (v - v_ex).abs().max()))
        return (err, grid, info) if diagnostics else (err, grid)
