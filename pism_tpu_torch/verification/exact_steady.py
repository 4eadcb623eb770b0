"""Exact steady and quasi-steady isothermal SIA solutions of verification
tests A, D, H and L (port of ``pism_tpu/verification/exact_steady.py``;
test E's sliding cap needs ``prescribed_sliding`` and is not ported).

* Test A: steady cap with constant accumulation ``M0`` inside a fixed
  margin ``r = L`` (ice beyond ``L`` is removed by ocean-kill calving):

      H(r)^{(2n+2)/n} = 2 (M0 / (2 Gamma))^{1/n} (L^{(n+1)/n} - r^{(n+1)/n}).

* Test D: the test-A profile plus an oscillating annular bump, with the
  compensatory accumulation ``M_c = dH/dt + div(q(H))`` taken by automatic
  differentiation of the exact radial profile (``torch.func`` here, JAX's
  autodiff in the reference; both are exact to rounding).

* Test H: the lambda-family similarity solution over a bed ``b = -f H``
  (pointwise isostasy, ``f = rho_i / rho_r``), with softness
  ``A (1 - f)^n``.

* Test L: a steady cap over the bed ``b0 cos(pi r / L)``, its exact
  profile from the ODE ``dw/dr = -(8/3) [w^{5/8} b'(r) + (q/Gamma)^{1/3}]``,
  ``w = H^{8/3}``, integrated inward from ``w(L) = 0``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..util.units import SEC_PER_YEAR
from .halfar import A_SOFTNESS, GLEN_N, RHO_ICE, SimilaritySolution, gamma


# ---------------------------------------------------------------- test A

@dataclass(frozen=True)
class SteadyCap:
    """Steady ice cap with constant accumulation M0 inside margin L."""

    M0: float = 0.3 / SEC_PER_YEAR     # m/s ice-equivalent
    L: float = 750.0e3                 # margin radius [m]
    n: float = GLEN_N
    A: float = A_SOFTNESS

    def thickness(self, r):
        r = np.abs(np.asarray(r, dtype=np.float64))
        n = self.n
        G = gamma(self.A, n)
        p = (n + 1.0) / n
        inner = 2.0 * (self.M0 / (2.0 * G)) ** (1.0 / n) * \
            np.maximum(self.L ** p - r ** p, 0.0)
        return inner ** (n / (2.0 * n + 2.0))

    def accumulation(self, r):
        """M0 inside the margin; 0 outside (ice there is killed instead)."""
        r = np.abs(np.asarray(r, dtype=np.float64))
        return np.where(r < self.L, self.M0, 0.0)


def test_A() -> SteadyCap:
    return SteadyCap()


# ---------------------------------------------------------------- test H

@dataclass(frozen=True)
class IsostasySimilarity:
    """Test H: lambda-family similarity solution with bed b = -f H."""

    f: float = RHO_ICE / 3300.0
    lam: float = 5.0
    H0: float = 3600.0
    R0: float = 750.0e3

    @property
    def flat(self) -> SimilaritySolution:
        A_eff = A_SOFTNESS * (1.0 - self.f) ** GLEN_N
        return SimilaritySolution(H0=self.H0, R0=self.R0, lam=self.lam,
                                  A=A_eff)

    def thickness(self, t, r):
        return self.flat.thickness(t, r)

    def bed(self, t, r):
        return -self.f * self.thickness(t, r)


def test_H() -> IsostasySimilarity:
    return IsostasySimilarity()


# ---------------------------------------------------------------- test L role

@dataclass(frozen=True)
class SteadyCapOnBed:
    """Steady cap over the smooth radial bed b0 cos(pi r / L) with constant
    accumulation M0; exact H from an adaptive ODE solve."""

    M0: float = 0.3 / SEC_PER_YEAR
    L: float = 750.0e3
    b0: float = 500.0
    n: float = GLEN_N

    def bed(self, r):
        r = np.abs(np.asarray(r, dtype=np.float64))
        return self.b0 * np.cos(np.pi * r / self.L)

    def bed_slope(self, r):
        r = np.abs(np.asarray(r, dtype=np.float64))
        return -self.b0 * np.pi / self.L * np.sin(np.pi * r / self.L)

    def flux(self, r):
        """Steady flux q(r) = M0 r / 2 (per unit arc length)."""
        return self.M0 * np.abs(np.asarray(r, dtype=np.float64)) / 2.0

    def solve(self, r_eval) -> np.ndarray:
        """Exact steady thickness at radii ``r_eval`` via the w=H^{8/3} ODE."""
        from scipy.integrate import solve_ivp

        G = gamma(A_SOFTNESS, self.n)

        def rhs(r, w):
            w0 = max(w[0], 0.0)
            H53 = w0 ** (5.0 / 8.0)
            return [-(8.0 / 3.0) * (H53 * self.bed_slope(r)
                                    + (self.flux(r) / G) ** (1.0 / 3.0))]

        r_lo = 1.0e3
        sol = solve_ivp(rhs, (self.L, r_lo), [0.0], rtol=1e-10, atol=1e-8,
                        dense_output=True, method="RK45")
        if not sol.success:
            raise RuntimeError(f"test L ODE failed: {sol.message}")
        r = np.abs(np.asarray(r_eval, dtype=np.float64))
        w_flat = sol.sol(np.clip(r.ravel(), r_lo, self.L))[0]
        w = np.where(r <= r_lo, sol.y[0][-1],
                     np.where(r >= self.L, 0.0, w_flat.reshape(r.shape)))
        return np.maximum(w, 0.0) ** (3.0 / 8.0)


def test_L() -> SteadyCapOnBed:
    return SteadyCapOnBed()


# ---------------------------------------------------------------- test D

def make_test_D(Cp: float = 200.0, Tp: float = 5000.0 * SEC_PER_YEAR,
                Rc: float = 450.0e3, W: float = 300.0e3):
    """Test D: oscillating annular perturbation with compensatory source.

    Returns ``(H_exact, M_comp)``. Both take ``(t, r)``: ``t`` in seconds,
    ``r`` radii. ``M_comp`` takes a float64 tensor of radii and returns a
    tensor on its device; ``H_exact`` takes numpy and returns numpy."""
    cap = SteadyCap()
    n = cap.n
    G = gamma(cap.A, n)
    p = (n + 1.0) / n

    def H_of(t, r):
        inner = 2.0 * (cap.M0 / (2.0 * G)) ** (1.0 / n) * \
            torch.clamp(cap.L ** p - r ** p, min=0.0)
        Hs = inner ** (n / (2.0 * n + 2.0))
        x = (r - Rc) / W
        bump = torch.where(torch.abs(x) < 0.5,
                           torch.cos(math.pi * x) ** 2, 0.0)
        return Hs + Cp * torch.sin(2.0 * math.pi * t / Tp) * bump

    dH_dt = torch.func.grad(H_of, argnums=0)
    dH_dr = torch.func.grad(H_of, argnums=1)

    def rq(t, r):
        H = H_of(t, r)
        s = dH_dr(t, r)
        return r * G * H ** (n + 2.0) * torch.abs(s) ** (n - 1.0) * (-s)

    drq_dr = torch.func.grad(rq, argnums=1)

    def M_point(t, r):
        return dH_dt(t, r) + drq_dr(t, r) / r

    M_v = torch.func.vmap(M_point, in_dims=(None, 0))

    def M_comp(t, r):
        """Compensatory accumulation on a float64 tensor of radii."""
        ra = torch.clamp(torch.abs(r.to(torch.float64)), min=1.0)
        tt = torch.tensor(float(t), dtype=torch.float64, device=ra.device)
        out = M_v(tt, ra.reshape(-1)).reshape(ra.shape)
        # outside the margin the exact profile is 0; no compensation there
        return torch.where(ra < 0.999 * cap.L, out, 0.0)

    def H_exact(t, r):
        ra = np.maximum(np.abs(np.asarray(r, dtype=np.float64)), 1.0)
        return H_of(torch.tensor(float(t), dtype=torch.float64),
                    torch.from_numpy(ra)).numpy()

    return H_exact, M_comp
