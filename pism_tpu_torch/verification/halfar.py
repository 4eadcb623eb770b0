"""Exact similarity solutions for isothermal SIA (verification tests B, C).

A copy of ``pism_tpu/verification/halfar.py`` (numpy only).

Re-derivation of the Halfar (1983) and Bueler et al. (2005) similarity
solutions used by PISM's verification suite (``pismv`` tests B and C;
reference implementation ``src/verification/tests/exactTestsABCD.c`` — code
not copied; formulas re-derived from the published scaling relations).

General form (Glen exponent n):
    H(t, r) = H0 (t/t0)^(-alpha) * f(xi),  xi = (t/t0)^(-beta) r / R0,
    f(xi) = (1 - xi^((n+1)/n))^(n/(2n+1)),
with accumulation M = (lambda/t) H, and
    alpha = (2 - (n+1) lambda) / (5n + 3),
    beta  = (1 + (2n+1) lambda) / (5n + 3),
    t0    = (beta / Gamma) * ((2n+1)/(n+1))^n * R0^(n+1) / H0^(2n+1),
    Gamma = 2 A (rho g)^n / (n + 2).

Test B: lambda = 0 (zero accumulation; pure Halfar decay).
Test C: lambda = 5 (growing dome; M = 5 H / t).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..util.units import SEC_PER_YEAR

#: softness used by tests A-D (1e-16 Pa^-3 a^-1 in SI)
A_SOFTNESS = 1.0e-16 / SEC_PER_YEAR
RHO_ICE = 910.0
GRAVITY = 9.81
GLEN_N = 3.0


def gamma(A: float = A_SOFTNESS, n: float = GLEN_N, rho: float = RHO_ICE,
          g: float = GRAVITY) -> float:
    return 2.0 * A * (rho * g) ** n / (n + 2.0)


@dataclass(frozen=True)
class SimilaritySolution:
    """H(t, r) for the lambda-family of isothermal SIA similarity solutions."""

    H0: float = 3600.0
    R0: float = 750.0e3
    lam: float = 0.0
    n: float = GLEN_N
    A: float = A_SOFTNESS

    @property
    def alpha(self) -> float:
        return (2.0 - (self.n + 1.0) * self.lam) / (5.0 * self.n + 3.0)

    @property
    def beta(self) -> float:
        return (1.0 + (2.0 * self.n + 1.0) * self.lam) / (5.0 * self.n + 3.0)

    @property
    def t0(self) -> float:
        n = self.n
        G = gamma(self.A, n)
        return (self.beta / G) * ((2.0 * n + 1.0) / (n + 1.0)) ** n \
            * self.R0 ** (n + 1.0) / self.H0 ** (2.0 * n + 1.0)

    def thickness(self, t: float, r: np.ndarray) -> np.ndarray:
        """Exact H at time t [s] and radius r [m]."""
        n = self.n
        s = t / self.t0
        xi = s ** (-self.beta) * np.asarray(r) / self.R0
        inner = np.maximum(1.0 - xi ** ((n + 1.0) / n), 0.0)
        return self.H0 * s ** (-self.alpha) * inner ** (n / (2.0 * n + 1.0))

    def accumulation(self, t: float, H: np.ndarray):
        """M(t, r) = (lam / t) * H  [m/s]."""
        return (self.lam / t) * H

    def margin_radius(self, t: float) -> float:
        return self.R0 * (t / self.t0) ** self.beta


def test_B() -> SimilaritySolution:
    """Halfar dome, zero accumulation. t0 ~ 422.45 years."""
    return SimilaritySolution(H0=3600.0, R0=750.0e3, lam=0.0)


def test_C() -> SimilaritySolution:
    """Growing dome with M = 5 H / t. t0 ~ 15208 years."""
    return SimilaritySolution(H0=3600.0, R0=750.0e3, lam=5.0)


def error_norms(H_num: np.ndarray, H_exact: np.ndarray) -> dict:
    """PISM-style thickness error report (``IceCompModel::reportErrors``)."""
    d = np.abs(np.asarray(H_num) - H_exact)
    icy = (H_num > 0) | (H_exact > 0)
    dome = np.unravel_index(np.argmax(H_exact), H_exact.shape)
    area = max(int(np.sum(icy)), 1)
    return {
        "max_H": float(np.max(d)),
        "avg_H": float(np.sum(d * icy) / area),
        "dome_H": float(d[dome]),
        "rel_volume": float(abs(H_num.sum() - H_exact.sum()) / max(H_exact.sum(), 1e-30)),
    }
