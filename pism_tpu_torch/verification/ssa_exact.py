"""Exact solutions for SSA verification: tests I, V, M and N (port of
``pism_tpu/verification/ssa_exact.py``, numpy only).

Test I — plastic-till ice stream (Schoof 2006; PISM ``pismv -test I``,
reference implementation ``src/verification/tests/exactTestsIJ.c`` — not
copied; re-derived below from the flowline force balance):

Uniform thickness H0 and hardness B, constant driving stress f = rho g H0 a
in +x, till yield stress tau_c(y) = f |y/L|^m. Cross-flow force balance
    d/dy [ B H0 2^(-1/n) |u_y|^(1/n - 1) u_y ] = tau_c(y) - f
integrated twice with symmetry (T(0) = 0) and margin conditions
u(y0) = u_y(y0) = 0 at y0 = L (m+1)^(1/m) gives, with C = B H0 2^(-1/n),
a = 1 / ((m+1) L^m), and n = 3:

    u(y) = (f/C)^3 [ F(y0) - F(|y|) ],
    F(y) = y^4/4 - 3 a y^(m+4)/(m+4) + 3 a^2 y^(2m+4)/(2m+4)
           - a^3 y^(3m+4)/(3m+4).

Test J's role is taken by the manufactured periodic shelf of
``ssa_manufactured.py``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: PISM test I parameters (Bueler & Brown 2009)
M_SCHOOF = 10.0
L_SCHOOF = 40.0e3        # m
H0 = 2000.0              # m
B_HARDNESS = 3.7e8       # Pa s^(1/3)
SLOPE = 0.001            # surface slope magnitude (downhill +x)
RHO = 910.0
G = 9.81
N_GLEN = 3.0


@dataclass(frozen=True)
class ExactI:
    m: float = M_SCHOOF
    L: float = L_SCHOOF
    H0: float = H0
    B: float = B_HARDNESS
    slope: float = SLOPE

    @property
    def f(self) -> float:
        """Driving stress magnitude [Pa]."""
        return RHO * G * self.H0 * self.slope

    @property
    def y0(self) -> float:
        """Stream half-width (where tau_c grows past f)."""
        return self.L * (self.m + 1.0) ** (1.0 / self.m)

    def tau_c(self, y) -> np.ndarray:
        return self.f * np.abs(np.asarray(y) / self.L) ** self.m

    def velocity(self, y) -> np.ndarray:
        """Exact u(y) [m/s] (v = 0)."""
        m, L = self.m, self.L
        C = self.B * self.H0 * 2.0 ** (-1.0 / N_GLEN)
        a = 1.0 / ((m + 1.0) * L ** m)

        def F(yy):
            return (yy ** 4 / 4.0
                    - 3.0 * a * yy ** (m + 4.0) / (m + 4.0)
                    + 3.0 * a ** 2 * yy ** (2.0 * m + 4.0) / (2.0 * m + 4.0)
                    - a ** 3 * yy ** (3.0 * m + 4.0) / (3.0 * m + 4.0))

        yy = np.minimum(np.abs(np.asarray(y, float)), self.y0)
        u = (self.f / C) ** 3 * (F(self.y0) - F(yy))
        return np.maximum(u, 0.0)


@dataclass(frozen=True)
class ExactV:
    """Test V — van der Veen (1985) unconfined flowline ice shelf
    (PISM ``pismv -test V``; reference ``src/verification/tests/exactTestV``
    role — re-derived from the closed form, the reference mount was empty):

    A floating shelf fed at x = 0 with velocity u0 and thickness H0.
    Steady mass conservation d(uH)/dx = 0 gives uH = q0 = u0 H0; the
    flowline SSA with zero basal drag and the calving-front condition
    satisfied everywhere reduces to

        du/dx = C H^n,   C = [ rho_i g (1 - rho_i/rho_w) / (4 B) ]^n

    (B = hardness). With H = q0/u, u^n du = C q0^n dx integrates to

        u(x) = [ u0^(n+1) + (n+1) C q0^n x ]^(1/(n+1)),   H(x) = q0/u(x).

    Because the analytic profile satisfies the front condition exactly,
    the discrete front position may be placed anywhere downstream; the
    numerical CFBC error shows up as a deviation of u near the front.
    """

    u0: float = 300.0 / 3.15569259747e7   # m/s inflow velocity
    H0v: float = 600.0                    # m inflow thickness
    B: float = 1.9e8                      # Pa s^(1/3) (cold shelf hardness)
    rho_i: float = RHO
    rho_w: float = 1028.0
    n: float = N_GLEN

    @property
    def C(self) -> float:
        return (self.rho_i * G * (1.0 - self.rho_i / self.rho_w)
                / (4.0 * self.B)) ** self.n

    def velocity(self, x) -> np.ndarray:
        q0 = self.u0 * self.H0v
        np1 = self.n + 1.0
        return (self.u0 ** np1 + np1 * self.C * q0 ** self.n
                * np.asarray(x, float)) ** (1.0 / np1)

    def thickness(self, x) -> np.ndarray:
        return self.u0 * self.H0v / self.velocity(x)


@dataclass(frozen=True)
class ExactM:
    """Test M — annular ice shelf with radial flow (PISM ``pismv -test M``
    role; the reference solves the same radial ODE numerically with GSL in
    ``src/verification/tests/exactTestM.c``. Re-derived here: the mount was
    empty, and the ODE below follows from the polar-coordinate SSA).

    A flat floating annulus Rg <= r <= Rc of constant thickness H0 (zero
    driving stress), velocity prescribed at the inner (grounding-line)
    ring, calving-front stress condition at the outer edge. With purely
    radial u(r): e_rr = u', e_tt = u/r,

        d/dr T_rr + (T_rr - T_tt)/r = 0,
        T_rr = 2 nu H (2 u' + u/r),  T_tt = 2 nu H (u' + 2 u/r),
        nu = (B/2) (e_rr^2 + e_tt^2 + e_rr e_tt)^((1-n)/(2n)),

    front condition T_rr(Rc) = 0.5 rho_i g (1 - rho_i/rho_w) H0^2.
    Solved by RK4 + shooting on u'(Rg); the partials of T_rr are
    written out (the JAX package takes them by autodiff).
    """

    Rg: float = 300.0e3
    Rc: float = 600.0e3
    H0m: float = 500.0
    u0: float = 300.0 / 3.15569259747e7   # m/s at r = Rg
    B: float = 1.9e8                      # Pa s^(1/3)
    rho_i: float = RHO
    rho_w: float = 1028.0
    n: float = N_GLEN

    def _T_rr(self, u, up, r):
        """T_rr(u, u', r) and its partials d/du, d/du', d/dr, written out
        (the JAX package takes them with jax.grad)."""
        B, H, nn = self.B, self.H0m, self.n
        p = (1.0 - nn) / (2.0 * nn)
        ett = u / r
        P = up ** 2 + ett ** 2 + up * ett + 1e-40
        nu = 0.5 * B * P ** p
        S = 2.0 * up + ett
        T = 2.0 * nu * H * S
        dnu_dP = 0.5 * B * p * P ** (p - 1.0)
        dP_dett = 2.0 * ett + up
        dett_dr = -u / (r * r)
        dP_du = dP_dett / r
        dP_dup = 2.0 * up + ett
        dP_dr = dP_dett * dett_dr
        dT_du = 2.0 * H * (dnu_dP * dP_du * S + nu / r)
        dT_dup = 2.0 * H * (dnu_dP * dP_dup * S + nu * 2.0)
        dT_dr = 2.0 * H * (dnu_dP * dP_dr * S + nu * dett_dr)
        return T, dT_du, dT_dup, dT_dr

    def _upp(self, u, up, r):
        B, H, nn = self.B, self.H0m, self.n
        err, ett = up, u / r
        P = err ** 2 + ett ** 2 + err * ett + 1e-40
        nu = 0.5 * B * P ** ((1.0 - nn) / (2.0 * nn))
        rhs = -2.0 * nu * H * (up - u / r) / r
        _, d_u, d_up, d_r = self._T_rr(u, up, r)
        return (rhs - d_u * up - d_r) / d_up

    def _solve_ode(self, nr: int = 2000):
        """RK4 over nr steps from Rg with u(Rg) = u0, shooting on u'(Rg) by
        80 bisections to the front condition; Python floats (a scalar
        recurrence)."""
        dr = (self.Rc - self.Rg) / nr
        rs = self.Rg + dr * np.arange(nr)
        rs_f = [float(r) for r in rs]
        upp = self._upp

        def integrate(up0, keep=False):
            u, up = self.u0, up0
            us = []
            for r in rs_f:
                k1u, k1p = up, upp(u, up, r)
                k2u = up + 0.5 * dr * k1p
                k2p = upp(u + 0.5 * dr * k1u, k2u, r + 0.5 * dr)
                k3u = up + 0.5 * dr * k2p
                k3p = upp(u + 0.5 * dr * k2u, k3u, r + 0.5 * dr)
                k4u = up + dr * k3p
                k4p = upp(u + dr * k3u, k4u, r + dr)
                u = u + dr / 6.0 * (k1u + 2 * k2u + 2 * k3u + k4u)
                up = up + dr / 6.0 * (k1p + 2 * k2p + 2 * k3p + k4p)
                if keep:
                    us.append(u)
            return u, up, us

        target = 0.5 * self.rho_i * G * (1.0 - self.rho_i / self.rho_w) \
            * self.H0m ** 2

        def front_residual(up0):
            uc, upc, _ = integrate(up0)
            return self._T_rr(uc, upc, self.Rc)[0] - target

        # bracket and bisect on u'(Rg)
        scale = self.u0 / self.Rg
        lo, hi = 0.0, scale
        while front_residual(hi) < 0.0:
            hi *= 2.0
            if hi > 1e6 * scale:
                raise RuntimeError("test M shooting failed to bracket")
        for _ in range(80):
            mid = 0.5 * (lo + hi)
            if front_residual(mid) < 0.0:
                lo = mid
            else:
                hi = mid
        up0 = 0.5 * (lo + hi)
        _, _, us = integrate(up0, keep=True)
        r_grid = np.concatenate([[self.Rg], rs + dr])
        u_grid = np.concatenate([[self.u0], np.asarray(us)])
        return r_grid, u_grid

    def velocity(self, r) -> np.ndarray:
        """Radial velocity u(r) [m/s]; clamped to u0 inside Rg and
        extrapolated flat outside Rc."""
        if not hasattr(self, "_cache"):
            object.__setattr__(self, "_cache", self._solve_ode())
        rg, ug = self._cache
        return np.interp(np.asarray(r, float), rg, ug,
                         left=self.u0, right=ug[-1])


@dataclass(frozen=True)
class ExactN:
    """Test N — steady, grounded, plastic-till marine ice stream ending in
    a calving front (PISM ``exactTestN`` role, the Bodvardsson (1955) /
    Bueler (2014, J. Glaciol. 60(222)) flowline solution; reference
    ``src/verification/tests/exactTestN.c`` — not read, the mount was
    empty. Re-derived from scratch below, so the constants differ from
    the reference's but the construction is the same).

    A symmetric ice stream on a flat bed b = -depth (grounded everywhere,
    sea level 0) with the Bodvardsson parabolic profile

        H(x) = H0 (1 - (x/L0)^2),   |x| <= xc < L0,

    and linear velocity u(x) = gamma x (so u_x = gamma is constant and
    the Glen effective viscosity nu = B/2 |u_x|^(1/n-1) is uniform; this
    is what makes the solution exact for ANY n). The spreading rate is
    fixed by the calving-front force balance at x = xc with water depth
    ``depth``:

        2 B H_c gamma^(1/n) = 1/2 g (rho H_c^2 - rho_w depth^2)
        =>  gamma = [ g (rho H_c^2 - rho_w depth^2) / (4 B H_c) ]^n.

    The flowline SSA momentum balance  d/dx(2 B H |u_x|^(1/n-1) u_x)
    - tau_b = rho g H ds/dx  with s_x = H_x (flat bed) then pins the
    plastic till yield stress that balances it exactly:

        tau_c(x) = H_x(x) (2 B gamma^(1/n) - rho g H(x))  >= 0.

    Mass continuity d(uH)/dx = a gives the compensatory surface mass
    balance  a(x) = gamma H0 (1 - 3 (x/L0)^2)  (accumulation inland,
    ablation toward the front), reported by :meth:`smb` for steady-state
    evolution experiments.
    """

    H0n: float = 1200.0        # m, divide thickness
    L0: float = 400.0e3        # m, profile half-length (H -> 0 there)
    xc_frac: float = 0.9       # calving front at xc = xc_frac * L0
    depth: float = 180.0       # m, water depth (bed at -depth, sl = 0)
    B: float = 1.9e8           # Pa s^(1/3), uniform hardness
    rho_i: float = RHO
    rho_w: float = 1028.0
    n: float = N_GLEN

    @property
    def xc(self) -> float:
        return self.xc_frac * self.L0

    @property
    def Hc(self) -> float:
        """Front thickness; must exceed flotation rho_w/rho_i * depth."""
        return self.H0n * (1.0 - self.xc_frac ** 2)

    @property
    def gamma(self) -> float:
        """Uniform spreading rate du/dx [1/s] from the front condition."""
        num = G * (self.rho_i * self.Hc ** 2 - self.rho_w * self.depth ** 2)
        return (num / (4.0 * self.B * self.Hc)) ** self.n

    def thickness(self, x) -> np.ndarray:
        xa = np.abs(np.asarray(x, float))
        return np.where(xa <= self.xc,
                        self.H0n * (1.0 - (xa / self.L0) ** 2), 0.0)

    def velocity(self, x) -> np.ndarray:
        """u(x) [m/s], odd in x (v = 0)."""
        xa = np.asarray(x, float)
        return np.where(np.abs(xa) <= self.xc, self.gamma * xa, 0.0)

    def tau_c(self, x) -> np.ndarray:
        """Plastic till yield stress [Pa] making the solution exact."""
        xa = np.abs(np.asarray(x, float))
        H_x = -2.0 * self.H0n * xa / self.L0 ** 2
        tc = H_x * (2.0 * self.B * self.gamma ** (1.0 / self.n)
                    - self.rho_i * G * self.thickness(xa))
        return np.where(xa <= self.xc, np.maximum(tc, 0.0), 0.0)

    def smb(self, x) -> np.ndarray:
        """Compensatory steady surface mass balance a(x) [m/s]."""
        xa = np.abs(np.asarray(x, float))
        return np.where(xa <= self.xc,
                        self.gamma * self.H0n
                        * (1.0 - 3.0 * (xa / self.L0) ** 2), 0.0)
