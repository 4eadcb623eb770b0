"""Blatter-Pattyn 3D first-order stress balance (port of
``pism_tpu/model/blatter.py`` ``BlatterSolver``).

The equations are discretized in the terrain-following coordinate
zeta = z_above_base / H on the (My, Mx, Mz) grid and solved matrix-free:

  d/dx(4 nu u_x + 2 nu v_y) + d/dy(nu (u_y + v_x))
      + d/dz(nu u_z) = rho g s_x          (x-momentum, per unit volume)

with nu = (B/2)(eps^2 + reg)^((1-n)/(2n)),
eps^2 = u_x^2 + v_y^2 + u_x v_y + 1/4 (u_y+v_x)^2 + 1/4 u_z^2 + 1/4 v_z^2.
Horizontal derivatives at constant z carry the sigma-coordinate metric
terms zeta_x = -(b_x + zeta H_x)/H (b the ice base), in the strain rates
and in the stress divergence. The surface is stress-free, the base slides
with nu u_z = beta u (beta from the SSA's sliding laws), ice-free columns
are Dirichlet zero, and with ``stress_balance.calving_front_stress_bc`` the
faces between icy and ice-free-ocean cells take the depth-varying
hydrostatic imbalance rho_i g (s - z) - rho_w g max(sl - z, 0) as their
normal stress.

Everything is computed in float64 whatever the fields' dtype, as in the JAX
package. The solve: Newton sweeps with the exact Jacobian, BiCGStab
(``ops/ssa.py``) and a vertical-line
preconditioner: (diag_h + d/dz nu d/dz) of each column solved by the
Thomas algorithm, factored once a sweep (``ColumnThomas``), the u and v
columns in one batch. The line search evaluates the five step lengths'
residuals and keeps the first with the least |F|^2; the loop's stop test
reads one flag a sweep. A Thomas application is a host loop of 2 Mz steps
over whole (My, Mx) planes. On the card the Krylov loop's matvec and
preconditioner each replay one CUDA graph captured once a sweep
(``util/cudagraph.py``).

The Jacobian is written out (``linearized``), where the JAX package takes
``jax.linearize`` of the residual: the residual is A(nu(u)) u + drag +
load with A bilinear in (nu, u), so J d = A(nu) d + A(dnu(d)) u + drag(d),
the sweep's strain rates, viscosities and their derivative's factor
computed once. beta is frozen at the sweep's iterate (the JAX package's
``stop_gradient``). ``torch.func.jvp`` carries dual tensors through the
whole residual at every call and ``torch.func.linearize`` traces it once
a sweep; both cost far more host time than this map.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import state as S
from ..ops import ssa as ssa_ops
from ..ops import stencils as st
from ..ops.stencils import Shifter
from ..physics.basal import SlidingLaw
from ..util.cudagraph import graphed
from ..util.hostsync import host

SEC_PER_YEAR = 3.15569259747e7
F64 = torch.float64


class ColumnThomas:
    """The Thomas algorithm for batched column systems a x[k-1] + b x[k] +
    c x[k+1] = d with z last, factored once: the moved coefficient planes
    and the forward sweep's denominators and c' (``util/tridiag.py``
    ``solve_batched_thomas`` recomputes them at every call). ``solve``
    takes right-hand sides of shape (..., My, Mx, Mz) with any leading
    batch dims and rounds as that function does."""

    def __init__(self, a, b, c):
        am, bm, cm = (x.movedim(-1, 0).contiguous() for x in (a, b, c))
        n = bm.shape[0]
        self.a = [am[k] if k > 0 else torch.zeros_like(am[0]) for k in range(n)]
        self.den, self.cp = [], []
        cp = torch.zeros_like(bm[0])
        for k in range(n):
            den = bm[k] - self.a[k] * cp
            ck = cm[k] if k < n - 1 else torch.zeros_like(cm[0])
            cp = ck / den
            self.den.append(den)
            self.cp.append(cp)

    def solve(self, d):
        dm = d.movedim(-1, 0).contiguous()
        n = dm.shape[0]
        dps = []
        dp = torch.zeros_like(dm[0])
        for k in range(n):
            dp = (dm[k] - self.a[k] * dp) / self.den[k]
            dps.append(dp)
        xs = [None] * n
        x = torch.zeros_like(dm[0])
        for k in range(n - 1, -1, -1):
            x = dps[k] - self.cp[k] * x
            xs[k] = x
        return torch.stack(xs, dim=-1)


@dataclass
class BlatterSolver:
    grid: object
    config: object
    flow_law: object
    sliding_law: Optional[SlidingLaw] = None
    taud_x: Optional[torch.Tensor] = None   # prescribed driving stress
    taud_y: Optional[torch.Tensor] = None
    body_force_x: Optional[torch.Tensor] = None  # 3D per-volume force [Pa/m]
    body_force_y: Optional[torch.Tensor] = None  # (manufactured solutions)
    # 2D zero-velocity Dirichlet columns (stress crosses their faces, unlike
    # ice-free cells, which are decoupled)
    bc_mask: Optional[torch.Tensor] = None

    def __post_init__(self):
        cfg = self.config
        self.sh = Shifter(self.grid)
        # the exponent inherits the SSA's unless the Blatter key is set
        if cfg.is_set("stress_balance.blatter.Glen_exponent"):
            self.n_glen = cfg.get_number("stress_balance.blatter.Glen_exponent")
        else:
            self.n_glen = cfg.get_number("stress_balance.ssa.Glen_exponent")
        self.rho = cfg.get_number("constants.ice.density")
        self.g = cfg.get_number("constants.standard_gravity")
        self.ksp_rtol = cfg.get_number("stress_balance.ssa.fd.ksp_rtol")
        self.ksp_max = cfg.get_int("stress_balance.ssa.fd.ksp_max_it")
        # the Blatter solver's own knobs win when set, else the ssa.fd ones
        self.newton_max = cfg.get_int(
            "stress_balance.blatter.newton_max_iterations"
            if cfg.is_set("stress_balance.blatter.newton_max_iterations")
            else "stress_balance.ssa.fd.newton_max_iterations")
        self.newton_rtol = cfg.get_number(
            "stress_balance.blatter.newton_rtol"
            if cfg.is_set("stress_balance.blatter.newton_rtol")
            else "stress_balance.ssa.fd.newton_rtol")
        svel = cfg.get_number(
            "stress_balance.ssa.Schoof_regularizing_velocity", "m s-1")
        slen = cfg.get_number(
            "stress_balance.ssa.Schoof_regularizing_length", "m")
        self.eps_reg2 = (svel / slen) ** 2
        self.beta_floor = cfg.get_number("stress_balance.ssa.fd.beta_floor")
        self.cfbc = cfg.get_flag("stress_balance.calving_front_stress_bc")
        self.metric_terms = cfg.get_flag("stress_balance.blatter.metric_terms")
        self.rho_w = cfg.get_number("constants.sea_water.density")
        # softness scales by e, hardness by e^(-1/n)
        self.e_factor = cfg.get_number(
            "stress_balance.blatter.enhancement_factor")
        if self.sliding_law is None:
            self.sliding_law = SlidingLaw.from_config(cfg)
        # normalized vertical coordinate of the ice levels
        z = np.asarray(self.grid.z)
        self.zeta = z / max(z[-1], 1.0)
        self.dzeta = np.diff(self.zeta)

    # ------------------------------------------------------------------
    def solve(self, state: S.ModelState, tau_c=None, u0=None, v0=None,
              diagnostics: bool = False, full_output: bool = False):
        """(u, v) on the zeta levels, float64. ``diagnostics``: (u, v, info)
        with the Newton sweeps and the BiCGStab iterations (host ints),
        |F|^2, its tolerance, and as functions of an iterate the residual,
        the Jacobian's product with a direction and the preconditioner's
        (a, b, c); ``full_output``: (u, v, Phi, the counts),
        Phi the volumetric dissipation 4 nu eps^2 [W/m^3] (the JAX package
        returns the sweeps alone there)."""
        grid, sh = self.grid, self.sh
        geom = state.geometry
        H2 = geom.ice_thickness.to(F64)
        dev = H2.device
        mask = geom.cell_type
        dx, dy = grid.dx, grid.dy
        Mz = grid.Mz
        shape3 = tuple(H2.shape) + (Mz,)
        SPY = SEC_PER_YEAR

        def t64(a):
            return torch.as_tensor(a, dtype=F64, device=dev)

        zeta, dzeta = t64(self.zeta), t64(self.dzeta)

        icy = S.icy(mask)
        icy_e = sh(icy, 0, 1)
        icy_n = sh(icy, 1, 0)
        keep_e = (icy & icy_e).to(F64)[..., None]
        keep_n = (icy & icy_n).to(F64)[..., None]
        Hs = torch.clamp(H2, min=1.0)[..., None]     # (My, Mx, 1)

        # metric coefficients zeta_x, zeta_y at centers, the gradients
        # masked to fully icy stencils
        surf2 = geom.ice_surface_elevation.to(F64)
        base2 = surf2 - H2
        interior = (icy & sh(icy, 0, 1) & sh(icy, 0, -1)
                    & sh(icy, 1, 0) & sh(icy, -1, 0)).to(F64)
        bxg, byg = st.centered_grad(base2, dx, dy, sh)
        Hxg, Hyg = st.centered_grad(H2, dx, dy, sh)
        zxc = -(bxg[..., None] + zeta * Hxg[..., None]) / Hs \
            * interior[..., None]
        zyc = -(byg[..., None] + zeta * Hyg[..., None]) / Hs \
            * interior[..., None]
        if not self.metric_terms:
            zxc = zyc = torch.zeros_like(zxc)

        e_hard = self.e_factor ** (-1.0 / self.n_glen)
        if state.enthalpy is None:
            z0 = torch.zeros(shape3, dtype=F64, device=dev)
            B3 = self.flow_law.hardness(z0, z0)
        else:
            depth = torch.clamp(H2[..., None] - t64(grid.z), min=0.0)
            p = self.flow_law.EC.pressure(depth)
            B3 = self.flow_law.hardness(state.enthalpy.to(F64), p)
        B3 = B3 * e_hard

        if self.taud_x is not None:
            bx2, by2 = self.taud_x.to(F64), self.taud_y.to(F64)
        else:
            # one-sided surface gradients at the ice margin, as in the SSA
            def masked_grad(jy, ix, d):
                icy_p, icy_m = sh(icy, jy, ix), sh(icy, -jy, -ix)
                s_p, s_m = sh(surf2, jy, ix), sh(surf2, -jy, -ix)
                return torch.where(
                    icy_p & icy_m, (s_p - s_m) / (2 * d),
                    torch.where(icy_p, (s_p - surf2) / d,
                                torch.where(icy_m, (surf2 - s_m) / d, 0.0)))
            sx = masked_grad(0, 1, dx)
            sy = masked_grad(1, 0, dy)
            bx2 = -self.rho * self.g * H2 * sx
            by2 = -self.rho * self.g * H2 * sy
        # the per-volume driving term tau_d / H [Pa/m]
        bx = (bx2[..., None] / Hs).expand(shape3)
        by = (by2[..., None] / Hs).expand(shape3)
        if self.body_force_x is not None:
            bx = bx + self.body_force_x.to(F64)
        if self.body_force_y is not None:
            by = by + self.body_force_y.to(F64)

        if tau_c is None:
            tau_c = torch.zeros_like(H2)
        tau_eff = torch.where(S.grounded_ice(mask), tau_c.to(F64), 0.0)

        fixed2 = ~icy if self.bc_mask is None \
            else (~icy) | self.bc_mask.to(torch.bool)
        bc3 = fixed2[..., None].expand(shape3)

        dz_l = torch.cat([dzeta[:1], dzeta])      # below level k (clamped)
        dz_u = torch.cat([dzeta, dzeta[-1:]])     # above level k (clamped)
        # finite-volume cell heights, half cells at the bed and the surface
        zero1 = torch.zeros(1, dtype=F64, device=dev)
        dz_c = 0.5 * (torch.cat([zero1, dzeta]) + torch.cat([dzeta, zero1]))

        def free(x):
            return (torch.where(bc3, 0.0, x[0]), torch.where(bc3, 0.0, x[1]))

        def ddzeta(a):
            """Centered d/dzeta (one-sided at the ends)."""
            d_int = (a[..., 2:] - a[..., :-2]) / (dz_l[1:-1] + dz_u[1:-1])
            d_lo = (a[..., 1:2] - a[..., 0:1]) / dzeta[0]
            d_hi = (a[..., -1:] - a[..., -2:-1]) / dzeta[-1]
            return torch.cat([d_lo, d_int, d_hi], dim=-1)

        def center_grads(u_a, v_a):
            """Horizontal strain-rate ingredients at constant z by the
            sigma-coordinate chain rule (cell centers, per level)."""
            u_zeta, v_zeta = ddzeta(u_a), ddzeta(v_a)
            ux = (sh(u_a, 0, 1) - sh(u_a, 0, -1)) / (2 * dx) + zxc * u_zeta
            vy = (sh(v_a, 1, 0) - sh(v_a, -1, 0)) / (2 * dy) + zyc * v_zeta
            uy = (sh(u_a, 1, 0) - sh(u_a, -1, 0)) / (2 * dy) + zyc * u_zeta
            vx = (sh(v_a, 0, 1) - sh(v_a, 0, -1)) / (2 * dx) + zxc * v_zeta
            return ux, uy, vx, vy, u_zeta, v_zeta

        def strain_nu_eps(u, v):
            """Effective viscosity [Pa s] and squared effective strain rate
            [1/s^2] (in 1/year inside, rescaled to SI)."""
            u_a, v_a = u * SPY, v * SPY
            ux, uy, vx, vy, u_zeta, v_zeta = center_grads(u_a, v_a)
            uz = u_zeta / Hs
            vz = v_zeta / Hs
            reg_a = self.eps_reg2 * SPY * SPY
            eps2 = (ux ** 2 + vy ** 2 + ux * vy + 0.25 * (uy + vx) ** 2
                    + 0.25 * uz ** 2 + 0.25 * vz ** 2 + reg_a)
            n = self.n_glen
            nu = 0.5 * B3 * eps2 ** ((1.0 - n) / (2.0 * n)) \
                * SPY ** ((n - 1.0) / n)
            return nu, eps2 / (SPY * SPY)

        # the depth-varying calving-front pressure imbalance per level
        if self.cfbc:
            ocn = mask == S.MASK_ICE_FREE_OCEAN
            z_abs = base2[..., None] + zeta * H2[..., None]
            sl2 = geom.sea_level.to(F64)
            p_diff = (self.rho * self.g * H2[..., None] * (1.0 - zeta)
                      - self.rho_w * self.g
                      * torch.clamp(sl2[..., None] - z_abs, min=0.0))
            p_diff = torch.where(icy[..., None], p_diff, 0.0)
            # east faces stored at i (between i and i+1), north alike; the
            # traction at the icy side's levels
            front_xx = (torch.where((icy & sh(ocn, 0, 1))[..., None],
                                    p_diff, 0.0)
                        + torch.where((ocn & icy_e)[..., None],
                                      sh(p_diff, 0, 1), 0.0))
            front_yy = (torch.where((icy & sh(ocn, 1, 0))[..., None],
                                    p_diff, 0.0)
                        + torch.where((ocn & icy_n)[..., None],
                                      sh(p_diff, 1, 0), 0.0))
        else:
            front_xx = front_yy = 0.0

        zx_e = 0.5 * (zxc + sh(zxc, 0, 1))
        zy_e = 0.5 * (zyc + sh(zyc, 0, 1))
        zx_n = 0.5 * (zxc + sh(zxc, 1, 0))
        zy_n = 0.5 * (zyc + sh(zyc, 1, 0))
        keep_c = keep_e * sh(keep_e, 0, -1) * keep_n * sh(keep_n, -1, 0)
        zeros_up = torch.zeros(shape3[:-1] + (Mz - 1,), dtype=F64, device=dev)

        def beta_of(u, v):
            """The basal drag coefficient at the bottom level of free (u, v)."""
            return self.sliding_law.beta(tau_eff, u[..., 0], v[..., 0]) \
                + self.beta_floor

        def strains(u, v):
            """The strain-rate combinations the stresses take: east and
            north faces, centers (the divergence's chain-rule part) and the
            vertical differences; linear in (u, v)."""
            u_zeta, v_zeta = ddzeta(u), ddzeta(v)
            uz_e = 0.5 * (u_zeta + sh(u_zeta, 0, 1))
            vz_e = 0.5 * (v_zeta + sh(v_zeta, 0, 1))
            uz_n = 0.5 * (u_zeta + sh(u_zeta, 1, 0))
            vz_n = 0.5 * (v_zeta + sh(v_zeta, 1, 0))
            ux_e = (sh(u, 0, 1) - u) / dx + zx_e * uz_e
            vy_e = (sh(v, 1, 0) + sh(v, 1, 1) - sh(v, -1, 0) - sh(v, -1, 1)) \
                / (4 * dy) + zy_e * vz_e
            uy_n = (sh(u, 1, 0) - u) / dy + zy_n * uz_n
            vx_n = (sh(v, 0, 1) + sh(v, 1, 1) - sh(v, 0, -1) - sh(v, 1, -1)) \
                / (4 * dx) + zx_n * vz_n
            vy_n = (sh(v, 1, 0) - v) / dy + zy_n * vz_n
            ux_n = (sh(u, 0, 1) + sh(u, 1, 1) - sh(u, 0, -1) - sh(u, 1, -1)) \
                / (4 * dx) + zx_n * uz_n
            uy_e = (sh(u, 1, 0) + sh(u, 1, 1) - sh(u, -1, 0) - sh(u, -1, 1)) \
                / (4 * dy) + zy_e * uz_e
            vx_e = (sh(v, 0, 1) - v) / dx + zx_e * vz_e
            c = center_grads(u, v)
            ux_c, uy_c, vx_c, vy_c = c[:4]
            return dict(xx_e=4.0 * ux_e + 2.0 * vy_e, xy_n=uy_n + vx_n,
                        yy_n=4.0 * vy_n + 2.0 * ux_n, xy_e=uy_e + vx_e,
                        xx_c=4.0 * ux_c + 2.0 * vy_c,
                        yy_c=4.0 * vy_c + 2.0 * ux_c, xy_c=uy_c + vx_c,
                        dz_u=u[..., 1:] - u[..., :-1],
                        dz_v=v[..., 1:] - v[..., :-1], center=c)

        def faces(nu):
            """nu on the east and north faces (per volume) and between
            levels."""
            return (0.5 * (nu + sh(nu, 0, 1)) * keep_e,
                    0.5 * (nu + sh(nu, 1, 0)) * keep_n,
                    0.5 * (nu[..., 1:] + nu[..., :-1]))

        def divergence(T):
            """The membrane and vertical-shear terms (div_x + V_u, div_y +
            V_v) of the stresses ``T``."""
            div_x = ((T["xx_e"] - sh(T["xx_e"], 0, -1)) / dx
                     + (T["xy_n"] - sh(T["xy_n"], -1, 0)) / dy)
            div_y = ((T["xy_e"] - sh(T["xy_e"], 0, -1)) / dx
                     + (T["yy_n"] - sh(T["yy_n"], -1, 0)) / dy)
            # d/dx|_z T = d/dx|_zeta T + zeta_x dT/dzeta: the chain-rule
            # part from center stresses
            div_x = div_x + zxc * ddzeta(T["xx_c"]) + zyc * ddzeta(T["xy_c"])
            div_y = div_y + zxc * ddzeta(T["xy_c"]) + zyc * ddzeta(T["yy_c"])

            def vert(flux):
                # stress-free surface (flux 0); the base through beta
                z1 = torch.zeros_like(flux[..., :1])
                fz = torch.cat([z1, flux, z1], dim=-1)
                return (fz[..., 1:] - fz[..., :-1]) / dz_c / Hs

            return div_x + vert(T["z_u"]), div_y + vert(T["z_v"])

        def stresses(E, nu_faces, nu):
            nuH_e, nuH_n, nu_mid = nu_faces
            return dict(xx_e=nuH_e * E["xx_e"], xy_n=nuH_n * E["xy_n"],
                        yy_n=nuH_n * E["yy_n"], xy_e=nuH_e * E["xy_e"],
                        xx_c=nu * E["xx_c"] * keep_c,
                        yy_c=nu * E["yy_c"] * keep_c,
                        xy_c=nu * E["xy_c"] * keep_c,
                        z_u=nu_mid * E["dz_u"] / dzeta / Hs,
                        z_v=nu_mid * E["dz_v"] / dzeta / Hs)

        def drag(beta, u, v):
            wb = dz_c[0] * Hs[..., 0]
            return (torch.cat([(beta * u[..., 0] / wb)[..., None], zeros_up],
                              dim=-1),
                    torch.cat([(beta * v[..., 0] / wb)[..., None], zeros_up],
                              dim=-1))

        def residual(uv, beta=None):
            """F(uv); ``beta`` given is held fixed, else computed from uv."""
            u, v = free(uv)
            nu = strain_nu_eps(u, v)[0]
            T = stresses(strains(u, v), faces(nu), nu)
            if self.cfbc:
                T["xx_e"] = T["xx_e"] + front_xx
                T["yy_n"] = T["yy_n"] + front_yy
            Mu, Mv = divergence(T)
            if beta is None:
                beta = beta_of(u, v)
            drag_u, drag_v = drag(beta, u, v)
            Fx = -(Mu - drag_u) - bx
            Fy = -(Mv - drag_v) - by
            return free((Fx, Fy))

        def linearized(u, v, beta):
            """The Jacobian of ``residual`` at free (u, v) with beta frozen,
            as a map of free directions (d_u, d_v): F is A(nu(u)) u + drag
            + load with A bilinear in (nu, u), so J d = A(nu) d +
            A(dnu(d)) u + drag(d), dnu = nu p d(eps^2)/eps^2 with p =
            (1 - n)/(2n)."""
            u_a, v_a = u * SPY, v * SPY
            ux, uy, vx, vy, u_zeta, v_zeta = center_grads(u_a, v_a)
            uz, vz = u_zeta / Hs, v_zeta / Hs
            nu, eps2 = strain_nu_eps(u, v)
            eps2_a = eps2 * (SPY * SPY)
            p = (1.0 - self.n_glen) / (2.0 * self.n_glen)
            nu_p = nu * p / eps2_a
            nu_faces = faces(nu)
            E_u = strains(u, v)

            def jvp(du, dv):
                E_d = strains(du, dv)
                dux, duy, dvx, dvy, duz, dvz = E_d["center"]
                deps2 = SPY * (2.0 * ux * dux + 2.0 * vy * dvy + ux * dvy
                               + dux * vy + 0.5 * (uy + vx) * (duy + dvx)
                               + 0.5 * uz * duz / Hs + 0.5 * vz * dvz / Hs)
                dnu = nu_p * deps2
                T = stresses(E_d, nu_faces, nu)
                T_nu = stresses(E_u, faces(dnu), dnu)
                Mu, Mv = divergence({k: T[k] + T_nu[k] for k in T})
                drag_u, drag_v = drag(beta, du, dv)
                return free((drag_u - Mu, drag_v - Mv))

            return jvp

        def dot(a, b_):
            return ssa_ops._dot(a, b_)

        def make_precond(u, v):
            """The vertical-line preconditioner at free (u, v): (diag_h +
            d/dz nu d/dz) per column, factored once; both components in one
            batch."""
            nu = strain_nu_eps(u, v)[0]
            nuH_e = 0.5 * (nu + sh(nu, 0, 1)) * keep_e
            nuH_n = 0.5 * (nu + sh(nu, 1, 0)) * keep_n
            diag_h = (4.0 * (nuH_e + sh(nuH_e, 0, -1)) / dx ** 2
                      + (nuH_n + sh(nuH_n, -1, 0)) / dy ** 2)
            nu_mid = 0.5 * (nu[..., 1:] + nu[..., :-1])
            w = nu_mid / dzeta / (Hs ** 2)            # interface weights
            z1 = torch.zeros_like(w[..., :1])
            lo = torch.cat([z1, w], dim=-1)
            hi = torch.cat([w, z1], dim=-1)
            a = -lo / dz_c
            c = -hi / dz_c
            b = diag_h + (lo + hi) / dz_c
            b = torch.cat([b[..., :1] + (beta_of(u, v) / (dz_c[0] * Hs[..., 0]))
                           [..., None], b[..., 1:]], dim=-1)
            b = torch.where(bc3, 1.0, torch.clamp(b, min=1e-12))
            a = torch.where(bc3, 0.0, a)
            c = torch.where(bc3, 0.0, c)
            return ColumnThomas(a, b, c), (a, b, c)

        def precond_of(thomas):
            def precond(ru, rv):
                x = thomas.solve(torch.stack((ru, rv)))
                return x[0], x[1]
            return precond

        zero3 = torch.zeros(shape3, dtype=F64, device=dev)
        u_init = zero3 if u0 is None else u0.to(F64)
        v_init = zero3 if v0 is None else v0.to(F64)
        uv = free((u_init, v_init))

        fb = free((bx, by))
        b_norm2 = dot(fb, fb)
        tol2 = torch.clamp(self.newton_rtol ** 2 * b_norm2, min=1e-300)
        alphas = torch.tensor([1.0, 0.5, 0.25, 0.0625, 0.01], dtype=F64,
                              device=dev)

        F = residual(uv)
        F2 = dot(F, F)
        chg2 = torch.ones_like(F2)
        it = krylov = 0
        while it < self.newton_max and host((F2 > tol2) & (chg2 > 1e-16)):
            u, v = uv
            beta = beta_of(u, v)
            # linearized once a sweep, beta frozen at the sweep's iterate
            jvp_lin = linearized(u, v, beta)

            def jmv(du, dv):
                Jd = jvp_lin(*free((du, dv)))
                return (Jd[0] + torch.where(bc3, du, 0.0),
                        Jd[1] + torch.where(bc3, dv, 0.0))

            thomas, _ = make_precond(u, v)
            # each a replay of one graph on the card
            jmv_g = graphed(jmv, *F)
            precond_g = graphed(precond_of(thomas), *F)
            zero = (torch.zeros_like(F[0]), torch.zeros_like(F[1]))
            d, k, _ = ssa_ops.bicgstab_solve(
                lambda x: jmv_g(*x), (-F[0], -F[1]), zero,
                lambda r: precond_g(*r), rtol=self.ksp_rtol,
                max_iter=self.ksp_max)
            krylov += k
            d = free(d)

            norms = []
            for j in range(alphas.shape[0]):
                Fc = residual((u + alphas[j] * d[0], v + alphas[j] * d[1]))
                norms.append(dot(Fc, Fc))
            norms = torch.stack(norms)
            kbest = torch.argmin(norms)      # the first minimum
            ak = alphas[kbest]
            F2_new = norms[kbest]
            worse = F2_new >= F2
            uv_new = (torch.where(worse, u, u + ak * d[0]),
                      torch.where(worse, v, v + ak * d[1]))
            F = residual(uv_new)
            F2 = torch.where(worse, F2, F2_new)
            dchg = (uv_new[0] - u, uv_new[1] - v)
            chg2 = dot(dchg, dchg) / torch.clamp(dot(uv_new, uv_new),
                                                 min=1e-300)
            uv = uv_new
            it += 1

        u, v = free(uv)
        if full_output:
            nu_f, eps2_f = strain_nu_eps(u, v)
            Phi = torch.where(icy[..., None], 4.0 * nu_f * eps2_f, 0.0)
            return u, v, Phi, {"newton_iters": it, "krylov_iters": krylov}
        if diagnostics:
            return u, v, {"newton_iters": it, "krylov_iters": krylov,
                          "F2_final": F2, "tol2": tol2, "b_norm2": b_norm2,
                          "residual_fn": residual,
                          "jacobian_fn": lambda uv_, d_: linearized(
                              *free(uv_), beta_of(*free(uv_)))(*free(d_)),
                          "precond_fn": lambda uv_: make_precond(*free(uv_))[1]}
        return u, v

    # -- composite-model helpers ----------------------------------------------
    def column_weights(self):
        """The zeta trapezoid weights of :meth:`vertical_average` (sum 1)."""
        dz = self.dzeta
        return np.concatenate([dz[:1] * 0.5, 0.5 * (dz[1:] + dz[:-1]),
                               dz[-1:] * 0.5])

    def vertical_average(self, f3):
        """Column average over zeta (equal to the z-average for any H)."""
        w = torch.as_tensor(self.column_weights(), dtype=f3.dtype,
                            device=f3.device)
        return torch.tensordot(f3, w, dims=([-1], [0]))

    def regrid_to_z(self, f3, H):
        """A zeta-grid column field interpolated to the model's fixed z
        levels (height above the base); zero above the local ice surface,
        the SIA 3D reconstruction's convention."""
        dev, dt = f3.device, f3.dtype
        z = torch.as_tensor(self.grid.z, dtype=dt, device=dev)
        zeta = torch.as_tensor(self.zeta, dtype=dt, device=dev)
        Hc = torch.clamp(H, min=1.0)[..., None]
        zt = torch.clamp(z / Hc, 0.0, 1.0)                  # (My, Mx, Mz)
        idx = torch.clamp(torch.searchsorted(zeta, zt.contiguous(),
                                             right=True) - 1,
                          0, zeta.shape[0] - 2)
        z0 = zeta[idx]
        dz = zeta[idx + 1] - z0
        wgt = torch.clamp((zt - z0) / torch.clamp(dz, min=1e-12), 0.0, 1.0)
        f0 = torch.gather(f3, -1, idx)
        f1 = torch.gather(f3, -1, idx + 1)
        out = f0 * (1.0 - wgt) + f1 * wgt
        in_ice = (z <= H[..., None]) | (torch.arange(z.shape[0],
                                                     device=dev) == 0)
        return torch.where(in_ice, out, 0.0)
