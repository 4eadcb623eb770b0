"""SSA stress balance, Q1 Galerkin finite elements (port of
``pism_tpu/model/ssafem.py`` ``SSAFEM``).

Weak form (test functions phi for each equation):
  int [ 2 nuH (2 u_x + v_y) phi_x + nuH (u_y + v_x) phi_y
        + beta u phi - taud_x phi ] dA = 0
  int [ 2 nuH (2 v_y + u_x) phi_y + nuH (u_y + v_x) phi_x
        + beta v phi - taud_y phi ] dA = 0
with nu = (B/2) eps_eff^((1-n)/n) at the 2x2 quadrature points
(``ops/fem.py``) and the natural (zero membrane stress) condition on the
domain edge; ice-free nodes are Dirichlet rows (u = v = 0 or the prescribed
values). Elements with any ice-free node carry no stress, and the
calving-front pressure integral is not applied (use SSAFD for
shelf-front-dominated configurations), as in the JAX package.

The solve is the JAX package's: Picard warm-up sweeps with
drag-regularization continuation, then safeguarded Newton sweeps, each
trying five line-search steps and one Picard sweep and keeping the first
with the least |F|^2; BiCGStab (``ops/ssa.py``) with the Jacobi
preconditioner of the frozen-coefficient weak form. The Newton matvec is
the residual's Jacobian written out (``linearized``; the JAX package
takes ``jax.linearize``) with beta frozen at the sweep's iterate (its
``stop_gradient``). The assembly runs on the stacked kit of
``ops/fem.py``: a few dozen launches a call, rounding as the JAX
package's term order does, since this solve's Krylov totals move with
the rounding (``scripts/fem_krylov_rounding.py``). The loops that JAX
runs as ``fori_loop`` and ``while_loop`` are host loops; the stop test
reads one flag a sweep and the candidate is chosen on the device. On the
card each Krylov matvec replays one CUDA graph captured for its linear
solve (``util/cudagraph.py``).

float32 fields are solved in float32 with float64 Krylov dots, or, with
``stress_balance.ssa.fd.solve_dtype = float64``, cast to float64 for the
solve and back (the JAX package's redirect). The member axis and a mesh
raise NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import state as S
from ..ops import fem
from ..ops import ssa as ssa_ops
from ..ops.stencils import Shifter
from ..parallel.mesh import refuse_member_axis_and_mesh
from ..physics.basal import SlidingLaw
from ..util.cudagraph import graphed
from ..util.hostsync import host

SPY = 3.15569259747e7


@dataclass
class SSAFEM:
    grid: object
    config: object
    flow_law: object
    sliding_law: Optional[SlidingLaw] = None
    bc_mask: Optional[torch.Tensor] = None
    bc_u: Optional[torch.Tensor] = None
    bc_v: Optional[torch.Tensor] = None
    taud_x: Optional[torch.Tensor] = None
    taud_y: Optional[torch.Tensor] = None
    mesh: object = None
    lead: int = 0

    def __post_init__(self):
        refuse_member_axis_and_mesh("stress_balance.ssa.method = 'fem'",
                                    self.lead, self.mesh)
        cfg = self.config
        self.sh = Shifter(self.grid)
        self.n_glen = cfg.get_number("stress_balance.ssa.Glen_exponent")
        self.e_ssa = cfg.get_number("stress_balance.ssa.enhancement_factor")
        self.rho = cfg.get_number("constants.ice.density")
        self.g = cfg.get_number("constants.standard_gravity")
        self.picard_warmup = cfg.get_int("stress_balance.ssa.fd.picard_warmup")
        self.newton_rtol = cfg.get_number("stress_balance.ssa.fd.newton_rtol")
        self.newton_max = cfg.get_int(
            "stress_balance.ssa.fd.newton_max_iterations")
        self.ksp_rtol = cfg.get_number("stress_balance.ssa.fd.ksp_rtol")
        self.ksp_max = cfg.get_int("stress_balance.ssa.fd.ksp_max_it")
        self.epsilon = cfg.get_number("stress_balance.ssa.epsilon")
        svel = cfg.get_number(
            "stress_balance.ssa.Schoof_regularizing_velocity", "m s-1")
        slen = cfg.get_number(
            "stress_balance.ssa.Schoof_regularizing_length", "m")
        self.eps_reg2 = (svel / slen) ** 2
        self.beta_floor = cfg.get_number("stress_balance.ssa.fd.beta_floor")
        self.subgl_drag = cfg.get_flag("geometry.grounded_cell_fraction")
        self.solve_dtype = cfg.get_string("stress_balance.ssa.fd.solve_dtype")
        if self.solve_dtype == "auto":
            # SSAFD's rule: float32 under the velocity-change stop, mixed
            # for full convergence
            chg = cfg.get_number("stress_balance.ssa.fd.velocity_change_rtol")
            self.solve_dtype = "float32" if chg > 0.0 else "mixed"
        if self.sliding_law is None:
            self.sliding_law = SlidingLaw.from_config(cfg)

    def _hardness(self, state: S.ModelState):
        H = state.geometry.ice_thickness
        if state.enthalpy is None:
            B = self.flow_law.hardness(torch.zeros_like(H), torch.zeros_like(H))
        else:
            z = torch.as_tensor(self.grid.z, dtype=H.dtype, device=H.device)
            B = self.flow_law.averaged_hardness(H, state.enthalpy, z)
        return B * self.e_ssa ** (-1.0 / self.n_glen)

    def driving_stress(self, geometry, icy):
        from .ssa import SSAFD
        return SSAFD.driving_stress(self, geometry, icy)

    # -- weak-form residual -------------------------------------------------
    def build_problem(self, state: S.ModelState, tau_c=None) -> dict:
        grid = self.grid
        geom = state.geometry
        H = geom.ice_thickness
        dtype = H.dtype
        dx, dy = grid.dx, grid.dy
        n = self.n_glen

        icy = S.icy(geom.cell_type)
        B = self._hardness(state)
        if self.taud_x is not None:
            bx, by = self.taud_x.to(dtype), self.taud_y.to(dtype)
        else:
            bx, by = self.driving_stress(geom, icy)

        if tau_c is None:
            tau_c = torch.zeros_like(H)
        grounded_ice_mask = S.grounded_ice(geom.cell_type)
        gf = geom.cell_grounded_fraction if self.subgl_drag else None

        if self.bc_mask is not None:
            fixed = self.bc_mask.to(torch.bool)
            bc_mask = fixed | ~icy
            bc_u = torch.where(fixed, self.bc_u.to(dtype), 0.0)
            bc_v = torch.where(fixed, self.bc_v.to(dtype), 0.0)
        else:
            bc_mask = ~icy
            bc_u = torch.zeros_like(H)
            bc_v = torch.zeros_like(H)

        def free(x):
            return (torch.where(bc_mask, 0.0, x[0]),
                    torch.where(bc_mask, 0.0, x[1]))

        def full(x):
            return (torch.where(bc_mask, bc_u, x[0]),
                    torch.where(bc_mask, bc_v, x[1]))

        # element coefficients per quadrature point, stacked on a leading
        # axis of 4 (``ops/fem.py``'s stacked kit: a few dozen launches an
        # assembly, each value rounded as in the JAX package's term order);
        # the wrap elements of non-periodic axes are masked out of every
        # integral
        valid = fem.element_validity(H.shape, grid.periodic_x,
                                     grid.periodic_y, dtype, H.device)
        tables = fem.basis_tables(dx, dy, dtype, H.device)

        def quad(f):
            """Values (rows 0-3) and gradients (4-11) at the quadrature
            points of nodal f (..., My, Mx)."""
            return fem.quad_stacked(tables, fem.corners_stacked(f))

        ic = fem.corners(icy)
        icy_el = (ic[0] & ic[1] & ic[2] & ic[3]).to(dtype) * valid
        H_q, B_q = (quad(f)[:4] for f in (H, B))
        rescale = SPY ** ((n - 1.0) / n)
        reg2_a = self.eps_reg2 * SPY * SPY
        p = (1.0 - n) / (2.0 * n)

        def grads(u, v):
            """(ux, uy, vx, vy) at the quadrature points."""
            G = quad(torch.stack((u, v)))
            return G[0, 4:8], G[0, 8:], G[1, 4:8], G[1, 8:]

        def strain_q(u, v):
            """Strain rates at the quadrature points in 1/year (the float32
            range, as in ``ops/ssa.py`` compute_nuH): exx, eyy, 2 exy, and
            eps^2."""
            ux, uy, vx, vy = grads(u, v)
            exx, eyy, exy2 = ux * SPY, vy * SPY, (uy + vx) * SPY
            return exx, eyy, exy2, exx ** 2 + eyy ** 2 + exx * eyy \
                + 0.25 * exy2 ** 2 + reg2_a

        def nuH_of(eps2):
            return 0.5 * B_q * eps2 ** p * rescale * H_q

        def nuH_q(u, v):
            """nu H at the quadrature points."""
            return (nuH_of(strain_q(u, v)[3]) + self.epsilon) * icy_el

        if gf is not None:
            tc_eff = tau_c * torch.where(icy, gf, 0.0)
        else:
            tc_eff = torch.where(grounded_ice_mask, tau_c, 0.0)

        def beta_fn(u, v, reg=None):
            return self.sliding_law.beta(tc_eff, u, v, reg=reg) \
                + self.beta_floor

        load = quad(torch.stack((torch.where(icy, bx, 0.0),
                                 torch.where(icy, by, 0.0))))[:, :4] * valid
        icy_q = quad(icy.to(dtype))[:4] * valid

        def operator(nu_q, beta_nodes, tangent=None, with_load=False):
            """The weak-form assembly on stacked (2, My, Mx) velocities or
            directions X: A(nuH) X + drag(X), minus the load with
            ``with_load`` (the residual: the assembly is affine); with
            ``tangent`` = (dnuH(X), the iterate's gradients) plus the term
            A(dnuH) u of the Jacobian."""
            def apply(X):
                G = quad(X)
                dux, duy, dvx, dvy = G[0, 4:8], G[0, 8:], G[1, 4:8], G[1, 8:]
                fx_u = 2.0 * nu_q * (2.0 * dux + dvy)
                fxy = nu_q * (duy + dvx)
                fy_v = 2.0 * nu_q * (2.0 * dvy + dux)
                if tangent is not None:
                    dnu_of, (ux, uy, vx, vy) = tangent
                    dnu = dnu_of(dux, duy, dvx, dvy)
                    fx_u = fx_u + 2.0 * dnu * (2.0 * ux + vy)
                    fxy = fxy + dnu * (uy + vx)
                    fy_v = fy_v + 2.0 * dnu * (2.0 * vy + ux)
                f0 = icy_q * quad(beta_nodes * X)[:, :4]
                if with_load:
                    f0 = f0 - load
                return fem.integrate_stacked(
                    tables, f0, torch.stack((fx_u, fxy)),
                    torch.stack((fxy, fy_v)), dx, dy)
            return apply

        def assemble(u, v, nu_q, beta_nodes, with_load=True):
            """The weak-form residual with the given coefficients; without
            the load, the linear operator part."""
            R = operator(nu_q, beta_nodes, with_load=with_load)(
                torch.stack((u, v)))
            return R[0], R[1]

        def linearized(u, v, beta):
            """The Jacobian of ``residual`` at full (u, v) with beta frozen,
            as a map of free directions: the assembly is bilinear in (nu H,
            u), so J d = A(nuH) d + A(d nuH(d)) u + drag(d), with d nuH =
            nu H p d(eps^2)/eps^2 at each quadrature point, p = (1 - n)/
            (2n)."""
            exx, eyy, exy2, eps2 = strain_q(u, v)
            nuH = nuH_of(eps2)
            fac = nuH * p / eps2 * icy_el

            def dnu_of(dux, duy, dvx, dvy):
                deps2 = (2.0 * exx * dux + 2.0 * eyy * dvy + dux * eyy
                         + exx * dvy + 0.5 * exy2 * (duy + dvx)) * SPY
                return fac * deps2

            apply = operator((nuH + self.epsilon) * icy_el, beta,
                             (dnu_of, grads(u, v)))

            def jvp(du, dv):
                R = apply(torch.stack((du, dv)))
                return free((R[0], R[1]))

            return jvp

        def residual(uv, beta=None):
            """F(uv); ``beta`` given is held fixed (the linearization's
            frozen drag), else computed from uv."""
            u, v = full(uv)
            if beta is None:
                beta = beta_fn(u, v)
            return free(assemble(u, v, nuH_q(u, v), beta))

        # the Jacobi diagonal's coefficients by (a, q), Python floats
        sx, sy = 2.0 / dx, 2.0 / dy
        gx2 = [[(sx * fem.DNDXI_TAB[a][q]) ** 2 for q in range(4)]
               for a in range(4)]
        gy2 = [[(sy * fem.DNDETA_TAB[a][q]) ** 2 for q in range(4)]
               for a in range(4)]
        cu, cv, n2 = (torch.tensor(x, dtype=dtype, device=H.device)[
            ..., None, None] for x in (
                [[4.0 * gx2[a][q] + gy2[a][q] for q in range(4)]
                 for a in range(4)],
                [[4.0 * gy2[a][q] + gx2[a][q] for q in range(4)]
                 for a in range(4)],
                [[fem.N_TAB[a][q] ** 2 for q in range(4)] for a in range(4)]))

        def diag(nu_q, beta_nodes):
            """Jacobi diagonal of the frozen-coefficient weak form."""
            mass = (icy_q * quad(beta_nodes)[:4]) * n2     # (4a, 4q, ...)
            du = dv = 0.0
            for q in range(4):
                du = du + nu_q[q] * cu[:, q] + mass[:, q]
                dv = dv + nu_q[q] * cv[:, q] + mass[:, q]
            J = dx * dy / 4.0
            return (fem.scatter_to_nodes(J * du), fem.scatter_to_nodes(J * dv))

        return dict(residual=residual, free=free, full=full,
                    assemble=assemble, nuH_q=nuH_q, beta_fn=beta_fn,
                    linearized=linearized, operator=operator,
                    diag=diag, bc_mask=bc_mask, bc_u=bc_u, bc_v=bc_v,
                    bx=bx, by=by, icy=icy, tau_c=tau_c)

    # -- nonlinear solve ----------------------------------------------------
    def solve(self, state: S.ModelState, tau_c=None, u0=None, v0=None,
              diagnostics: bool = False):
        """(u, v), with ``diagnostics`` also a dict of the Newton sweeps, the
        BiCGStab iterations of the solve (host ints; the warm-up's and the
        Picard candidates' included) and |F|^2 with its tolerance."""
        out_dtype = state.geometry.ice_thickness.dtype
        if out_dtype != torch.float64 and self.solve_dtype == "float64":
            def f64(a):
                return None if a is None else a.to(torch.float64)
            g = state.geometry
            state = state.replace(
                geometry=g.replace(
                    ice_thickness=f64(g.ice_thickness),
                    bed_elevation=f64(g.bed_elevation),
                    sea_level=f64(g.sea_level),
                    ice_surface_elevation=f64(g.ice_surface_elevation)),
                enthalpy=f64(state.enthalpy), u_ssa=f64(state.u_ssa),
                v_ssa=f64(state.v_ssa))
            u, v, info = self.solve(state, f64(tau_c), f64(u0), f64(v0),
                                    diagnostics=True)
            u, v = u.to(out_dtype), v.to(out_dtype)
            return (u, v, info) if diagnostics else (u, v)

        H = state.geometry.ice_thickness
        dtype = H.dtype

        P = self.build_problem(state, tau_c)
        free, full = P["free"], P["full"]
        residual, assemble = P["residual"], P["assemble"]
        nuH_q, beta_fn, diag = P["nuH_q"], P["beta_fn"], P["diag"]
        linearized, operator = P["linearized"], P["operator"]
        bc_mask = P["bc_mask"]

        ddt = torch.float64 if dtype == torch.float32 else None

        def dot(a, b_):
            return ssa_ops._dot(a, b_, ddt)

        u_init = u0 if u0 is not None else (
            state.u_ssa if state.u_ssa is not None else torch.zeros_like(H))
        v_init = v0 if v0 is not None else (
            state.v_ssa if state.v_ssa is not None else torch.zeros_like(H))
        uv = free((u_init, v_init))

        F0 = residual(uv)
        rtol = self.newton_rtol if dtype == torch.float64 else \
            max(self.newton_rtol, 3.0e-5)
        tol2 = torch.clamp(rtol ** 2 * dot(F0, F0), min=1e-300)

        def jacobi(d_u, d_v):
            d_u = torch.where(bc_mask, 1.0, torch.clamp(d_u, min=1e-12))
            d_v = torch.where(bc_mask, 1.0, torch.clamp(d_v, min=1e-12))
            return lambda r: (r[0] / d_u, r[1] / d_v)

        krylov = [0]

        def bicgstab(matvec, rhs, x0, precond):
            x, k, _ = ssa_ops.bicgstab_solve(
                lambda x_: matvec(*x_), rhs, x0, precond, rtol=self.ksp_rtol,
                max_iter=self.ksp_max, dot_dtype=ddt)
            krylov[0] += k
            return x

        # Picard warm-up with drag-regularization continuation: the
        # frozen-coefficient linear weak form by BiCGStab
        reg0 = 1000.0 / SPY
        reg_final = self.sliding_law.plastic_reg
        nwarm = max(self.picard_warmup, 1)
        decay = (reg_final / reg0) ** (1.0 / nwarm)

        def picard_iter(i, uv):
            u, v = full(uv)
            nu_q = nuH_q(u, v)
            reg = max(reg0 * decay ** (i + 1.0), reg_final)
            beta = beta_fn(u, v, reg=reg)

            apply = operator(nu_q, beta)

            def matvec(xu, xv):
                out = apply(torch.stack(free((xu, xv))))
                out = free((out[0], out[1]))
                return (out[0] + torch.where(bc_mask, xu, 0.0),
                        out[1] + torch.where(bc_mask, xv, 0.0))

            # the affine map's residual at u = the BC values is the RHS
            # (the load and the nonzero-Dirichlet coupling)
            zu, zv = full((torch.zeros_like(H), torch.zeros_like(H)))
            R0 = free(assemble(zu, zv, nu_q, beta))
            rhs = (-R0[0], -R0[1])
            return free(bicgstab(graphed(matvec, *rhs), rhs, free(uv),
                                 jacobi(*diag(nu_q, beta))))

        for i in range(self.picard_warmup):
            uv = picard_iter(i, uv)

        # safeguarded Newton: line-search candidates against a Picard sweep
        alphas = torch.tensor([1.0, 0.5, 0.25, 0.0625, 0.01], dtype=dtype,
                              device=H.device)
        F = residual(uv)
        F2 = dot(F, F)
        F2prev = torch.full_like(F2, float("inf"))
        it = 0
        while it < self.newton_max \
                and host((F2 > tol2) & (F2 < 0.999 * F2prev)):
            u, v = full(uv)
            nu_q = nuH_q(u, v)
            beta = beta_fn(u, v)
            # linearized once a sweep, beta frozen at the sweep's iterate
            jvp_lin = linearized(u, v, beta)

            def jmv(du, dv):
                Jd = jvp_lin(*free((du, dv)))
                return (Jd[0] + torch.where(bc_mask, du, 0.0),
                        Jd[1] + torch.where(bc_mask, dv, 0.0))

            zero = (torch.zeros_like(F[0]), torch.zeros_like(F[1]))
            d = free(bicgstab(graphed(jmv, *F), (-F[0], -F[1]), zero,
                              jacobi(*diag(nu_q, beta))))

            cands = []
            for alpha in alphas:
                c = (uv[0] + alpha * d[0], uv[1] + alpha * d[1])
                Fc = residual(c)
                cands.append((c, Fc, dot(Fc, Fc)))
            uv_p = picard_iter(float(nwarm), uv)
            Fp = residual(uv_p)
            cands.append((uv_p, Fp, dot(Fp, Fp)))

            F2s = torch.stack([c[2] for c in cands])
            best = torch.argmin(F2s)     # the first minimum, as jnp.argmin
            pick = [torch.stack([c[k][i] for c in cands])[best]
                    for k in (0, 1) for i in (0, 1)]
            F2prev, F2 = F2, F2s[best]
            uv, F = (pick[0], pick[1]), (pick[2], pick[3])
            it += 1

        u, v = full(uv)
        if diagnostics:
            return u, v, {"newton_iters": it, "krylov_iters": krylov[0],
                          "residual2": F2, "tol2": tol2}
        return u, v
