"""SSA stress-balance solver: Newton-Krylov with Picard warmup (port of
``pism_tpu/model/ssa.py`` ``SSAFD``).

A few Picard sweeps with drag-regularization continuation enter the basin
(skipped on warm starts), then safeguarded Newton-Picard sweeps solve
J d = -F by line-preconditioned BiCGStab. The operator and the Newton
matvec are the hand-written kernels of ``ops/kernels/ssa_matvec.py``: K1
and ``ssa_newton_matvec`` on the whole field, or, with a ("y", "x")
``mesh`` of more than one device, K5 and ``ssa_newton_matvec_halo`` per
shard (``ops/sharded.py``; JAX ``pism_tpu/model/ssa.py:372-379``). On a
periodic grid both run as their padded-block instances on the whole field
wrap-padded (``ops/ssa.py``), where the JAX package takes its plain
operator; a mesh with a periodic grid raises NotImplementedError.

Without an enthalpy field (``energy.model = none``) the hardness is the
flow law's at zero enthalpy and pressure, as in the JAX package.

Static Dirichlet boundary conditions (``bc_mask``, ``bc_u``, ``bc_v``;
PISM ``-ssa_dirichlet_bc``) join the ice-free rows: their values are lifted
into the right-hand side of each Picard sweep (one more operator launch)
and the Newton matvec's Dirichlet rows take the joint mask.

Front treatment (PISM's calving-front stress boundary condition):
ice-free cells are Dirichlet u = 0 rows decoupled from the ice, no
membrane stress crosses icy<->ice-free faces, and the depth-integrated
pressure imbalance T_front = 1/2 g (rho_i H^2 - rho_w d^2) enters the
right-hand side of frontal cells.

Where the JAX package runs ``lax.while_loop`` / ``lax.cond`` on the device,
the port decides on the host, one ``.item()`` per decision (see
``util/hostsync.py``): the warmup loop and its skip test
(``pism_tpu/model/ssa.py:691-697``), the Krylov cap and the line-search
branch (``:773, :811``), the Newton/Picard fallback choice (``:883``) and
the Newton loop's stop test (``:950``), plus one per BiCGStab iteration.
Decisions are evaluated on the device in the field dtype, as in JAX.

Branches ported: float64 fields (float64 solve) and float32 fields with the
velocity-change stop active (the pure-f32 production solve). The ``mixed``
and ``float64``-island solves of float32 fields raise NotImplementedError;
so does the float64 polish, which only the ``mixed`` solve runs. The
preconditioner is ``line`` or ``mg`` (``ops/mg.py``, the multigrid V-cycle
of the verification tests). The drag Jacobian is ``picard`` (beta frozen)
or ``exact``: then the Newton matvec carries the drag tangent, dbeta (u, v)
with dbeta = c (u fu + v fv) and c = 2 dbeta/d|u|^2 of the sweep
(``physics/basal.py`` ``dbeta_coef``), in the same launch; the JAX package
differentiates beta inside ``jax.linearize`` (``differentiable_beta``).
``taud_x``/``taud_y`` prescribe the driving stress (tests I and J).

On an ensemble's member axis (``lead = 1``: fields ``(B, My, Mx)``, the
twin of the JAX solve under ``jax.vmap``) every member takes its own
warm-up, Newton sweeps, line search and Krylov iterations: each decision
above becomes one host read of a ``(B,)`` mask, members whose loop ended are
frozen by selects, and the kernels launch once for all members. A mesh, a
periodic grid, ``mg`` or the exact drag Jacobian there raises
NotImplementedError, as does the exact drag Jacobian under a mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import state as S
from ..config import require
from ..ops import mg, sharded
from ..ops import ssa as ssa_ops
from ..ops.kernels.ssa_matvec import ssa_newton_matvec
from ..ops.stencils import Shifter
from ..parallel.mesh import is_sharded, refuse_periodic_mesh
from ..physics.basal import SlidingLaw
from ..util.hostsync import host


@dataclass
class SSAFD:
    grid: object
    config: object
    flow_law: object
    sliding_law: Optional[SlidingLaw] = None
    # optional static Dirichlet BC: where bc_mask, the velocity is fixed to
    # (bc_u, bc_v) [m/s] (PISM -ssa_dirichlet_bc)
    bc_mask: Optional[torch.Tensor] = None
    bc_u: Optional[torch.Tensor] = None
    bc_v: Optional[torch.Tensor] = None
    # optional prescribed driving stress [Pa] (the verification tests
    # override the geometric driving stress, as PISM's SSATestCase does)
    taud_x: Optional[torch.Tensor] = None
    taud_y: Optional[torch.Tensor] = None
    # ("y", "x") Mesh: with more than one device the matvec and its JVP run
    # per shard through K5
    mesh: object = None
    lead: int = 0    # leading member dims of the fields (an ensemble's 1)

    def __post_init__(self):
        cfg = self.config
        require(cfg, "stress_balance.ssa.method", ("fd",))
        require(cfg, "stress_balance.ssa.fd.krylov_method", ("bicgstab",))
        if cfg.get_string("stress_balance.ssa.fd.preconditioner") == "linemg":
            raise NotImplementedError(
                "stress_balance.ssa.fd.preconditioner = 'linemg' is not "
                "implemented in pism_tpu_torch (ROADMAP Queue 1 item 11: its "
                "inner solves break down)")
        require(cfg, "stress_balance.ssa.fd.preconditioner", ("line", "mg"))
        require(cfg, "stress_balance.ssa.fd.line_pcr_impl",
                ("xla", "pallas_sublane"))
        require(cfg, "stress_balance.ssa.fd.line_pcr_dtype", ("f32",))
        require(cfg, "stress_balance.ssa.fd.line_block", (0,))
        require(cfg, "stress_balance.ssa.fd.drag_jacobian",
                ("picard", "exact"))
        require(cfg, "stress_balance.ssa.fd.pallas_matvec", ("auto", "on"))
        require(cfg, "stress_balance.ssa.fd.lateral_drag.enabled", (False,))
        require(cfg, "basal_resistance.beta_lateral_margin", (0.0,))
        require(cfg, "stress_balance.ssa.fd.extrapolate_initial_guess", (False,))
        self.pcr_impl = cfg.get_string("stress_balance.ssa.fd.line_pcr_impl")
        # the fracture softening of the hardness (Albrecht & Levermann
        # 2012; PISM SSAFD::compute_nuH), off at 1
        self.frac_soft_min = cfg.get_number(
            "fracture_density.softening_lower_limit")
        self.precond_kind = cfg.get_string("stress_balance.ssa.fd.preconditioner")
        self.exact_drag = cfg.get_string(
            "stress_balance.ssa.fd.drag_jacobian") == "exact"
        refuse_periodic_mesh(self.grid, self.mesh)
        self.periodic = (self.grid.periodic_y, self.grid.periodic_x)
        if self.lead and (self.mesh is not None or any(self.periodic)):
            raise NotImplementedError(
                "the SSA on an ensemble's member axis with a mesh or a "
                "periodic grid is not implemented in pism_tpu_torch (ROADMAP "
                "Queue 1 item 3)")
        if self.lead and (self.exact_drag or self.precond_kind == "mg"):
            raise NotImplementedError(
                "drag_jacobian = exact and preconditioner = mg on an "
                "ensemble's member axis are not implemented in "
                "pism_tpu_torch (ROADMAP Queue 1 item 3)")
        if self.exact_drag and is_sharded(self.mesh):
            raise NotImplementedError(
                "drag_jacobian = exact under a mesh is not implemented in "
                "pism_tpu_torch (ROADMAP Queue 1 item 10)")
        self.sh = Shifter(self.grid, self.lead)
        self.n_glen = cfg.get_number("stress_balance.ssa.Glen_exponent")
        self.e_ssa = cfg.get_number("stress_balance.ssa.enhancement_factor")
        self.rho = cfg.get_number("constants.ice.density")
        self.rho_w = cfg.get_number("constants.sea_water.density")
        self.g = cfg.get_number("constants.standard_gravity")
        self.picard_warmup = cfg.get_int("stress_balance.ssa.fd.picard_warmup")
        self.newton_rtol = cfg.get_number("stress_balance.ssa.fd.newton_rtol")
        # the reference's stress_balance.ssa.fd.max_iterations wins over
        # newton_max_iterations when explicitly set
        self.newton_max = cfg.get_int(
            "stress_balance.ssa.fd.max_iterations"
            if cfg.is_set("stress_balance.ssa.fd.max_iterations")
            else "stress_balance.ssa.fd.newton_max_iterations")
        self.ksp_rtol = cfg.get_number("stress_balance.ssa.fd.ksp_rtol")
        self.near_ksp_cap = cfg.get_int("stress_balance.ssa.fd.near_ksp_cap")
        self.safeguard_ksp_cap = cfg.get_int(
            "stress_balance.ssa.fd.safeguard_ksp_cap")
        self.f32_production_rtol = cfg.get_number(
            "stress_balance.ssa.fd.f32_production_rtol")
        self.ksp_rtol_max = cfg.get_number("stress_balance.ssa.fd.ksp_rtol_max")
        self.warmup_ksp_rtol = cfg.get_number("stress_balance.ssa.fd.warmup_ksp_rtol")
        self.warmup_skip_rtol = cfg.get_number("stress_balance.ssa.fd.warmup_skip_rtol")
        self.eta_endgame_range = cfg.get_number(
            "stress_balance.ssa.fd.eta_endgame_range")
        self.ksp_max = cfg.get_int("stress_balance.ssa.fd.ksp_max_it")
        self.epsilon = cfg.get_number("stress_balance.ssa.epsilon")  # Pa s m
        ext_nu = cfg.get_number("stress_balance.ssa.strength_extension.constant_nu")
        ext_H = cfg.get_number("stress_balance.ssa.strength_extension.min_thickness")
        self.extension_nuH = ext_nu * ext_H
        self.extension_Hmin = ext_H
        svel = cfg.get_number("stress_balance.ssa.Schoof_regularizing_velocity", "m s-1")
        slen = cfg.get_number("stress_balance.ssa.Schoof_regularizing_length", "m")
        self.eps_reg2 = (svel / slen) ** 2
        # tiny drag on every icy cell: keeps rows of isolated floating cells
        # (not yet removed by the iceberg remover) non-singular
        self.beta_floor = cfg.get_number("stress_balance.ssa.fd.beta_floor")
        self.max_speed = cfg.get_number("stress_balance.ssa.fd.max_speed", "m s-1")
        self.subgl_drag = cfg.get_flag("geometry.grounded_cell_fraction")
        self.chg_rtol = cfg.get_number("stress_balance.ssa.fd.velocity_change_rtol")
        self.solve_dtype = cfg.get_string("stress_balance.ssa.fd.solve_dtype")
        if self.solve_dtype == "auto":
            self.solve_dtype = "float32" if self.chg_rtol > 0.0 else "mixed"
        if cfg.get_string("runtime.float_dtype") == "float32" \
                and self.solve_dtype != "float32":
            raise NotImplementedError(
                f"the {self.solve_dtype!r} SSA solve of float32 fields is not "
                "implemented in pism_tpu_torch (set "
                "stress_balance.ssa.fd.velocity_change_rtol > 0 and "
                "solve_dtype = auto or float32)")
        self.krylov_dot_dtype = cfg.get_string(
            "stress_balance.ssa.fd.krylov_dot_dtype")
        if self.sliding_law is None:
            self.sliding_law = SlidingLaw.from_config(cfg)

    # ------------------------------------------------------------------
    def driving_stress(self, geometry, icy):
        """tau_d = -rho g H grad(s); one-sided at ice margins."""
        sh = self.sh
        s = geometry.ice_surface_elevation
        H = geometry.ice_thickness

        def masked_grad(jy, ix, d):
            icy_p, icy_m = sh(icy, jy, ix), sh(icy, -jy, -ix)
            s_p, s_m = sh(s, jy, ix), sh(s, -jy, -ix)
            centered = (s_p - s_m) / (2.0 * d)
            one_p = (s_p - s) / d      # only + neighbor icy
            one_m = (s - s_m) / d      # only - neighbor icy
            return torch.where(icy_p & icy_m, centered,
                               torch.where(icy_p, one_p,
                                           torch.where(icy_m, one_m, 0.0)))

        sx = masked_grad(0, 1, self.grid.dx)
        sy = masked_grad(1, 0, self.grid.dy)
        f = -self.rho * self.g * H
        return f * sx, f * sy

    def _hardness(self, state: S.ModelState):
        H = state.geometry.ice_thickness
        if state.enthalpy is None:
            B = self.flow_law.hardness(torch.zeros_like(H), torch.zeros_like(H))
        else:
            z = torch.as_tensor(self.grid.z, dtype=H.dtype, device=H.device)
            B = self.flow_law.averaged_hardness(H, state.enthalpy, z)
        # SSA enhancement factor scales softness: B -> B * e^(-1/n)
        B = B * self.e_ssa ** (-1.0 / self.n_glen)
        # fracture softening: softness A -> A (1 - (1-eps) phi)^(-n), i.e.
        # B -> B max(1 - (1-eps) phi, eps)
        phi = state.fracture_density
        if phi is not None and self.frac_soft_min != 1.0:
            eps = self.frac_soft_min
            B = B * torch.clamp(1.0 - (1.0 - eps) * phi.to(B.dtype), min=eps)
        return B

    def _front_stress(self, geometry, water_column_pressure=None):
        """T_front = 1/2 g (rho_i H^2 - rho_w d^2) per cell [Pa m]; with an
        ocean model's front water-column pressure P_w (melange back
        pressure) H (1/2 g rho_i H - P_w)."""
        H = geometry.ice_thickness
        if water_column_pressure is not None:
            Pw = water_column_pressure.to(H.dtype)
            return H * (0.5 * self.g * self.rho * H - Pw)
        mu = self.rho / self.rho_w
        d = torch.minimum(
            torch.clamp(geometry.sea_level - geometry.bed_elevation, min=0.0),
            mu * H)
        return 0.5 * self.g * (self.rho * H ** 2 - self.rho_w * d ** 2)

    # ------------------------------------------------------------------
    def build_problem(self, state: S.ModelState, tau_c=None,
                      hardness=None, water_column_pressure=None) -> dict:
        """Masks, right-hand side (driving stress + calving-front terms) and
        the nonlinear residual closure.

        ``hardness``: the vertically averaged hardness B to use as given,
        without the SSA enhancement factor (the design variable of the
        hardness inversion, as in the JAX package). The residual keeps the
        derivative of beta with respect to (u, v) and tau_c, and where
        autograd records it, its operator goes through ``SSAMatvec`` (or the
        periodic route's ``SSAMatvecHalo``), whose backward is the VJP
        kernel: the inverse toolkit differentiates it in reverse mode."""
        sh = self.sh
        geom = state.geometry
        H = geom.ice_thickness
        mask = geom.cell_type
        dtype = H.dtype
        dx, dy = self.grid.dx, self.grid.dy

        icy = S.icy(mask)
        B = self._hardness(state) if hardness is None \
            else torch.as_tensor(hardness, dtype=dtype, device=H.device)
        if self.taud_x is not None:
            bx, by = self.taud_x.to(dtype), self.taud_y.to(dtype)
        else:
            bx, by = self.driving_stress(geom, icy)

        # calving-front pressure-imbalance terms on front faces
        Tf = self._front_stress(geom, water_column_pressure)
        icy_e, icy_w = sh(icy, 0, 1), sh(icy, 0, -1)
        icy_n, icy_s = sh(icy, 1, 0), sh(icy, -1, 0)
        bx = bx + torch.where(icy & ~icy_e, Tf / dx, 0.0) \
            - torch.where(icy & ~icy_w, Tf / dx, 0.0)
        by = by + torch.where(icy & ~icy_n, Tf / dy, 0.0) \
            - torch.where(icy & ~icy_s, Tf / dy, 0.0)

        # stress transmitted only across icy-icy faces
        keep_e = (icy & icy_e).to(dtype)
        keep_n = (icy & icy_n).to(dtype)
        extension_mask = icy & (H < self.extension_Hmin)

        if tau_c is None:
            tau_c = torch.zeros_like(H)
        grounded_ice_mask = S.grounded_ice(mask)
        gf = geom.cell_grounded_fraction if self.subgl_drag else None

        # Dirichlet rows: ice-free cells (decoupled, value 0) and the static
        # BC; free() zeroes them, full() puts in their values (without a BC
        # the two coincide)
        bc_u = bc_v = None
        if self.bc_mask is not None:
            fixed = self.bc_mask.to(torch.bool)
            bc_mask = fixed | ~icy
            bc_u = torch.where(fixed, self.bc_u.to(dtype), 0.0)
            bc_v = torch.where(fixed, self.bc_v.to(dtype), 0.0)
        else:
            bc_mask = ~icy

        def free(x):
            return (torch.where(bc_mask, 0.0, x[0]),
                    torch.where(bc_mask, 0.0, x[1]))

        def full(x):
            if bc_u is None:
                return free(x)
            return (torch.where(bc_mask, bc_u, x[0]),
                    torch.where(bc_mask, bc_v, x[1]))

        nuH_kw = dict(n_glen=self.n_glen, eps_reg2=self.eps_reg2,
                      extension_nuH=self.extension_nuH,
                      extension_mask=extension_mask)

        def make_nuH(u, v):
            nuH = ssa_ops.compute_nuH(u, v, B, H, dx, dy, sh, **nuH_kw)
            return ssa_ops.NuH((nuH.e + self.epsilon) * keep_e,
                               (nuH.n + self.epsilon) * keep_n)

        def linearize_nuH(u, v):
            """make_nuH at (u, v) and the coefficient planes of its
            forward-mode derivative: (a1, a2, a3, k) on a last axis, east
            and north, with keep folded into k (exact: keep is 0 or 1)."""
            nuH, tangent = ssa_ops.linearize_nuH(u, v, B, H, dx, dy, sh,
                                                 **nuH_kw)
            coefs = tuple(torch.stack((*c[:3], c[3] * keep), -1)
                          for c, keep in ((tangent.e, keep_e),
                                          (tangent.n, keep_n)))
            return ssa_ops.NuH((nuH.e + self.epsilon) * keep_e,
                               (nuH.n + self.epsilon) * keep_n), coefs

        if gf is not None:
            tc_eff = tau_c * torch.where(icy, gf, 0.0)
        else:
            tc_eff = torch.where(grounded_ice_mask, tau_c, 0.0)

        def beta_fn(u, v, reg=None):
            return self.sliding_law.beta(tc_eff, u, v, reg=reg) + self.beta_floor

        def drag_tangent(u, v):
            """The drag tangent's plane of the exact drag Jacobian at (u, v)
            (beta_floor has no derivative), or None with beta frozen."""
            if not self.exact_drag:
                return None
            return self.sliding_law.dbeta_coef(tc_eff, u, v)

        # the operator, and the Newton matvec: A(free d; nuH, beta) + A(u;
        # dnuH(free d), dbeta(free d)) on the free rows and d on the
        # Dirichlet rows, one launch (per shard); dbeta = 0 with beta frozen
        mesh = self.mesh if is_sharded(self.mesh) else None
        periodic = self.periodic

        def apply_op(u, v, nuH, beta):
            if mesh is not None:
                return sharded.ssa_matvec_sharded(u, v, nuH.e, nuH.n, beta,
                                                  mesh, dx, dy)
            return ssa_ops.apply_operator(u, v, nuH, beta, dx, dy, periodic)

        def newton_matvec(u, v, nuH, coefs, beta):
            """jmv(d) of the sweep linearized at (u, v); under a mesh, or
            on a periodic grid, the linearization is padded here, once."""
            drag = drag_tangent(u, v)
            if mesh is not None:
                mv = sharded.ssa_newton_matvec_sharded(
                    u, v, nuH.e, nuH.n, *coefs, beta, bc_mask, mesh, dx, dy)
                return lambda d: mv(*d)
            if any(periodic):
                mv = ssa_ops.ssa_newton_matvec_periodic(
                    u, v, nuH.e, nuH.n, *coefs, beta, bc_mask, dx, dy,
                    periodic, drag)
                return lambda d: mv(*d)
            return lambda d: ssa_newton_matvec(u, v, d[0], d[1], nuH.e, nuH.n,
                                               *coefs, beta, bc_mask, dx, dy,
                                               drag)

        def residual(uv):
            u, v = full(uv)
            nuH = make_nuH(u, v)
            Au, Av = apply_op(u, v, nuH, beta_fn(u, v))
            return free((Au - bx, Av - by))

        return dict(residual=residual, free=free, full=full,
                    make_nuH=make_nuH, linearize_nuH=linearize_nuH,
                    beta_fn=beta_fn, apply=apply_op,
                    newton_matvec=newton_matvec, bc_mask=bc_mask,
                    bc_u=bc_u, bc_v=bc_v, bx=bx, by=by, icy=icy, tau_c=tau_c)

    def solve(self, state: S.ModelState, tau_c=None, u0=None, v0=None,
              diagnostics: bool = False, active=None, hardness=None,
              water_column_pressure=None):
        """Solve for (u, v). With ``diagnostics=True`` also return a dict with
        the Newton sweep count, the total Krylov iterations (host ints) and
        the residual norms, as the JAX package's ``info``.

        On an ensemble's member axis (``lead`` = 1) every member runs its own
        warm-up, Newton sweeps and Krylov iterations in lockstep, the
        ``vmap`` of the JAX solve: each host decision reads one (B,) mask, a
        member whose loop ended is frozen (a select keeps its iterate), and
        a branch that only some members take is evaluated for all and
        selected. ``active`` (a host list of B bools) leaves the other
        members at their initial guess (members the ensemble's step
        discards). The counts are then lists, one per member, and the
        diagnostics add ``lockstep_newton`` and ``lockstep_krylov``, the
        sweeps and Krylov iterations the lockstep ran. ``hardness``
        replaces B as ``build_problem`` says; ``water_column_pressure`` is
        the front's water-column pressure of ``_front_stress``."""
        geom = state.geometry
        H = geom.ice_thickness
        dtype = H.dtype
        dx, dy = self.grid.dx, self.grid.dy
        sh = self.sh
        lead = self.lead
        if dtype != torch.float64 and self.solve_dtype != "float32":
            raise NotImplementedError(
                f"the {self.solve_dtype!r} SSA solve of {dtype} fields is not "
                "implemented in pism_tpu_torch")

        P = self.build_problem(state, tau_c, hardness, water_column_pressure)
        apply_op, free, residual = P["apply"], P["free"], P["residual"]
        full, bc_u, bc_v = P["full"], P["bc_u"], P["bc_v"]
        make_nuH, beta_fn = P["make_nuH"], P["beta_fn"]
        linearize_nuH = P["linearize_nuH"]
        bc_mask, bx, by = P["bc_mask"], P["bx"], P["by"]
        newton_matvec = P["newton_matvec"]
        chg_rtol_cfg = self.chg_rtol

        kdd = self.krylov_dot_dtype
        if kdd == "auto":
            kdd = "float32" if (chg_rtol_cfg > 0.0
                                and self.solve_dtype == "float32") else "float64"
        ddt = torch.float64 if dtype == torch.float32 and kdd == "float64" \
            else None

        def dot(a, b_):
            return ssa_ops._dot(a, b_, ddt, lead)

        def rel_change2(uv_new, uv):
            """|uv_new - uv|^2 / |uv_new|^2 (on the member axis both dots
            in one launch)."""
            d_ = (uv_new[0] - uv[0], uv_new[1] - uv[1])
            dd, uu = ssa_ops._dots(d_, uv_new, ("xx", "yy"), ddt, lead)
            return dd / torch.clamp(uu, min=1e-300)

        def col(s):
            return ssa_ops.member_col(s, lead)

        def where2(take, a, b_):
            return (torch.where(col(take), a[0], b_[0]),
                    torch.where(col(take), a[1], b_[1]))

        def make_precond(nuH, beta):
            if self.precond_kind == "mg":
                return mg.make_preconditioner(nuH, beta, bc_mask, dx, dy,
                                              self.periodic)
            return ssa_ops.make_line_preconditioner(nuH, beta, bc_mask,
                                                    dx, dy, sh, self.pcr_impl)

        def zeros_where_bc(x):
            return (torch.where(bc_mask, x[0], 0.0),
                    torch.where(bc_mask, x[1], 0.0))

        u_init = u0 if u0 is not None else (
            state.u_ssa if state.u_ssa is not None else torch.zeros_like(H))
        v_init = v0 if v0 is not None else (
            state.v_ssa if state.v_ssa is not None else torch.zeros_like(H))
        uv = free((u_init, v_init))

        fb = free((bx, by))
        b_norm2 = dot(fb, fb)
        if dtype == torch.float64:
            rtol = self.newton_rtol
        else:
            # pure f32 carry: production target 3e-4 when the velocity-
            # change stop governs (the f32 residual floor is ~1-2e-4)
            rtol = max(self.newton_rtol,
                       self.f32_production_rtol if chg_rtol_cfg > 0.0
                       else 3.0e-5)
        newton_tol2 = torch.clamp(rtol ** 2 * b_norm2, min=1e-300)
        # near-tolerance heuristics (Krylov cap, newton_or_keep) only on the
        # pure-f32 production path
        noisy_floor = chg_rtol_cfg > 0.0 and dtype != torch.float64

        # every host decision below reads one flag per member (a list of one
        # in a single solve); a branch that only some members take is
        # evaluated for all of them and selected by the flags' device mask
        if lead:
            n = H.shape[0]
            active = [True] * n if active is None else list(active)
            act_d = torch.tensor(active, device=H.device)
        else:
            n, active, act_d = 1, [True], None

        def read(cond):
            flags = host(cond)
            return flags if lead else [flags]

        def pick(flags, mask, a, b_, members=active):
            """``a`` for the members whose flag is set, else ``b_`` (pairs of
            fields, per-member scalars, tuples of them): no select when the
            flags of ``members`` agree (the others' results are discarded),
            else by the device mask ``mask()``."""
            relevant = [f for f, m in zip(flags, members) if m]
            if all(relevant):
                return a
            if not any(relevant):
                return b_
            return ssa_ops.member_select(mask(), a, b_)

        def caps(cap, members):
            """The Krylov bound: per member (0 off ``members``), or a host
            int in a single solve."""
            return [cap if m else 0 for m in members] if lead else cap

        # ---- Picard warmup with drag-regularization continuation --------
        reg0 = 1000.0 / 3.15569259747e7   # m/s
        reg_final = self.sliding_law.plastic_reg
        nwarm = max(self.picard_warmup, 1)
        decay = (reg_final / reg0) ** (1.0 / nwarm)

        def picard_iter(i, uv, reg=None, max_iter=None):
            u, v = full(uv)
            nuH = make_nuH(u, v)
            if reg is None:
                reg = max(reg0 * decay ** (i + 1.0), reg_final)
            beta = beta_fn(u, v, reg=reg)

            def matvec(x):
                xu, xv = free(x)
                out = free(apply_op(xu, xv, nuH, beta))
                bc = zeros_where_bc(x)
                return out[0] + bc[0], out[1] + bc[1]

            rhs = (bx, by)
            if bc_u is not None:
                # the lift of the Dirichlet values into the RHS (ice-free
                # rows are 0 and need none)
                Aub, Avb = apply_op(bc_u, bc_v, nuH, beta)
                rhs = (bx - Aub, by - Avb)
            sol, _, _ = ssa_ops.bicgstab_solve(
                matvec, free(rhs), free(uv), make_precond(nuH, beta),
                rtol=self.warmup_ksp_rtol,
                max_iter=self.ksp_max if max_iter is None else max_iter,
                dot_dtype=ddt, lead=lead)
            return free(sol)

        # warm-start detection: skip the continuation when the initial true
        # residual is already below warmup_skip_rtol * |b|
        F0_pre = residual(free(uv))
        F20_pre = dot(F0_pre, F0_pre)
        skip_d = F20_pre < self.warmup_skip_rtol ** 2 * b_norm2
        skip_warmup = read(skip_d)
        # adaptive warmup: a member stops once a sweep moves it < 3%; the
        # sweeps' Krylov loops skip the members out of it
        warm = [a and not s for a, s in zip(active, skip_warmup)]
        warmed = any(warm)
        warm_d = ~skip_d if act_d is None else ~skip_d & act_d
        i = 0
        while i < self.picard_warmup and any(warm):
            uv_new = picard_iter(i, uv, max_iter=caps(self.ksp_max, warm))
            chg2 = rel_change2(uv_new, uv)
            uv = pick(warm, lambda: warm_d, uv_new, uv)
            i += 1
            if i < self.picard_warmup:
                warm_d = warm_d & (chg2 > 0.03 ** 2)
                warm = read(warm_d)

        # ---- safeguarded Newton-Picard ----------------------------------
        alphas = torch.tensor([1.0, 0.5, 0.25, 0.0625, 0.01], dtype=dtype,
                              device=H.device)
        stag = 0.999
        if dtype == torch.float64:
            chg_tol = 1e-8
        else:
            chg_tol = 1e-4
        if chg_rtol_cfg > 0.0:
            chg_tol = max(chg_tol, chg_rtol_cfg)
        chg_tol2 = chg_tol ** 2

        if not warmed:
            F, F2 = F0_pre, F20_pre
        else:
            # (a member that skipped the warm-up gets its F0_pre again)
            F = residual(uv)
            F2 = dot(F, F)
        F20 = F2
        chg2 = torch.ones_like(F2)
        F2prev = torch.full_like(F2, float("inf"))
        eta_c = torch.full_like(F2, self.ksp_rtol_max)
        it, lock_krylov = 0, 0
        ktot, sweeps = [0] * n, [0] * n
        hist = []
        going_d, going = act_d, active

        def keep_going():
            nonlocal going_d, going
            if it >= self.newton_max:
                return False
            improving = (F2 < stag * F2prev) & (chg2 > chg_tol2)
            # a stagnated loose-tolerance sweep is retried tighter, while
            # the residual is far (>100x) above tolerance
            retry = (eta_c > self.ksp_rtol * 1.01) & (F2 > 1e4 * newton_tol2)
            if chg_rtol_cfg > 0.0:
                retry = retry & (chg2 > chg_tol2)   # the hard velocity stop
            go = (F2 > newton_tol2) & (improving | retry)
            # a member that stopped stays stopped
            going_d = go if going_d is None else going_d & go
            going = read(going_d)
            return any(going)

        while keep_going():
            u, v = full(uv)
            # Newton linearization built by hand once per sweep: J d = A(d;
            # nuH, beta) + A(u; dnuH(d), dbeta(d)) with dnuH the forward-mode
            # derivative of the plain make_nuH and dbeta that of beta (0
            # with the Picard drag Jacobian, beta frozen), one launch per
            # matvec
            nuH, coefs = linearize_nuH(u, v)
            beta = beta_fn(u, v)
            precond = make_precond(nuH, beta)
            jmv = newton_matvec(u, v, nuH, coefs, beta)

            # Eisenstat-Walker (choice 2) forcing, clamped to
            # [ksp_rtol, ksp_rtol_max]; tightened 30x after a stagnated sweep
            finite = torch.isfinite(F2prev)
            ratio2 = F2 / torch.where(finite, F2prev, F2)
            eta = 0.9 * ratio2 ** 0.809
            eta = torch.where(finite, eta, self.ksp_rtol_max)
            eta = torch.where(F2 < stag * F2prev, eta, eta_c / 30.0)
            eta = torch.clamp(eta, self.ksp_rtol, self.ksp_rtol_max)
            if self.eta_endgame_range > 0.0:
                # endgame: once |F| <= range * tol, solve tight enough to
                # land at ~tol/2 in one sweep
                eta_finish = 0.5 * torch.sqrt(
                    newton_tol2 / torch.clamp(F2, min=1e-300))
                near = F2 < self.eta_endgame_range ** 2 * newton_tol2
                eta = torch.where(
                    near, torch.clamp(eta_finish, self.ksp_rtol,
                                      self.ksp_rtol_max), eta)

            negF = (-F[0], -F[1])
            zero = (torch.zeros_like(negF[0]), torch.zeros_like(negF[1]))
            # near-tolerance Krylov cap: |F| within 32x of target
            cap = [self.ksp_max] * n
            if noisy_floor:
                near_cap = min(self.near_ksp_cap, self.ksp_max)
                cap = [near_cap if c else self.ksp_max
                       for c in read(F2 < 1024.0 * newton_tol2)]
            kmax = [c if g else 0 for c, g in zip(cap, going)] if lead \
                else cap[0]
            d, kit, _ = ssa_ops.bicgstab_solve(
                jmv, negF, zero, precond, rtol=eta, max_iter=kmax,
                dot_dtype=ddt, lead=lead)
            kit = kit if lead else [kit]
            d = free(d)

            def trial_norm(alpha):
                Fc = residual((uv[0] + alpha * d[0], uv[1] + alpha * d[1]))
                return dot(Fc, Fc)

            # full step first; backtracking only when alpha = 1 fails
            # sufficient decrease
            n1 = trial_norm(alphas[0])
            full_d = n1 < 0.5 * F2
            if all(f for f, g in zip(read(full_d), going) if g):
                ak = alphas[0]
            else:
                norms = torch.stack([n1] + [trial_norm(alphas[k])
                                            for k in range(1, len(alphas))])
                ak = alphas[torch.argmin(norms)] if not lead else torch.where(
                    full_d, alphas[0], alphas[torch.argmin(norms, dim=0)])
            newton_uv = (uv[0] + col(ak) * d[0], uv[1] + col(ak) * d[1])
            F_newton = residual(newton_uv)
            newton_F2 = dot(F_newton, F_newton)

            suff_d = newton_F2 < 0.5 * F2
            sufficient = read(suff_d)
            fallback = [g and not s for g, s in zip(going, sufficient)]
            near, near_d = [False] * n, None
            if noisy_floor and any(fallback):
                near_d = F2 < 16.0 * newton_tol2
                near = read(near_d)
            new = (newton_uv, F_newton, newton_F2)
            keep = [f and e for f, e in zip(fallback, near)]
            if any(keep):
                # near tolerance: accept an improving Newton step or keep
                take = newton_F2 < F2
                new = pick(keep, lambda: ~suff_d & near_d,
                           (where2(take, newton_uv, uv),
                            where2(take, F_newton, F),
                            torch.where(take, newton_F2, F2)), new, going)
            picard = [f and not e for f, e in zip(fallback, near)]
            if any(picard):
                # Picard safeguard: a frozen-coefficient sweep to the warmup
                # tolerance; Newton only if it beats both
                cap = (min(self.safeguard_ksp_cap, self.ksp_max)
                       if noisy_floor else self.ksp_max)
                picard_uv = free(picard_iter(0, uv, reg=reg_final,
                                             max_iter=caps(cap, picard)))
                picard_F = residual(picard_uv)
                picard_F2 = dot(picard_F, picard_F)
                take_newton = (newton_F2 < picard_F2) & (newton_F2 < F2)
                # allow moderate residual increases only
                picard_ok = picard_F2 < 1e2 * F2
                cand_uv = where2(picard_ok, picard_uv, uv)
                cand_F = where2(picard_ok, picard_F, F)
                cand_F2 = torch.where(picard_ok, picard_F2, F2)
                new = pick(picard, lambda: ~suff_d if near_d is None
                           else ~suff_d & ~near_d,
                           (where2(take_newton, newton_uv, cand_uv),
                            where2(take_newton, F_newton, cand_F),
                            torch.where(take_newton, newton_F2, cand_F2)),
                           new, going)
            uv_new, F_new, F2_new = new
            # stagnation measure: relative velocity change of this sweep
            chg2_new = rel_change2(uv_new, uv)
            if diagnostics:
                hist.append((F2_new / torch.clamp(b_norm2, min=1e-300),
                             chg2_new, eta, kit, ak, sufficient))
            # the members that stopped keep their iterate
            uv, F, F2prev, F2, chg2, eta_c = pick(
                going, lambda: going_d,
                (uv_new, F_new, F2, F2_new, chg2_new, eta),
                (uv, F, F2prev, F2, chg2, eta_c))
            it += 1
            ktot = [k + c for k, c in zip(ktot, kit)]
            sweeps = [w + g for w, g in zip(sweeps, going)]
            lock_krylov += max(kit)

        u, v = full(uv)
        u = torch.clamp(u, -self.max_speed, self.max_speed)
        v = torch.clamp(v, -self.max_speed, self.max_speed)
        if diagnostics:
            info = {"newton_iters": sweeps if lead else it,
                    "krylov_iters": ktot if lead else ktot[0],
                    "F2_initial": F20, "F2_final": F2,
                    "F2_warmstart": F20_pre,
                    "warmup_skipped": skip_warmup if lead else skip_warmup[0],
                    "b_norm2": b_norm2, "tol2": newton_tol2,
                    "trace": hist}
            if lead:
                info.update(lockstep_newton=it, lockstep_krylov=lock_krylov)
            return u, v, info
        return u, v
