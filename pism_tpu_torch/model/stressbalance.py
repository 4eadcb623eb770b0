"""Composite stress balance (port of ``pism_tpu/model/stressbalance.py``,
every value of ``stress_balance.model``): the sliding velocity (the SSA's
with ``ssa`` and ``ssa+sia``, the Weertman law's, the prescribed fields;
``sia`` and ``none`` carry the state's own, if any), the SIA diffusive
flux on the bed-smoothed geometry (zero without an SIA), and (for the
energy model) the 3D velocities, strain heating and, with an SSA, basal
frictional heating. Without an energy model (``compute_3d = False``) the
result holds the sliding velocities and the 2D maxima only.

``blatter`` replaces all of it by the 3D Blatter-Pattyn solve
(``model/blatter.py``): its vertical mean advects the ice (no diffusive
flux), its bottom level is the sliding velocity, and for the energy model
its field regridded to the z levels, w from incompressibility, its
dissipation as the strain heating and the frictional heating of the
bottom level.

The SIA takes every surface-gradient method (``mahaffy``, ``haseloff``,
``eta``) and, with ``stress_balance.sia.e_age_coupling``, a 3D enhancement
field from the ice's depositional time t - age (``age_enhancement``);
the 3D vertical velocity's divergence is centered or ``upstream``
(``stress_balance.vertical_velocity_approximation``); ``-brutal_sliding``
scales the SSA's velocity.

On an ensemble's member axis (``lead = 1``) both models run on
``(B, My, Mx[, Mz])`` fields with per-member maxima; with ``ssa+sia`` the
SSA solve (built with the same ``lead``) converges per member in lockstep
and its counts are per member. The Weertman and prescribed-sliding
branches and ``blatter`` raise NotImplementedError there and under a
sharded mesh, ``ssa`` and ``none`` on the member axis.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import NamedTuple, Optional

import torch

from .. import state as S
from ..config import require
from ..ops import bedsmoother as bsm
from ..ops import sia as sia_ops
from ..ops import sia3d
from ..ops import stencils as st
from ..ops.stencils import Shifter
from ..parallel.mesh import refuse_member_axis_and_mesh, refuse_periodic_mesh
from . import geometry_evolution as ge

#: the values of ``stress_balance.model``
MODELS = ("ssa+sia", "ssa", "sia", "none", "blatter", "weertman_sliding",
          "weertman_sliding+sia", "prescribed_sliding",
          "prescribed_sliding+sia")


class StressBalanceResult(NamedTuple):
    qe: torch.Tensor          # staggered diffusive (SIA) flux [m^2/s]
    qn: torch.Tensor
    u_face_e: torch.Tensor    # face-normal advective (sliding) velocity
    v_face_n: torch.Tensor
    u_base: torch.Tensor      # cell-centered sliding velocity
    v_base: torch.Tensor
    max_diffusivity: torch.Tensor
    u_ssa: Optional[torch.Tensor]   # SSA velocity (next step's warm start);
    v_ssa: Optional[torch.Tensor]   # None without an SSA
    sia3: Optional[sia3d.SIA3D]
    basal_frictional_heating: Optional[torch.Tensor]
    ssa_newton_iters: int = 0   # Newton sweeps of this SSA solve
    ssa_krylov_iters: int = 0   # BiCGStab iterations of this SSA solve
    # on the member axis the two above are lists (one count per member),
    # and these the sweeps and Newton-Krylov iterations the lockstep ran
    ssa_lockstep_newton: int = 0
    ssa_lockstep_krylov: int = 0


@dataclass
class StressBalance:
    grid: object
    config: object
    sia_flow_law: object
    ssa: object = None
    blatter: object = None    # BlatterSolver (model = blatter)
    compute_3d: bool = True
    # ("y", "x") Mesh: the SIA kernel routes run per shard under it
    mesh: object = None
    lead: int = 0    # leading member dims of the fields (an ensemble's 1)
    # per-cell linear sliding coefficient mu [m s^-1 Pa^-1] of the Weertman
    # branch, u_b = -mu tau_d (EISMINT II experiment E's sector)
    sliding_mu: object = None
    # the sliding velocity of prescribed_sliding[+sia] [m/s]
    prescribed_u: object = None
    prescribed_v: object = None

    def __post_init__(self):
        cfg = self.config
        require(cfg, "stress_balance.model", MODELS)
        self.model = cfg.get_string("stress_balance.model")
        # ``run`` reads the SIA's max(D) for the max_diffusivity stop
        self.has_sia = "sia" in self.model.split("+")
        self.sliding = self.model.split("+")[0] \
            if self.model.startswith(("weertman", "prescribed")) else None
        if self.sliding is not None or self.model in ("blatter", "ssa",
                                                       "none"):
            # ssa and none run under a mesh (the SSA refuses what it must)
            refuse_member_axis_and_mesh(
                f"stress_balance.model = {self.model!r}", self.lead,
                None if self.model in ("ssa", "none") else self.mesh)
        if self.sliding == "weertman_sliding":
            self.k_weertman = cfg.get_number(
                "stress_balance.weertman_sliding.k")
            self.m_weertman = cfg.get_number(
                "stress_balance.weertman_sliding.exponent")
            self.melt_only = cfg.get_flag(
                "stress_balance.weertman_sliding.melt_only")
        elif self.sliding == "prescribed_sliding" \
                and self.prescribed_u is None:
            raise ValueError("stress_balance.model = prescribed_sliding needs "
                             "the prescribed_u and prescribed_v fields")
        if self.model == "blatter" and self.blatter is None:
            raise ValueError("stress_balance.model = blatter needs a "
                             "BlatterSolver")
        if self.ssa is not None and self.ssa.lead != self.lead:
            raise ValueError("the SSA and the stress balance take different "
                             "member dims")
        self.w_approx = cfg.get_string(
            "stress_balance.vertical_velocity_approximation")
        if self.w_approx not in ("centered", "upstream"):
            raise ValueError(
                "stress_balance.vertical_velocity_approximation = "
                f"{self.w_approx!r}: expected centered | upstream")
        # PISM -brutal_sliding: the SSA's sliding speeds times a constant
        self.brutal_scale = cfg.get_number(
            "stress_balance.ssa.fd.brutal_sliding_scale") \
            if cfg.get_flag("stress_balance.ssa.fd.brutal_sliding") else None
        # the age-coupled interglacial enhancement: ice deposited in the
        # Eemian or after the Holocene's onset flows with
        # enhancement_factor_interglacial instead of e_sia
        self.e_age_coupling = cfg.get_flag("stress_balance.sia.e_age_coupling")
        if self.e_age_coupling and not cfg.get_flag("age.enabled"):
            raise ValueError(
                "stress_balance.sia.e_age_coupling requires age.enabled")
        self.e_sia_interglacial = cfg.get_number(
            "stress_balance.sia.enhancement_factor_interglacial")
        self.eemian_start = cfg.get_number("time.eemian_start", "seconds")
        self.eemian_end = cfg.get_number("time.eemian_end", "seconds")
        self.holocene_start = cfg.get_number("time.holocene_start", "seconds")
        require(cfg, "stress_balance.sia.surface_gradient_method",
                ("eta", "haseloff", "mahaffy"))
        refuse_periodic_mesh(self.grid, self.mesh)
        self.sh = Shifter(self.grid, self.lead)
        self.n_sia = cfg.get_number("stress_balance.sia.Glen_exponent")
        self.e_sia = cfg.get_number("stress_balance.sia.enhancement_factor")
        self.rho = cfg.get_number("constants.ice.density")
        self.g = cfg.get_number("constants.standard_gravity")
        self.gradient_method = cfg.get_string(
            "stress_balance.sia.surface_gradient_method")
        self.theta_min = cfg.get_number(
            "stress_balance.sia.bed_smoother.theta_min")
        self.icy_thresh = cfg.get_number(
            "stress_balance.ice_free_thickness_standard")
        self.bed_smoother_range = cfg.get_number(
            "stress_balance.sia.bed_smoother.range")
        self.d_limit = (cfg.get_number("stress_balance.sia.max_diffusivity")
                        if cfg.get_flag("stress_balance.sia.limit_diffusivity")
                        else None)
        require(cfg, "stress_balance.sia.pallas", ("auto", "on", "off"))
        self.sia_pallas = {"auto": None, "on": True, "off": False}[
            cfg.get_string("stress_balance.sia.pallas")]

    def _apply_bed_smoother(self, geometry):
        """Schoof (2003) roughness parameterization: grounded SIA columns see
        the thickness relative to the smoothed bed, and the diffusivity is
        scaled by theta on the faces. Returns (geometry, theta_e, theta_n)."""
        if self.bed_smoother_range <= 0.0:
            return geometry, None, None
        grid = self.grid
        smooth = bsm.preprocess_bed(geometry.bed_elevation, grid.dx, grid.dy,
                                    self.bed_smoother_range)
        grounded = S.grounded_ice(geometry.cell_type)
        H_rel = torch.clamp(geometry.ice_surface_elevation - smooth.bed, min=0.0)
        H_sia = torch.where(grounded, H_rel, geometry.ice_thickness)
        th = torch.where(grounded, bsm.theta(smooth, H_rel, self.n_sia), 1.0)
        th = torch.clamp(th, min=self.theta_min).to(geometry.ice_thickness.dtype)
        return (replace(geometry, ice_thickness=H_sia),
                st.avg_to_east(th, self.sh), st.avg_to_north(th, self.sh))

    def _weertman(self, state: S.ModelState):
        """Weertman (1957)-type hard-bed sliding (PISM ``WeertmanSliding``):
        u_b = -k |tau_d|^(m-1) tau_d / N^(m-1), tau_d = -rho g H grad s
        (centered), N = max(rho g H, 1) the overburden pressure; or
        u_b = -mu tau_d with the per-cell ``sliding_mu``. Only grounded
        ice slides, and with ``melt_only`` only where the base is
        temperate (E_base >= E_s(p_base)). With m = 1 and k = B this is
        EISMINT II experiment G's law (Payne et al. 2000 eq. 4)."""
        g = state.geometry
        H = g.ice_thickness
        sx, sy = st.centered_grad(g.ice_surface_elevation, self.grid.dx,
                                  self.grid.dy, self.sh)
        N = torch.clamp(self.rho * self.g * H, min=1.0)
        tdx = -self.rho * self.g * H * sx
        tdy = -self.rho * self.g * H * sy
        if self.sliding_mu is not None:
            fac = self.sliding_mu.to(H.dtype)
        else:
            # (mag / N) ** 0 is 1 where mag = 0 too, as in the JAX package
            mag = torch.sqrt(tdx ** 2 + tdy ** 2)
            fac = self.k_weertman * (mag / N) ** (self.m_weertman - 1.0)
        sliding = S.grounded_ice(g.cell_type)
        if self.melt_only and state.enthalpy is not None:
            EC = self.sia_flow_law.EC
            E_base = state.enthalpy[..., 0]
            sliding = sliding & (E_base >= EC.enthalpy_cts(EC.pressure(H)))
        return (torch.where(sliding, fac * tdx, 0.0),
                torch.where(sliding, fac * tdy, 0.0))

    def sia_flux(self, geometry, enthalpy, theta_e=None, theta_n=None,
                 pallas=None, enhancement=None):
        """The SIA flux; ``enhancement`` defaults to the scalar e_sia (the
        mass substeps' refreshed flux takes it, as in the JAX package)."""
        return sia_ops.diffusivity(
            self.sia_flow_law, geometry, enthalpy, self.grid, self.sh,
            n=self.n_sia,
            enhancement=self.e_sia if enhancement is None else enhancement,
            rho=self.rho, g=self.g,
            gradient_method=self.gradient_method, theta_e=theta_e,
            theta_n=theta_n, pallas=pallas, mesh=self.mesh,
            d_limit=self.d_limit)

    def _blatter_update(self, state: S.ModelState, yield_stress):
        """The 3D Blatter solve as the whole stress balance (JAX
        ``pism_tpu/model/stressbalance.py:192-250``): warm-started from the
        previous vertical mean broadcast over depth."""
        grid, sh = self.grid, self.sh
        geom = state.geometry
        H = geom.ice_thickness
        dtype = H.dtype
        u0 = v0 = None
        if state.u_ssa is not None:
            shape3 = tuple(H.shape) + (grid.Mz,)
            u0 = state.u_ssa[..., None].expand(shape3)
            v0 = state.v_ssa[..., None].expand(shape3)
        u3z, v3z, Phi_z, info = self.blatter.solve(
            state, yield_stress, u0=u0, v0=v0, full_output=True)
        ubar = self.blatter.vertical_average(u3z).to(dtype)
        vbar = self.blatter.vertical_average(v3z).to(dtype)
        u_b = u3z[..., 0].to(dtype)
        v_b = v3z[..., 0].to(dtype)

        sia3 = friction = None
        if self.compute_3d:
            u3 = self.blatter.regrid_to_z(u3z, H).to(dtype)
            v3 = self.blatter.regrid_to_z(v3z, H).to(dtype)
            Phi = self.blatter.regrid_to_z(Phi_z, H).to(dtype)
            z = torch.as_tensor(grid.z, dtype=dtype, device=H.device)
            u_x = (sh(u3, 0, 1) - sh(u3, 0, -1)) / (2.0 * grid.dx)
            v_y = (sh(v3, 1, 0) - sh(v3, -1, 0)) / (2.0 * grid.dy)
            b_x, b_y = st.centered_grad(geom.bed_elevation, grid.dx,
                                        grid.dy, sh)
            w_base = u_b * b_x + v_b * b_y
            if state.basal_melt_rate is not None:
                w_base = w_base - state.basal_melt_rate
            w = w_base[..., None] - sia3d._cumtrapz_z(u_x + v_y, z)
            in_ice = (z <= H[..., None]) | (torch.arange(
                z.shape[0], device=H.device) == 0)
            w = torch.where(in_ice, w, 0.0).to(dtype)
            sia3 = sia3d.SIA3D(u=u3, v=v3, w=w, strain_heating=Phi,
                               max_u=torch.max(torch.abs(u3)),
                               max_v=torch.max(torch.abs(v3)))
            if yield_stress is not None:
                beta = self.blatter.sliding_law.beta(yield_stress, u_b, v_b)
                friction = torch.where(S.grounded_ice(geom.cell_type),
                                       beta * (u_b ** 2 + v_b ** 2), 0.0)

        u_e, v_n = ge.face_velocities(ubar, vbar, sh)
        zeros = torch.zeros_like(H)
        return StressBalanceResult(
            qe=zeros, qn=zeros, u_face_e=u_e, v_face_n=v_n, u_base=u_b,
            v_base=v_b, max_diffusivity=torch.zeros((), dtype=dtype,
                                                    device=H.device),
            u_ssa=ubar, v_ssa=vbar, sia3=sia3,
            basal_frictional_heating=friction,
            ssa_newton_iters=info["newton_iters"],
            ssa_krylov_iters=info["krylov_iters"])

    def age_enhancement(self, state: S.ModelState, t: float):
        """The SIA enhancement of ``state`` at model time ``t`` (a host
        float64): with ``e_age_coupling`` a 3D field of the field dtype,
        ``enhancement_factor_interglacial`` where the ice's depositional
        time t - age falls in the Eemian or after the Holocene's onset
        (formed in float64, as the JAX step forms it from its float64
        clock), else the scalar e_sia."""
        if not (self.e_age_coupling and state.age is not None
                and t is not None):
            return self.e_sia
        depo = t - state.age.to(torch.float64)
        inter = ((depo >= self.eemian_start) & (depo <= self.eemian_end)) \
            | (depo >= self.holocene_start)
        f64 = dict(dtype=torch.float64, device=depo.device)
        return torch.where(inter, torch.tensor(self.e_sia_interglacial, **f64),
                           torch.tensor(self.e_sia, **f64)).to(state.age.dtype)

    def update(self, state: S.ModelState, yield_stress,
               active=None, water_column_pressure=None,
               t=None) -> StressBalanceResult:
        """``active``: on the member axis, the members whose SSA solves (a
        host list; the others' results are discarded by the caller).
        ``water_column_pressure``: the ocean model's front water-column
        pressure [Pa] (melange back pressure; None: hydrostatic), which
        the finite-difference SSA's calving-front term takes and SSAFEM
        ignores, as in the JAX package. ``t``: model time [s], which the
        age-coupled enhancement needs (without it e_sia is the scalar)."""
        if self.model == "blatter":
            return self._blatter_update(state, yield_stress)
        # without an SSA a state's sliding velocities (say, of a restart
        # file) are carried and advect the ice, as in the JAX package
        u_ssa, v_ssa = state.u_ssa, state.v_ssa
        info = {"newton_iters": 0, "krylov_iters": 0}
        if self.model in ("ssa", "ssa+sia"):
            kw = {"active": active} if self.lead else {}
            if water_column_pressure is not None \
                    and hasattr(self.ssa, "_front_stress"):
                kw["water_column_pressure"] = water_column_pressure
            u_ssa, v_ssa, info = self.ssa.solve(
                state, yield_stress, diagnostics=True, **kw)
            if self.brutal_scale is not None:
                u_ssa = u_ssa * self.brutal_scale
                v_ssa = v_ssa * self.brutal_scale
        elif self.sliding == "weertman_sliding":
            u_ssa, v_ssa = self._weertman(state)
        elif self.sliding == "prescribed_sliding":
            H = state.geometry.ice_thickness
            u_ssa = self.prescribed_u.to(H.dtype)
            v_ssa = self.prescribed_v.to(H.dtype)

        e_sia = self.age_enhancement(state, t)
        if self.has_sia:
            geom, th_e, th_n = self._apply_bed_smoother(state.geometry)
            flux = self.sia_flux(geom, state.enthalpy, th_e, th_n,
                                 pallas=self.sia_pallas, enhancement=e_sia)
        else:
            zeros = torch.zeros_like(state.geometry.ice_thickness)
            flux = sia_ops.SIAFlux(zeros, zeros, zeros, zeros,
                                   torch.zeros((), dtype=zeros.dtype,
                                               device=zeros.device))
        if u_ssa is not None:
            u_e, v_n = ge.face_velocities(u_ssa, v_ssa, self.sh)
            u_b, v_b = u_ssa, v_ssa
        else:
            u_e = v_n = u_b = v_b = torch.zeros_like(flux.qe)

        sia3 = friction = None
        if self.compute_3d and self.has_sia:
            sia3 = sia3d.sia_3d(
                self.sia_flow_law, state.geometry, state.enthalpy, self.grid,
                self.sh, n=self.n_sia, enhancement=e_sia, rho=self.rho,
                g=self.g, u_base=u_ssa, v_base=v_ssa,
                basal_melt_rate=state.basal_melt_rate,
                max_diffusivity=self.d_limit, w_approximation=self.w_approx,
                icy_threshold=self.icy_thresh)
            if u_ssa is not None and self.ssa is not None:
                # tau_b . u_b = beta(|u|) |u|^2  [W/m^2]
                beta = self.ssa.sliding_law.beta(yield_stress, u_ssa, v_ssa)
                friction = torch.where(
                    S.grounded_ice(state.geometry.cell_type),
                    beta * (u_ssa ** 2 + v_ssa ** 2), 0.0)

        return StressBalanceResult(
            qe=flux.qe, qn=flux.qn, u_face_e=u_e, v_face_n=v_n,
            u_base=u_b, v_base=v_b, max_diffusivity=flux.max_D,
            u_ssa=u_ssa, v_ssa=v_ssa, sia3=sia3,
            basal_frictional_heating=friction,
            ssa_newton_iters=info["newton_iters"],
            ssa_krylov_iters=info["krylov_iters"],
            ssa_lockstep_newton=info.get("lockstep_newton", 0),
            ssa_lockstep_krylov=info.get("lockstep_krylov", 0))
