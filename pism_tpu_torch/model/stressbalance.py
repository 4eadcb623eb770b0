"""Composite stress balance (port of ``pism_tpu/model/stressbalance.py``,
the ``ssa+sia`` and ``sia`` branches of ``update``): the SSA sliding
velocity (``ssa+sia``; ``sia`` carries the state's own, if any), the SIA diffusive flux
on the bed-smoothed geometry, and (for the energy model) the 3D
velocities, strain heating and basal frictional heating.
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
from . import geometry_evolution as ge


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


@dataclass
class StressBalance:
    grid: object
    config: object
    sia_flow_law: object
    ssa: object = None
    compute_3d: bool = True
    # ("y", "x") Mesh: the SIA kernel routes run per shard under it
    mesh: object = None

    def __post_init__(self):
        cfg = self.config
        require(cfg, "stress_balance.model", ("ssa+sia", "sia"))
        self.model = cfg.get_string("stress_balance.model")
        # both ported models carry the SIA (``run`` reads it for the
        # max_diffusivity stop)
        self.has_sia = "sia" in self.model.split("+")
        require(cfg, "stress_balance.vertical_velocity_approximation",
                ("centered",))
        require(cfg, "stress_balance.sia.e_age_coupling", (False,))
        require(cfg, "stress_balance.ssa.fd.brutal_sliding", (False,))
        require(cfg, "stress_balance.sia.surface_gradient_method",
                ("haseloff", "mahaffy"))
        self.sh = Shifter(self.grid)
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

    def sia_flux(self, geometry, enthalpy, theta_e=None, theta_n=None,
                 pallas=None):
        return sia_ops.diffusivity(
            self.sia_flow_law, geometry, enthalpy, self.grid, self.sh,
            n=self.n_sia, enhancement=self.e_sia, rho=self.rho, g=self.g,
            gradient_method=self.gradient_method, theta_e=theta_e,
            theta_n=theta_n, pallas=pallas, mesh=self.mesh,
            d_limit=self.d_limit)

    def update(self, state: S.ModelState, yield_stress) -> StressBalanceResult:
        # without an SSA a state's sliding velocities (say, of a restart
        # file) are carried and advect the ice, as in the JAX package
        u_ssa, v_ssa = state.u_ssa, state.v_ssa
        info = {"newton_iters": 0, "krylov_iters": 0}
        if self.model == "ssa+sia":
            u_ssa, v_ssa, info = self.ssa.solve(state, yield_stress,
                                                diagnostics=True)

        geom, th_e, th_n = self._apply_bed_smoother(state.geometry)
        flux = self.sia_flux(geom, state.enthalpy, th_e, th_n,
                             pallas=self.sia_pallas)
        if u_ssa is not None:
            u_e, v_n = ge.face_velocities(u_ssa, v_ssa, self.sh)
            u_b, v_b = u_ssa, v_ssa
        else:
            u_e = v_n = u_b = v_b = torch.zeros_like(flux.qe)

        sia3 = friction = None
        if self.compute_3d:
            sia3 = sia3d.sia_3d(
                self.sia_flow_law, state.geometry, state.enthalpy, self.grid,
                self.sh, n=self.n_sia, enhancement=self.e_sia, rho=self.rho,
                g=self.g, u_base=u_ssa, v_base=v_ssa,
                basal_melt_rate=state.basal_melt_rate,
                max_diffusivity=self.d_limit, icy_threshold=self.icy_thresh)
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
            ssa_krylov_iters=info["krylov_iters"])
