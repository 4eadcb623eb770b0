"""Fracture density phase field (port of ``pism_tpu/model/fracture.py``;
PISM ``FractureDensity``, Albrecht & Levermann 2012): a 2D field phi in
[0, 1] advected with the membrane (SSA) velocity, grown by a strain-rate
or stress source above an initiation threshold, healed below a healing
threshold, with a fracture-age companion field and the SSA's softening
feedback (hardness times max(1 - (1 - eps) phi, eps)).

Every option of the JAX module (config group ``fracture_density``):
``gamma`` / ``initiation_threshold`` (the default effective-strain-rate
criterion), ``max_shear_stress`` and ``lefm`` (stress criteria from the
SSA's vertically averaged hardness, strain-rate ones without it),
``borstad_limit`` (damage jumps to the Borstad et al. 2016 envelope
1 - (eps_cr / eps_e)^(1/n)), ``gamma_h`` / ``healing_threshold`` /
``constant_healing`` / ``fracture_weighted_healing``,
``include_grounded_ice``, ``constant_fd`` (transport only),
``fd2d_scheme`` (minmod-limited second-order transport; off: donor
cell), ``phi0`` (phi pinned at inflow cells) and
``softening_lower_limit`` (read by the SSA).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from .. import state as S
from ..ops.stencils import Shifter


class FractureStep(NamedTuple):
    density: torch.Tensor
    age: Optional[torch.Tensor]


def _minmod(a, b):
    return torch.where(a * b <= 0.0, 0.0,
                       torch.where(torch.abs(a) < torch.abs(b), a, b))


@dataclass
class FractureDensity:
    grid: object
    config: object
    bc_mask: object = None      # inflow (velocity Dirichlet) cells -> phi0

    def __post_init__(self):
        cfg = self.config
        self.gamma = cfg.get_number("fracture_density.gamma")
        self.eps_cr = cfg.get_number("fracture_density.initiation_threshold")
        self.sigma_cr = cfg.get_number(
            "fracture_density.initiation_stress_threshold")
        self.gamma_h = cfg.get_number("fracture_density.gamma_h")
        self.eps_h = cfg.get_number("fracture_density.healing_threshold")
        self.soft_min = cfg.get_number("fracture_density.softening_lower_limit")
        self.phi0 = cfg.get_number("fracture_density.phi0")
        self.constant_fd = cfg.get_flag("fracture_density.constant_fd")
        self.constant_healing = cfg.get_flag(
            "fracture_density.constant_healing")
        self.weighted_healing = cfg.get_flag(
            "fracture_density.fracture_weighted_healing")
        self.include_grounded = cfg.get_flag(
            "fracture_density.include_grounded_ice")
        self.max_shear = cfg.get_flag("fracture_density.max_shear_stress")
        self.lefm = cfg.get_flag("fracture_density.lefm")
        self.borstad = cfg.get_flag("fracture_density.borstad_limit")
        self.limited = cfg.get_flag("fracture_density.fd2d_scheme")
        self.n_glen = cfg.get_number("stress_balance.ssa.Glen_exponent")
        self.sh = Shifter(self.grid)

    # -- kinematics -------------------------------------------------------

    def _strain_rates(self, u, v):
        """(e1, e2, eps_e): principal strain rates and the SSA effective
        strain rate sqrt(exx^2 + eyy^2 + exx eyy + exy^2)."""
        sh = self.sh
        dx, dy = self.grid.dx, self.grid.dy
        exx = (sh(u, 0, 1) - sh(u, 0, -1)) / (2 * dx)
        eyy = (sh(v, 1, 0) - sh(v, -1, 0)) / (2 * dy)
        uy = (sh(u, 1, 0) - sh(u, -1, 0)) / (2 * dy)
        vx = (sh(v, 0, 1) - sh(v, 0, -1)) / (2 * dx)
        exy = 0.5 * (uy + vx)
        mean = 0.5 * (exx + eyy)
        rad = torch.sqrt((0.5 * (exx - eyy)) ** 2 + exy ** 2)
        eps_e = torch.sqrt(exx ** 2 + eyy ** 2 + exx * eyy + exy ** 2)
        return mean + rad, mean - rad, eps_e

    def _advect(self, q, u, v):
        """The transport term -(u q_x + v q_y): donor cell, or with
        ``fd2d_scheme`` a minmod-MUSCL flux-form update plus the
        compressibility correction q div(u)."""
        sh = self.sh
        dx, dy = self.grid.dx, self.grid.dy
        if not self.limited:
            qx = torch.where(u >= 0, (q - sh(q, 0, -1)) / dx,
                             (sh(q, 0, 1) - q) / dx)
            qy = torch.where(v >= 0, (q - sh(q, -1, 0)) / dy,
                             (sh(q, 1, 0) - q) / dy)
            return -(u * qx + v * qy)

        def axis_term(off, vel, h):
            def east(a):
                return sh(a, *off)

            def west(a):
                return sh(a, -off[0], -off[1])

            slope = _minmod(q - west(q), east(q) - q)
            qL = q + 0.5 * slope                       # left state at + face
            qR = east(q) - 0.5 * east(slope)           # right state at + face
            uf = 0.5 * (vel + east(vel))
            F_e = uf * torch.where(uf >= 0, qL, qR)
            F_w, uf_w = west(F_e), west(uf)
            return -(F_e - F_w) / h + q * (uf - uf_w) / h

        return axis_term((0, 1), u, dx) + axis_term((1, 0), v, dy)

    # -- physics ----------------------------------------------------------

    def _criterion(self, e1, e2, eps_e, hardness):
        """The mask where fractures initiate. The stress criteria take
        sigma = B eps_e^(1/n-1) (...) with a vertically averaged hardness B,
        the strain-rate forms without one."""
        if (self.max_shear or self.lefm) and hardness is not None:
            visc = hardness * torch.clamp(eps_e, min=1e-30) \
                ** (1.0 / self.n_glen - 1.0)
            stress = visc * 0.5 * (e1 - e2) if self.max_shear \
                else 2.0 * visc * e1
            return stress > self.sigma_cr
        if self.max_shear:
            return 0.5 * (e1 - e2) > self.eps_cr
        if self.lefm:
            return e1 > self.eps_cr
        return eps_e > self.eps_cr

    def step(self, state: S.ModelState, u, v, dt, hardness=None,
             age=None) -> FractureStep:
        """One explicit step of (phi, fracture age) of ``dt`` seconds (a
        host float). ``age`` defaults to ``state.fracture_age``;
        ``hardness`` (vertically averaged B) enables the stress criteria."""
        phi = state.fracture_density
        if age is None:
            age = state.fracture_age
        e1, e2, eps_e = self._strain_rates(u, v)
        icy = S.icy(state.geometry.cell_type)

        phi_new = phi + dt * self._advect(phi, u, v)
        growing = torch.zeros_like(phi, dtype=torch.bool)
        if not self.constant_fd:
            region = icy if self.include_grounded \
                else S.floating_ice(state.geometry.cell_type)
            exceed = self._criterion(e1, e2, eps_e, hardness) & region
            if self.borstad:
                # the Borstad et al. (2016) envelope: ice at eps_e carries
                # the threshold stress once phi = 1 - (eps_cr/eps_e)^(1/n)
                phi_b = 1.0 - (self.eps_cr / torch.clamp(eps_e, min=1e-30)) \
                    ** (1.0 / self.n_glen)
                target = torch.where(exceed, torch.clamp(phi_b, min=0.0), 0.0)
                growing = exceed & (target > phi_new)
                phi_new = torch.where(growing, target, phi_new)
            else:
                source = self.gamma * torch.clamp(e1, min=0.0) * (1.0 - phi)
                growing = exceed & (source > 0.0)
                phi_new = phi_new + dt * torch.where(exceed, source, 0.0)

            if self.constant_healing:
                heal = self.gamma_h * self.eps_h
            else:
                heal = self.gamma_h * torch.clamp(self.eps_h - e1, min=0.0)
            if self.weighted_healing:
                heal = heal * (1.0 - phi)
            phi_new = phi_new - dt * heal

        phi_new = torch.where(icy, torch.clamp(phi_new, 0.0, 1.0), 0.0)
        if self.bc_mask is not None:
            bc = torch.as_tensor(self.bc_mask, device=phi.device).to(torch.bool)
            phi_new = torch.where(bc, self.phi0, phi_new)

        age_new = None
        if age is not None:
            age_new = age + dt * self._advect(age, u, v) + dt
            age_new = torch.where(growing, 0.0, age_new)   # fresh fractures
            age_new = torch.where(icy & (phi_new > 0.0),
                                  torch.clamp(age_new, min=0.0), 0.0)
        return FractureStep(density=phi_new, age=age_new)

    def flow_enhancement(self, phi, n_glen=3.0):
        """The softening feedback as a softness factor:
        max(1 - (1 - eps) phi, eps)^(-n), eps = softening_lower_limit
        (1: off)."""
        if self.soft_min == 1.0:
            return torch.ones_like(phi)
        eps = self.soft_min
        hard = torch.clamp(1.0 - (1.0 - eps) * phi, min=eps)
        return hard ** (-n_glen)
