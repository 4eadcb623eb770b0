"""3D SIA velocities, vertical velocity and strain heating (port of
``pism_tpu/ops/sia3d.py``):

    u(z) = u_b - 2 e (rho g)^n |grad s|^(n-1) s_x I(z),
    I(z) = int_0^z A(E, p) (H - z')^n dz'
    w(z) = w_b - int_0^z (u_x + v_y) dz'
    Phi(z) = 2 e A(E, p) tau(z)^(n+1),  tau = rho g (H - z) |grad s|;

for a law with no Glen softness (Goldsby-Kohlstedt) du/dz = 2 e F(tau) tau
and Phi = 2 e F tau^2. The enhancement e is a number or a 3D field (the
age-coupled one); the divergence in w is centered, or upwinded by the
sliding velocity's sign (``w_approximation = "upstream"``).

On an ensemble's member axis (a ``Shifter`` with ``lead = 1``) the CFL
maxima are per member.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import stencils as st
from ..state import member_max


class SIA3D(NamedTuple):
    u: torch.Tensor               # (My, Mx, Mz) m/s
    v: torch.Tensor
    w: torch.Tensor
    strain_heating: torch.Tensor  # (My, Mx, Mz) W/m^3
    max_u: torch.Tensor           # 0-dim (or per member), for the 3D CFL
    max_v: torch.Tensor


def _cumtrapz_z(f, z):
    """Cumulative trapezoid along the trailing axis; result[..., 0] = 0."""
    mid = 0.5 * (f[..., 1:] + f[..., :-1]) * torch.diff(z)
    return torch.cat([torch.zeros_like(f[..., :1]),
                      torch.cumsum(mid, dim=-1)], dim=-1)


def sia_3d(flow_law, geometry, enthalpy, grid, sh, *, n: float = 3.0,
           enhancement: float = 1.0, rho: float = 910.0, g: float = 9.81,
           u_base: Optional[torch.Tensor] = None,
           v_base: Optional[torch.Tensor] = None,
           basal_melt_rate: Optional[torch.Tensor] = None,
           max_diffusivity: Optional[float] = None,
           w_approximation: str = "centered",
           icy_threshold: float = 0.0) -> SIA3D:
    """Cell-centered 3D velocities and strain heating. ``max_diffusivity``
    (the capped-SIA case) scales each column's shear profile so its flux
    integral respects the same cap."""
    H = geometry.ice_thickness
    z = torch.as_tensor(grid.z, dtype=H.dtype, device=H.device)

    s_x, s_y = st.centered_grad(geometry.ice_surface_elevation,
                                grid.dx, grid.dy, sh)
    slope = torch.sqrt(s_x ** 2 + s_y ** 2)

    Hc = H[..., None]
    depth = torch.clamp(Hc - z, min=0.0)
    tau = rho * g * depth * slope[..., None]
    if getattr(flow_law, "generalized", False):
        if enthalpy is None:
            raise ValueError("generalized flow law needs enthalpy")
        F3 = flow_law.flow(tau, enthalpy, flow_law.EC.pressure(depth))
        phi = 2.0 * rho * g * _cumtrapz_z(enhancement * F3 * depth, z)
        A3 = None
    else:
        A3 = flow_law.softness(enthalpy, flow_law.EC.pressure(depth))
        C = 2.0 * (rho * g) ** n
        phi = C * slope[..., None] ** (n - 1.0) \
            * _cumtrapz_z(enhancement * A3 * depth ** n, z)

    if max_diffusivity is not None:
        wgt = torch.diff(torch.minimum(z, Hc), dim=-1)
        D_col = torch.sum(0.5 * (phi[..., 1:] + phi[..., :-1]) * wgt, dim=-1)
        scale = torch.clamp(max_diffusivity / torch.clamp(D_col, min=1e-30),
                            max=1.0)
        phi = phi * scale[..., None]

    ub = u_base if u_base is not None else torch.zeros_like(H)
    vb = v_base if v_base is not None else torch.zeros_like(H)
    level0 = torch.arange(z.shape[0], device=H.device) == 0
    in_ice = (z <= Hc) | level0
    u = torch.where(in_ice, ub[..., None] - phi * s_x[..., None], 0.0)
    v = torch.where(in_ice, vb[..., None] - phi * s_y[..., None], 0.0)

    # vertical velocity from incompressibility: the divergence centered,
    # or upstream by the sliding velocity's sign
    if w_approximation == "upstream":
        up_x = (ub >= 0.0)[..., None]
        up_y = (vb >= 0.0)[..., None]
        u_x = torch.where(up_x, (u - sh(u, 0, -1)) / grid.dx,
                          (sh(u, 0, 1) - u) / grid.dx)
        v_y = torch.where(up_y, (v - sh(v, -1, 0)) / grid.dy,
                          (sh(v, 1, 0) - v) / grid.dy)
    else:
        u_x = (sh(u, 0, 1) - sh(u, 0, -1)) / (2.0 * grid.dx)
        v_y = (sh(v, 1, 0) - sh(v, -1, 0)) / (2.0 * grid.dy)
    b_x, b_y = st.centered_grad(geometry.bed_elevation, grid.dx, grid.dy, sh)
    w_base = ub * b_x + vb * b_y
    if basal_melt_rate is not None:
        w_base = w_base - basal_melt_rate
    w = torch.where(in_ice, w_base[..., None] - _cumtrapz_z(u_x + v_y, z), 0.0)

    Phi = 2.0 * enhancement * F3 * tau ** 2 if A3 is None \
        else 2.0 * enhancement * A3 * tau ** (n + 1.0)
    Phi = torch.where(z < Hc, Phi, 0.0)

    # 3D CFL maxima over icy columns only
    icy3 = Hc > icy_threshold
    lead = sh.lead
    return SIA3D(u=u, v=v, w=w, strain_heating=Phi,
                 max_u=member_max(torch.abs(torch.where(icy3, u, 0.0)), lead),
                 max_v=member_max(torch.abs(torch.where(icy3, v, 0.0)), lead))


def max_timestep_cfl_3d(max_u: float, max_v: float, dx: float,
                        dy: float) -> float:
    """3D CFL for the explicit horizontal enthalpy advection."""
    return 1.0 / max(max_u / dx + max_v / dy, 1e-30)
