"""Shallow-ice approximation (SIA) diffusivity and flux (port of
``pism_tpu/ops/sia.py``): Mahaffy and Haseloff staggered surface
gradients and the diffusivity

    D = 2 e (rho g)^n |grad s|^(n-1) K,
    K = int_0^H A(E(z), p(H - z)) (H - z)^(n+1) dz   (z above base),

which for an isothermal law (no enthalpy field, ``energy.model = none``)
is the closed form K = A H^(n+2) / (n+2); then q = -D grad(s) on the
faces. ``diffusivity`` routes as the JAX package does
(``pism_tpu/ops/sia.py:225-270``): a fused kernel where it computes the same
quantity (K3, ``ops/kernels/sia_thermo.py``, with an enthalpy field; K4,
``ops/kernels/sia_iso.py``, without one), else the plain path here. The
hybrid chain, with Haseloff gradients and the bed smoother, takes the
plain path; EISMINT II and the Halfar setup, with Mahaffy gradients and no
bed-smoother theta, take a kernel.

With a ("y", "x") mesh of more than one device, a kernel route runs the
kernel per shard on halo-padded blocks (``ops/sharded.py``), as the JAX
package routes through ``ops.pallas_sharded`` (``:240-255``).

The JAX package declines its isothermal kernel above 490,000 cells
(``pism_tpu/ops/sia.py:238-239``) because the TPU kernel is one VMEM block.
The CUDA kernel has no such limit, so the port's ``auto`` rule has none.

On an ensemble's member axis (a ``Shifter`` with ``lead = 1``: H and s
``(B, My, Mx)``, E ``(B, My, Mx, Mz)``) each member's gradients, softness integral and max(D)
are its own; a kernel route is one launch for all members with a ``(B,)``
max(D) from that launch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import sharded
from . import stencils as st
from .kernels import sia_iso as K4
from .kernels import sia_thermo as K3
from .. import state as S
from ..parallel.mesh import is_sharded


class StaggeredGrad(NamedTuple):
    """Surface gradient on east and north faces."""
    sx_e: torch.Tensor
    sy_e: torch.Tensor
    sx_n: torch.Tensor
    sy_n: torch.Tensor


class SIAFlux(NamedTuple):
    De: torch.Tensor   # diffusivity on east faces [m^2/s]
    Dn: torch.Tensor
    qe: torch.Tensor   # diffusive flux (vertically integrated) [m^2/s]
    qn: torch.Tensor
    max_D: torch.Tensor  # 0-dim (or one per member), for adaptive dt


def surface_gradient_mahaffy(surface, grid, sh) -> StaggeredGrad:
    """Mahaffy (1976): one-sided across the face, 4-point average along it."""
    dx, dy = grid.dx, grid.dy
    return StaggeredGrad(
        sx_e=st.grad_x_east(surface, dx, sh),
        sy_e=st.grad_y_east(surface, dy, sh),
        sx_n=st.grad_x_north(surface, dx, sh),
        sy_n=st.grad_y_north(surface, dy, sh),
    )


def surface_gradient_haseloff(geometry, grid, sh) -> StaggeredGrad:
    """Mahaffy gradients with the margin fix: faces between an icy cell and
    an ice-free cell whose surface is higher get zero across-face gradient
    (no flow up onto ice-free ground)."""
    s = geometry.ice_surface_elevation
    icy = S.icy(geometry.cell_type)
    g = surface_gradient_mahaffy(s, grid, sh)
    icy_e, icy_n = sh(icy, 0, 1), sh(icy, 1, 0)
    s_e, s_n = sh(s, 0, 1), sh(s, 1, 0)
    wall_e = (icy & ~icy_e & (s_e > s)) | (~icy & icy_e & (s > s_e))
    wall_n = (icy & ~icy_n & (s_n > s)) | (~icy & icy_n & (s > s_n))
    return StaggeredGrad(sx_e=torch.where(wall_e, 0.0, g.sx_e), sy_e=g.sy_e,
                         sx_n=g.sx_n, sy_n=torch.where(wall_n, 0.0, g.sy_n))


def surface_gradient(geometry, grid, sh, method: str = "mahaffy"
                     ) -> StaggeredGrad:
    if method == "haseloff":
        return surface_gradient_haseloff(geometry, grid, sh)
    if method == "mahaffy":
        return surface_gradient_mahaffy(geometry.ice_surface_elevation, grid, sh)
    raise NotImplementedError(
        f"stress_balance.sia.surface_gradient_method = {method!r} is not "
        "implemented in pism_tpu_torch (supported: 'haseloff', 'mahaffy')")


def _softness_integral(flow_law, E3, H_face, z, n: float, enhancement: float):
    """K = int_0^H A(E(z), p) (H-z)^(n+1) dz on one set of faces; E3 is the
    enthalpy averaged onto the faces. Trapezoid on levels clipped to H."""
    H = H_face[..., None]
    depth = torch.clamp(H - z, min=0.0)
    A = flow_law.softness(E3, flow_law.EC.pressure(depth))
    f = enhancement * A * depth ** (n + 1.0)
    w = torch.diff(torch.minimum(z, H), dim=-1)
    return torch.sum(0.5 * (f[..., 1:] + f[..., :-1]) * w, dim=-1)


def _isothermal_softness(flow_law, dtype, device="cpu"):
    """The law's softness as a 0-dim tensor of the field dtype (the JAX
    package evaluates it at zero enthalpy and pressure)."""
    zero = torch.zeros((), dtype=dtype, device=device)
    return flow_law.softness(zero, zero)


def _iso_kernel_eligible(grid, H, gradient_method, theta_e, theta_n,
                         enhancement) -> bool:
    """The ``auto`` rule of the JAX package's ``_pallas_eligible``
    (``pism_tpu/ops/sia.py:170-190``, ``:227-239``) for K4, with a CUDA card
    where it has a TPU: the kernel computes the identical quantity for
    float32 fields, Mahaffy gradients, clamped (non-periodic) ghosts, no
    bed-smoother multipliers and a scalar enhancement factor. No cell-count
    limit (see the module's docstring)."""
    return (H.device.type == "cuda"
            and H.dtype == torch.float32
            and gradient_method == "mahaffy"
            and theta_e is None and theta_n is None
            and not grid.periodic_x and not grid.periodic_y
            and not torch.is_tensor(enhancement))


def _kernel_eligible(flow_law, enthalpy, grid, H, gradient_method,
                     theta_e, theta_n, enhancement) -> bool:
    """The same rule for K3: K4's, plus an enthalpy field and a
    Paterson-Budd-family law."""
    return (enthalpy is not None
            and all(hasattr(flow_law, a) for a in
                    ("A_cold", "A_warm", "Q_cold", "Q_warm", "T_critical", "R"))
            and _iso_kernel_eligible(grid, H, gradient_method, theta_e,
                                     theta_n, enhancement))


def diffusivity(flow_law, geometry, enthalpy, grid, sh, *, n: float = 3.0,
                enhancement: float = 1.0, rho: float = 910.0, g: float = 9.81,
                gradient_method: str = "mahaffy",
                theta_e: Optional[torch.Tensor] = None,
                theta_n: Optional[torch.Tensor] = None,
                pallas: Optional[bool] = None,
                mesh=None,
                d_limit: Optional[float] = None) -> SIAFlux:
    """Staggered diffusivity and diffusive flux.

    theta_e/theta_n: bed-smoother multipliers on the faces; d_limit: cap on
    D (PISM ``stress_balance.sia.limit_diffusivity``). pallas
    (``stress_balance.sia.pallas``): True takes the kernel route (K3 with
    an enthalpy field, K4 without) whatever theta is, as the JAX package
    does (it returns before theta is applied); on CPU tensors that route
    runs the kernel's plain version. False takes the plain path; None
    decides by :func:`_iso_kernel_eligible` (no enthalpy) or
    :func:`_kernel_eligible`. mesh: with a sharded ("y", "x") mesh the
    kernel route runs per shard (``ops/sharded.py``)."""
    H = geometry.ice_thickness
    s = geometry.ice_surface_elevation
    sharded_route = is_sharded(mesh)
    use_kernel = pallas
    if use_kernel is None and enthalpy is None:
        use_kernel = _iso_kernel_eligible(grid, H, gradient_method, theta_e,
                                          theta_n, enhancement)
    elif use_kernel is None:
        use_kernel = _kernel_eligible(flow_law, enthalpy, grid, H,
                                      gradient_method, theta_e, theta_n,
                                      enhancement)
    if use_kernel and enthalpy is None:
        # A rounded to the field dtype (on the host: no device sync), then
        # gamma in float64 from it, as the JAX package does
        # (``pism_tpu/ops/sia.py:265-266``)
        A = float(_isothermal_softness(flow_law, H.dtype))
        kw = dict(A=A, n=n, enhancement=enhancement, rho=rho, g=g,
                  dx=grid.dx, dy=grid.dy, d_cap=d_limit)
        if sharded_route:
            return SIAFlux(*sharded.sia_flux_sharded(H, s, mesh, **kw))
        return SIAFlux(*K4.sia_flux(H.contiguous(), s.contiguous(), **kw))
    if enthalpy is not None:
        z = torch.as_tensor(grid.z, dtype=H.dtype, device=H.device)
    if use_kernel:
        kw = dict(n=n, enhancement=enhancement, rho=rho, g=g, dx=grid.dx,
                  dy=grid.dy, EC=flow_law.EC, pb_law=flow_law, d_cap=d_limit)
        if sharded_route:
            return SIAFlux(*sharded.sia_flux_thermo_sharded(
                H, s, enthalpy, z, mesh, **kw))
        # the energy solve leaves E level-major in memory; the kernel reads
        # it in place through its strides
        return SIAFlux(*K3.sia_flux_thermo(
            H.contiguous(), s.contiguous(), enthalpy, z, **kw))

    grad = surface_gradient(geometry, grid, sh, gradient_method)
    H_e, H_n = st.avg_to_east(H, sh), st.avg_to_north(H, sh)
    if enthalpy is None:
        # isothermal closed form: K = e A H^(n+2) / (n+2)
        A = _isothermal_softness(flow_law, H.dtype, H.device)
        Ke = enhancement * A * H_e ** (n + 2.0) / (n + 2.0)
        Kn = enhancement * A * H_n ** (n + 2.0) / (n + 2.0)
    else:
        Ke = _softness_integral(flow_law, st.avg_to_east(enthalpy, sh), H_e,
                                z, n, enhancement)
        Kn = _softness_integral(flow_law, st.avg_to_north(enthalpy, sh),
                                H_n, z, n, enhancement)
    C = 2.0 * (rho * g) ** n
    De = C * (grad.sx_e ** 2 + grad.sy_e ** 2) ** ((n - 1.0) / 2.0) * Ke
    Dn = C * (grad.sx_n ** 2 + grad.sy_n ** 2) ** ((n - 1.0) / 2.0) * Kn
    if theta_e is not None:
        De = De * theta_e
    if theta_n is not None:
        Dn = Dn * theta_n
    if d_limit is not None:
        De = torch.clamp(De, max=d_limit)
        Dn = torch.clamp(Dn, max=d_limit)
    lead = sh.lead
    return SIAFlux(De=De, Dn=Dn, qe=-De * grad.sx_e, qn=-Dn * grad.sy_n,
                   max_D=torch.maximum(S.member_max(De, lead),
                                       S.member_max(Dn, lead)))


def max_timestep_diffusivity(max_D: float, dx: float, dy: float,
                             adaptive_ratio: float = 0.12) -> float:
    """Explicit-diffusion stability limit (PISM
    ``max_timestep_diffusivity``): dt = 2 R / (D (1/dx^2 + 1/dy^2))."""
    return 2.0 * adaptive_ratio / (max(max_D, 1e-30)
                                   * (1.0 / dx ** 2 + 1.0 / dy ** 2))
