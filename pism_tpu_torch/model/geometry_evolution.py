"""Mass-continuity (geometry evolution) step (port of
``pism_tpu/model/geometry_evolution.py``):

    dH/dt = -div(Q_total) + SMB - BMB,
    Q_total = Q_diffusive(SIA) + v_ssa * H_upwind,

with first-order upwind advective flux, donor-cell flux limiting that keeps
H >= 0, optional part-grid front advance, and the source terms.

On an ensemble's member axis (``(B, My, Mx)`` fields, a ``Shifter`` with
``lead = 1``) dt is a per-member tensor shaped ``(B, 1, 1)`` (see
``state.dt_divide``), the volume sums are per member, and part-grid's
fills, promotions and redistribution run per member (they only shift and
select within a member's grid).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import state as S
from ..ops import stencils as st


class FluxLimited(NamedTuple):
    Qe: torch.Tensor
    Qn: torch.Tensor


class MassTransportResult(NamedTuple):
    thickness: torch.Tensor
    flux_divergence: torch.Tensor       # m/s
    nonneg_flux: torch.Tensor           # ice created by the H>=0 clip (m^3/s)
    Href: Optional[torch.Tensor] = None  # part-grid area-specific volume [m]
    # per-cell rates [m/s] of the flow and of the H >= 0 clip (with
    # ``fields``, for the per-cell budget)
    flow_field: Optional[torch.Tensor] = None
    nonneg_field: Optional[torch.Tensor] = None
    # the limited staggered flux [m^2/s] (the isochrones' transport)
    Qe: Optional[torch.Tensor] = None
    Qn: Optional[torch.Tensor] = None


def advective_flux(u_face_e, v_face_n, H, sh):
    """Q_adv on faces: face-normal SSA velocity times upwind thickness."""
    return st.upwind_flux_east(u_face_e, H, sh), \
        st.upwind_flux_north(v_face_n, H, sh)


def face_velocities(u, v, sh):
    """Average cell-centered sliding velocity onto faces."""
    return st.avg_to_east(u, sh), st.avg_to_north(v, sh)


def limit_flux(Qe, Qn, H, dt, dx: float, dy: float, sh) -> FluxLimited:
    """Donor-cell flux limiting: scale each cell's total outflow so it
    cannot export more ice than it holds."""
    out_e = torch.clamp(Qe, min=0.0)
    out_w = torch.clamp(-sh(Qe, 0, -1), min=0.0)
    out_n = torch.clamp(Qn, min=0.0)
    out_s = torch.clamp(-sh(Qn, -1, 0), min=0.0)
    outflow = (out_e + out_w) * dy + (out_n + out_s) * dx
    available = S.dt_divide(H * dx * dy, dt)
    alpha = torch.where(outflow > 0.0,
                        torch.clamp(available / torch.clamp(outflow, min=1e-30),
                                    max=1.0),
                        1.0)
    Qe_lim = Qe * torch.where(Qe >= 0.0, alpha, sh(alpha, 0, 1))
    Qn_lim = Qn * torch.where(Qn >= 0.0, alpha, sh(alpha, 1, 0))
    return FluxLimited(Qe_lim, Qn_lim)


def flow_step(geometry: S.Geometry, dt, Qe, Qn, grid, sh,
              part_grid: bool = False,
              part_grid_iterations: int = 2,
              fields: bool = False) -> MassTransportResult:
    """Apply -div(Q) dt with flux limiting; with ``part_grid`` (Albrecht et
    al. 2011) inflow into ice-free ocean cells next to the front fills the
    area-specific volume Href until the cell is promoted to full ice.
    ``fields`` adds the per-cell flow and clip rates to the result."""
    H = geometry.ice_thickness
    dx, dy = grid.dx, grid.dy
    Qe, Qn = limit_flux(Qe, Qn, H, dt, dx, dy, sh)
    div = st.div_staggered(Qe, Qn, dx, dy, sh)
    dH = -dt * div
    Href = geometry.ice_area_specific_volume

    if part_grid:
        mask = geometry.cell_type
        icy = S.icy(mask)
        ocean_free = mask == S.MASK_ICE_FREE_OCEAN

        def nbr_any(b):
            return sh(b, 0, 1) | sh(b, 0, -1) | sh(b, 1, 0) | sh(b, -1, 0)

        def nbr_sum(f):
            return sh(f, 0, 1) + sh(f, 0, -1) + sh(f, 1, 0) + sh(f, -1, 0)

        partial = ocean_free & nbr_any(icy)
        # face-resolved inflow into partial cells accumulates in Href
        inflow_rate = (
            (torch.clamp(-Qe, min=0.0)
             + torch.clamp(sh(Qe, 0, -1), min=0.0)) * dy
            + (torch.clamp(-Qn, min=0.0)
               + torch.clamp(sh(Qn, -1, 0), min=0.0)) * dx) / (dx * dy)
        Href = torch.where(partial, Href + dt * inflow_rate, Href)
        H_new = torch.where(partial, H + dH - dt * inflow_rate, H + dH)

        # promotion + residual redistribution, a fixed number of sweeps
        icy_dyn, ocean_dyn = icy, ocean_free
        for _ in range(max(int(part_grid_iterations), 1)):
            partial_dyn = ocean_dyn & nbr_any(icy_dyn)
            icy_f = icy_dyn.to(H.dtype)
            nsum = nbr_sum(H_new * icy_f)
            ncnt = nbr_sum(icy_f)
            H_thresh = torch.clamp(nsum / torch.clamp(ncnt, min=1.0), min=1.0)
            promote = partial_dyn & (Href >= H_thresh)
            residual = torch.where(promote, Href - H_thresh, 0.0)
            H_new = torch.where(promote, H_thresh, H_new)
            Href = torch.where(promote, 0.0, Href)
            icy_dyn = icy_dyn | promote
            ocean_dyn = ocean_dyn & ~promote
            eligible = ocean_dyn & nbr_any(icy_dyn)
            n_elig = nbr_sum(eligible.to(H.dtype))
            share = torch.where(promote & (n_elig > 0),
                                residual / torch.clamp(n_elig, min=1.0), 0.0)
            Href = Href + torch.where(eligible, nbr_sum(share), 0.0)
            H_new = H_new + torch.where(promote & (n_elig == 0), residual, 0.0)
        # orphaned Href (no longer next to ice) becomes thin ice
        orphan = (Href > 0.0) & ~((ocean_dyn & nbr_any(icy_dyn)) | icy_dyn)
        H_new = H_new + torch.where(orphan, Href, 0.0)
        Href = torch.where(orphan, 0.0, Href)
    else:
        H_new = H + dH

    clipped = torch.clamp(H_new, min=0.0)
    nonneg_field = S.dt_divide(clipped - H_new, dt)
    nonneg = S.member_sum(nonneg_field, sh.lead) * dx * dy
    if not fields:
        return MassTransportResult(thickness=clipped, flux_divergence=div,
                                   nonneg_flux=nonneg, Href=Href, Qe=Qe, Qn=Qn)
    return MassTransportResult(
        thickness=clipped, flux_divergence=div, nonneg_flux=nonneg, Href=Href,
        flow_field=S.dt_divide(H_new - H, dt), nonneg_field=nonneg_field,
        Qe=Qe, Qn=Qn)


def source_term_step(H, dt, smb, bmb, dx: float, dy: float,
                     fields: bool = False, lead: int = 0):
    """Apply surface mass balance then basal melt with H >= 0 clipping;
    returns (H, applied smb volume rate, applied bmb volume rate), and with
    ``fields`` also the per-cell applied rates [m/s, dH convention].
    ``lead``: leading member dims (the sums are then per member)."""
    H1 = torch.clamp(H + dt * smb, min=0.0)
    H_new = torch.clamp(H1 - dt * bmb, min=0.0)
    area = dx * dy
    smb_field = S.dt_divide(H1 - H, dt)
    bmb_field = S.dt_divide(H_new - H1, dt)
    smb_applied = S.member_sum(smb_field, lead) * area
    bmb_applied = S.member_sum(bmb_field, lead) * area * -1.0
    if fields:
        return H_new, smb_applied, bmb_applied, smb_field, bmb_field
    return H_new, smb_applied, bmb_applied


def max_timestep_cfl_2d(max_u_face: float, max_v_face: float, dx: float,
                        dy: float) -> float:
    """2D CFL limit from the largest face-normal advective velocities."""
    return 1.0 / max(max_u_face / dx + max_v_face / dy, 1e-30)
