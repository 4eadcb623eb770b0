"""PICO, the Potsdam Ice-shelf Cavity mOdel (Reese et al. 2018, TC 12):
port of ``pism_tpu/coupler/pico.py``.

Ice shelves are split into boxes along the overturning circulation from
the grounding line to the calving front; water properties cascade through
the boxes. The box geometry comes from two hop distances over the shelf
cells, d_GL from the grounding line and d_IF from the ice front; the
relative position r = d_GL/(d_GL+d_IF) picks the box (Reese et al. eq. 9).

The JAX package runs its three flood fills (the two distances and the
ice-rise grow of ``exclude_ice_rises``) as ``lax.while_loop``s until
nothing changes; here each is ``util.hostsync.fixed_point``, a host loop
that reads the change flag once per few sweeps (the syncs are counted).
The per-basin sums and maxima are reductions over a basin one-hot built
once from the static basin labels, so two runs give the same bits.
The distances are float64 whatever the field dtype, as the JAX package's
are (it enables x64), so the box indices of a float32 run are its.

``Pico.members`` is the same model on an ensemble's member axis (fields
``(B, My, Mx)``), the JAX package's ``vmap`` of it: the fills sweep until
no member changes (a member's fill is its fixed point, whatever the
others do), the ice-rise seed is each member's own thickest ice, and the
float sums over a basin go through ``ops/kernels/member_dot.member_sum``,
whose order does not depend on the number of members (torch's CUDA sum
picks its block shape by the batch). The members may differ in their
ambient temperature (``member_temperature``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import state as S
from ..ops.kernels.member_dot import member_sum
from ..ops.stencils import Shifter
from ..util.forcing import TimeStack
from ..util.hostsync import fixed_point
from .ocean import OceanInputs, OceanModel

# liquidus T_f = a S + b + c p  (Reese et al. 2018, Table 1)
A_LIQ = -0.0572        # K / (g/kg)
B_LIQ = 0.0788 + 273.15  # K
C_LIQ = 7.77e-8        # K / Pa
ALPHA_RHO = 7.5e-5     # 1/K      thermal expansion
BETA_RHO = 7.7e-4      # 1/(g/kg) haline contraction
RHO_STAR = 1033.0      # kg/m^3
C_P_OCEAN = 3974.0     # J/(kg K)
LATENT = 3.34e5        # J/kg


def _nbr(m, sh):
    return sh(m, 0, 1) | sh(m, 0, -1) | sh(m, 1, 0) | sh(m, -1, 0)


def _propagate_distance(seed_mask, region_mask, sh, max_iters):
    """Hop distance (float64) from seed cells through region cells (1e9
    where unreached)."""
    d0 = torch.where(seed_mask, 0.0, torch.tensor(
        1e9, dtype=torch.float64, device=seed_mask.device))

    def sweep(d):
        nbr = torch.minimum(torch.minimum(sh(d, 0, 1), sh(d, 0, -1)),
                            torch.minimum(sh(d, 1, 0), sh(d, -1, 0))) + 1.0
        return torch.where(region_mask, torch.minimum(d, nbr), d)

    return fixed_point(sweep, d0, max_iters)


class PicoGeometry(NamedTuple):
    box: torch.Tensor        # int32 box index, 0 = not a shelf cell
    d_gl: torch.Tensor       # float64
    d_if: torch.Tensor       # float64


class PicoFields(NamedTuple):
    """The whole PICO solution, for the ``pico_*`` diagnostics."""
    melt: torch.Tensor            # m/s ice equivalent, shelf cells
    T_basal: torch.Tensor         # K, shelf-base (liquidus) temperature
    box: torch.Tensor             # int32 box index (0 outside shelves)
    d_gl: torch.Tensor            # hop distance from the grounding line
    d_if: torch.Tensor            # hop distance from the ice front
    temperature: torch.Tensor     # K, box water temperature per cell
    salinity: torch.Tensor        # g/kg, box water salinity per cell
    overturning: torch.Tensor     # m3/s, basin overturning flux per cell
    contshelf: torch.Tensor       # bool, continental-shelf averaging domain


@dataclass
class Pico(OceanModel, TimeStack):
    """PICO box model. Ambient (T0, S0) are per-cell fields (2D, or
    ``(Nt, My, Mx)`` stacks with ``times`` [s], piecewise constant in
    time); with ``basin_mask`` they are averaged over each basin's
    continental shelf."""

    temperature_ocean: torch.Tensor   # T0 [K]
    salinity_ocean: torch.Tensor      # S0 [g/kg]
    config: object = None
    basin_mask: Optional[torch.Tensor] = None  # integer basin labels
    grid: object = None
    times: Optional[np.ndarray] = None   # (Nt,) [s] for forcing stacks
    period: float = 0.0                  # ocean.pico.periodic
    # (B, My, Mx) T0 [K] of an ensemble's members (``members``); None:
    # every member takes ``temperature_ocean``
    member_temperature: Optional[torch.Tensor] = None

    def __post_init__(self):
        cfg = self.config
        self.n_boxes = cfg.get_int("ocean.pico.number_of_boxes")
        self.gamma_T = cfg.get_number("ocean.pico.heat_exchange_coefficent")
        self.C_over = cfg.get_number("ocean.pico.overturning_coefficent")
        self.rho_i = cfg.get_number("constants.ice.density")
        self.rho_w = cfg.get_number("constants.sea_water.density")
        self.g = cfg.get_number("constants.standard_gravity")
        # basins without continental-shelf data: T_dummy/S_dummy ambient and
        # Beckmann-Goosse melt with meltFactor
        self.T_dummy = cfg.get_number("ocean.pico.T_dummy", "K")
        self.S_dummy = cfg.get_number("ocean.pico.S_dummy")
        self.melt_factor = cfg.get_number("ocean.pico.meltFactor")
        self.exclude_rises = cfg.get_flag("ocean.pico.exclude_ice_rises")
        self.max_gl_dist = cfg.get_flag(
            "ocean.pico.maximize_grounding_line_distance")
        self.shelf_depth = cfg.get_number("ocean.pico.continental_shelf_depth")
        self.c_w = cfg.get_number("constants.sea_water.specific_heat_capacity")
        self.L_fus = cfg.get_number(
            "constants.fresh_water.latent_heat_of_fusion")
        self.sh = (Shifter(self.grid), Shifter(self.grid, 1))  # by lead
        self.nu = self.rho_i / self.rho_w
        self.lam = LATENT / C_P_OCEAN
        self.seg = self.onehot = None
        if self.basin_mask is not None:
            # the labels are static: the basin count and one-hot once
            self.seg = torch.as_tensor(self.basin_mask).to(torch.int32)
            nb = int(self.seg.max()) + 1
            self.onehot = self.seg[None] == torch.arange(
                nb, dtype=torch.int32, device=self.seg.device)[:, None, None]

    # ------------------------------------------------------------------
    def boxes(self, geometry, lead: int = 0) -> PicoGeometry:
        """The box geometry; ``lead`` leading member dims."""
        mask = geometry.cell_type
        sh = self.sh[lead]
        shelf = S.floating_ice(mask)
        grounded = S.grounded_ice(mask)
        ocean_free = mask == S.MASK_ICE_FREE_OCEAN
        max_it = mask.shape[-2] + mask.shape[-1]

        gl_grounded = grounded
        if self.exclude_rises:
            # grounded patches not part of the main grounded body (the
            # component holding the thickest grounded ice) do not seed the
            # grounding-line distance
            Hg = torch.where(grounded, geometry.ice_thickness, -1.0)
            Hmax = S.member_max(Hg, lead)
            seed = Hg >= Hmax.view(*Hmax.shape, 1, 1)
            gl_grounded = fixed_point(
                lambda m: m | (grounded & _nbr(m, sh)), seed & grounded,
                max_it)
        gl_seed = shelf & _nbr(gl_grounded, sh)   # shelf cells at the GL
        if_seed = shelf & _nbr(ocean_free, sh)    # shelf cells at the front

        d_gl = _propagate_distance(gl_seed, shelf, sh, max_it)
        d_if = _propagate_distance(if_seed, shelf, sh, max_it)

        n = float(self.n_boxes)
        if self.max_gl_dist and self.onehot is not None:
            # box extents from the distance to the GL relative to the
            # basin-wide maximum GL distance
            dmax = torch.where(self.onehot, torch.where(
                shelf & (d_gl < 1e8), d_gl, 0.0)[..., None, :, :],
                0.0).amax(dim=(-2, -1))
            dmax_f = torch.clamp(dmax[..., self.seg.long()], min=1.0)
            r = torch.clamp(d_gl / dmax_f, 0.0, 1.0)
        else:
            r = d_gl / torch.clamp(d_gl + d_if, min=1.0)
        k = torch.arange(1, self.n_boxes + 1, dtype=r.dtype, device=r.device)
        lo = 1.0 - torch.sqrt((n - (k - 1.0)) / n)   # box k lower bound
        hi = 1.0 - torch.sqrt((n - k) / n)
        in_box = (r[..., None] >= lo) & (r[..., None] <= hi + 1e-9)
        box = torch.argmax(in_box.to(torch.uint8), dim=-1) + 1
        box = torch.where(shelf & (d_gl < 1e8) & (d_if < 1e8), box, 0)
        # shelf cells unreachable from GL or front: box n (weak melt)
        box = torch.where(shelf & (box == 0), self.n_boxes, box)
        return PicoGeometry(box.to(torch.int32), d_gl, d_if)

    def _basin_sums(self, x, lead):
        """Sums of ``x`` over each basin, (nb,) or (B, nb): on the member
        axis in ``member_sum``'s order."""
        rows = torch.where(self.onehot, x[..., None, :, :], 0.0)
        if not lead:
            return rows.sum(dim=(1, 2))
        B = x.shape[0]
        return member_sum(rows.reshape(-1, *x.shape[-2:])).view(B, -1)

    def _per_basin_mean(self, field, where, fallback=None, lead=0):
        """Mean of ``field`` over ``where`` cells per basin, scattered back
        to the cells; basins with no such cell get ``fallback`` (0 with
        None). Returns (mean field, no-data mask)."""
        w = where.to(field.dtype)
        s = self._basin_sums(field * w, lead)
        # counts of 0/1: exact in any order
        n = torch.where(self.onehot, w[..., None, :, :], 0.0).sum(
            dim=(-2, -1))
        mean = s / torch.clamp(n, min=1.0)
        if fallback is not None:
            mean = torch.where(n > 0, mean, fallback)
        seg = self.seg.long()
        return mean[..., seg], (n <= 0)[..., seg]

    def _per_basin_area(self, member_mask):
        w = member_mask.to(torch.float64)
        area = torch.where(self.onehot, w[..., None, :, :], 0.0).sum(
            dim=(-2, -1)) * self.grid.dx * self.grid.dy
        return area[..., self.seg.long()]

    def _total_area(self, member_mask, lead):
        """The shelf-wide box area, float64 and shaped (1, 1) (a member's
        (B, 1, 1)) so that it promotes the field arithmetic to float64 as
        the JAX package's strongly typed float64 sum does."""
        n = S.member_sum(torch.where(member_mask, 1.0, 0.0).to(torch.float64),
                         lead)
        area_cell = self.grid.dx * self.grid.dy
        return torch.clamp(n * area_cell, min=area_cell).reshape(
            *n.shape, 1, 1)

    # ------------------------------------------------------------------
    def inputs(self, geometry, t) -> OceanInputs:
        pf = self.solve(geometry, t)
        return OceanInputs(pf.melt, pf.T_basal)

    def members(self, geometry, t):
        """The melt rate of an ensemble's members (``geometry`` with a
        leading member axis), each with its ``member_temperature``."""
        if self.times is not None:
            raise NotImplementedError(
                "PICO forcing stacks on an ensemble's member axis are not "
                "implemented in pism_tpu_torch (ROADMAP Queue 1 item 3)")
        dtype = geometry.ice_thickness.dtype
        T0 = self.temperature_ocean
        if self.member_temperature is not None:
            T0 = self.member_temperature
            if T0.shape[0] != geometry.ice_thickness.shape[0]:
                raise ValueError(
                    f"PICO has the ocean temperatures of {T0.shape[0]} "
                    f"members, the geometry {geometry.ice_thickness.shape[0]}")
        return self._solve(geometry, T0.to(dtype),
                           self.salinity_ocean.to(dtype), 1).melt

    def solve(self, geometry, t) -> PicoFields:
        dtype = geometry.ice_thickness.dtype
        return self._solve(geometry,
                           self._constant(self.temperature_ocean, t, dtype),
                           self._constant(self.salinity_ocean, t, dtype), 0)

    def _solve(self, geometry, T0, S0, lead) -> PicoFields:
        """PICO on ``geometry`` with the ambient (T0, S0) of the field
        dtype; ``lead`` leading member dims."""
        pg = self.boxes(geometry, lead)
        shelf = S.floating_ice(geometry.cell_type)
        H = geometry.ice_thickness
        dtype = H.dtype
        # pressure at the shelf base (ice overburden)
        p = self.rho_i * self.g * H

        cont = torch.zeros(H.shape, dtype=torch.bool, device=H.device)
        no_data = cont
        basins = self.onehot is not None
        if basins:
            # ambient water properties averaged over each basin's
            # continental shelf (ocean cells above the shelf-depth cutoff)
            cont = (geometry.cell_type == S.MASK_ICE_FREE_OCEAN) & \
                (geometry.bed_elevation >= self.shelf_depth)
            cont = cont | shelf  # cavity cells where no shelf cells
            T0, no_data = self._per_basin_mean(T0, cont,
                                               fallback=self.T_dummy,
                                               lead=lead)
            S0, _ = self._per_basin_mean(S0, cont, fallback=self.S_dummy,
                                         lead=lead)

        area_cell = self.grid.dx * self.grid.dy
        melt = torch.zeros_like(H)
        T_basal = torch.full_like(H, B_LIQ)

        def area(member):
            if basins:
                return torch.clamp(self._per_basin_area(member), min=area_cell)
            return self._total_area(member, lead)

        # --- box 1 (quadratic; Reese et al. 2018 eq. A6) -------------------
        box1 = pg.box == 1
        g1 = area(box1) * self.gamma_T
        s1 = S0 / (self.nu * self.lam)
        Tf0 = A_LIQ * S0 + B_LIQ + C_LIQ * p
        Tstar1 = Tf0 - T0                       # <= 0 for warm water
        denom = self.C_over * RHO_STAR * (BETA_RHO * s1 - ALPHA_RHO)
        eta = g1 / torch.clamp(denom, min=1e-30)
        x = -0.5 * eta + torch.sqrt(torch.clamp(0.25 * eta ** 2 - eta * Tstar1,
                                                min=0.0))
        T1 = T0 - x
        S1 = S0 - S0 * x / (self.nu * self.lam)
        q = self.C_over * RHO_STAR * (BETA_RHO * (S0 - S1)
                                      - ALPHA_RHO * (T0 - T1))

        def box_melt(Tk, Sk, pk):
            Tf = A_LIQ * Sk + B_LIQ + C_LIQ * pk
            return -self.gamma_T / (self.nu * self.lam) * (Tf - Tk)

        m1 = box_melt(T1, S1, p)
        melt = torch.where(box1, m1, melt)
        T_basal = torch.where(box1, A_LIQ * S1 + B_LIQ + C_LIQ * p, T_basal)
        T_field = torch.where(box1, T1, T0.expand(H.shape))
        S_field = torch.where(box1, S1, S0.expand(H.shape))

        # --- boxes k >= 2 (sequential cascade; eq. A11-A12) ----------------
        Tk, Sk = T1, S1
        for kk in range(2, self.n_boxes + 1):
            in_k = pg.box == kk
            gk = area(in_k) * self.gamma_T
            Tfk = A_LIQ * Sk + B_LIQ + C_LIQ * p
            Tstark = Tfk - Tk
            xk = -gk * Tstark / torch.clamp(
                q + gk - gk * A_LIQ * Sk / (self.nu * self.lam), min=1e-30)
            Tk_new = Tk - xk
            Sk_new = Sk - Sk * xk / (self.nu * self.lam)
            mk = box_melt(Tk_new, Sk_new, p)
            melt = torch.where(in_k, mk, melt)
            T_basal = torch.where(in_k, A_LIQ * Sk_new + B_LIQ + C_LIQ * p,
                                  T_basal)
            T_field = torch.where(in_k, Tk_new, T_field)
            S_field = torch.where(in_k, Sk_new, S_field)
            Tk, Sk = Tk_new, Sk_new

        if basins:
            # shelves in basins with no ambient data: Beckmann-Goosse melt
            # with ocean.pico.meltFactor on the T_dummy/S_dummy ambient
            Tf_bg = A_LIQ * S0 + B_LIQ + C_LIQ * p
            gamma_bg = 1e-4   # Beckmann & Goosse (2003) exchange velocity
            m_bg = (self.melt_factor * self.rho_w * self.c_w * gamma_bg
                    / (self.rho_i * self.L_fus)) \
                * torch.clamp(T0 - Tf_bg, min=0.0)
            melt = torch.where(no_data, m_bg, melt)
            T_basal = torch.where(no_data, Tf_bg, T_basal)
        melt = torch.where(shelf, melt, 0.0)
        q_field = torch.where(shelf, q.expand(H.shape), 0.0)
        return PicoFields(melt.to(dtype), T_basal.to(dtype),
                          pg.box, pg.d_gl, pg.d_if,
                          torch.where(shelf, T_field, 0.0).to(dtype),
                          torch.where(shelf, S_field, 0.0).to(dtype),
                          q_field.to(dtype), cont)
