"""Calving, front retreat and iceberg removal (port of
``pism_tpu/model/calving.py``): ``thickness_calving``, ``ocean_kill``,
``float_kill`` (with ``margin_only`` and ``calve_near_grounding_line``),
the rate laws ``eigen_calving`` (with ``make_margin_floating``),
``vonmises_calving`` and ``hayhurst_calving`` and a frontal-melt rate
(``coupler/frontalmelt.py``, at marine fronts; floating ones with
``frontal_melt.include_floating_ice``) summed into one retreat rate and
applied as a front retreat (part-grid aware, or by thickness scaling
without part-grid), the retreat split between calving and frontal melt by
rate share, the front-retreat dt limit and iceberg removal; the
file-driven inputs: ``prescribed_retreat`` (the ISMIP6 retreat masks of
``geometry.front_retreat.prescribed.file``), the rate-scaling series
(``calving.rate_scaling.file``) and the 2D threshold fields
(``calving.thickness_calving.file``,
``calving.vonmises_calving.sigma_max_file``). A retreat mask's record and
the scaling's value are found on the host from the host time.

Icebergs are removed by a flood fill from grounded ice over the icy mask.
The JAX package runs it as a ``lax.while_loop`` until no cell changes
(``pism_tpu/model/calving.py:60``); here it is
``util.hostsync.fixed_point``, which reads the change flag once per few
sweeps.

On an ensemble's member axis (``lead = 1``, ``(B, My, Mx)`` fields)
``thickness_calving``, ``eigen_calving`` (its retreat over a ``(B, 1, 1)``
dt, its front-retreat rate a max per member) and iceberg removal run for
all members at once; the flood fill sweeps until no member changes (under
``vmap`` the JAX loop runs until its last member is done, the others
frozen at their fixed point). The other methods and float kill raise
NotImplementedError there.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .. import state as S
from ..ops.stencils import Shifter
from ..util.hostsync import fixed_point
from ..util.units import SEC_PER_YEAR

RATE_METHODS = ("eigen_calving", "vonmises_calving", "hayhurst_calving")


@dataclass
class PrescribedRetreat:
    """PISM ``-front_retreat prescribed`` (the ISMIP6 ``retreat_file``
    protocol): a series of ice-extent fraction masks in [0, 1], the
    thickness scaled by the record at or before t (clamped at the ends)."""

    times: np.ndarray           # (Nt,) [s], sorted
    fraction: torch.Tensor      # (Nt, My, Mx) in [0, 1]

    def __call__(self, H, t: float):
        k = int(np.clip(np.searchsorted(self.times, t, side="right") - 1,
                        0, self.times.shape[0] - 1))
        return H * torch.clamp(self.fraction[k].to(H.dtype), 0.0, 1.0)


def front_mask(icy, ice_free_ocean, sh):
    """Cells at the calving front: icy with an ice-free-ocean neighbor."""
    nbr_ocean = (sh(ice_free_ocean, 0, 1) | sh(ice_free_ocean, 0, -1)
                 | sh(ice_free_ocean, 1, 0) | sh(ice_free_ocean, -1, 0))
    return icy & nbr_ocean


def remove_icebergs(geometry, sh, max_iters: Optional[int] = None):
    """Drop floating cells not connected (4-neighborhood) to grounded ice;
    ``sh.lead`` leading member dims."""
    mask = geometry.cell_type
    icy = S.icy(mask)
    if max_iters is None:
        max_iters = mask.shape[-2] + mask.shape[-1]
    reached = fixed_point(
        lambda r: r | (icy & (sh(r, 0, 1) | sh(r, 0, -1) | sh(r, 1, 0)
                              | sh(r, -1, 0))),
        S.grounded_ice(mask), max_iters)
    berg = icy & ~reached
    return geometry.replace(
        ice_thickness=torch.where(berg, 0.0, geometry.ice_thickness),
        ice_area_specific_volume=torch.where(
            berg, 0.0, geometry.ice_area_specific_volume))


@dataclass
class CalvingModel:
    """Composite calving component (PISM ``calving.methods``)."""

    grid: object
    config: object
    # "ocean_kill": calve all ice in these cells (PISM ``calving
    # ocean_kill``); left None, ``IceModel.prepare_state`` takes it from
    # calving.ocean_kill.file or the initial state's ice-free ocean
    ocean_kill_mask: Optional[torch.Tensor] = None
    lead: int = 0    # leading member dims of the fields (an ensemble's 1)
    # the methods; empty: ``calving.methods``. ("none",) is the front
    # retreat of a frontal melt with no calving law
    methods: tuple = ()
    prescribed_retreat: Optional[PrescribedRetreat] = None
    device: object = "cpu"   # of the fields read from files

    def __post_init__(self):
        cfg = self.config
        self.sh = Shifter(self.grid, self.lead)
        m = ",".join(self.methods) if self.methods \
            else cfg.get_string("calving.methods")
        self.methods = tuple(s.strip() for s in m.split(",") if s.strip())
        if self.lead and (set(self.methods) - {"thickness_calving",
                                               "eigen_calving"}
                          or cfg.get_flag("calving.float_kill.enabled")):
            raise NotImplementedError(
                f"calving.methods = {m!r} (float kill "
                f"{cfg.get_flag('calving.float_kill.enabled')}) in an "
                "ensemble is not implemented in pism_tpu_torch (supported: "
                "thickness_calving, eigen_calving and iceberg removal; "
                "ROADMAP Queue 1 item 3)")
        for name in self.methods:
            if name not in ("none", "thickness_calving", "ocean_kill",
                            "float_kill", "prescribed_retreat") + RATE_METHODS:
                raise NotImplementedError(
                    f"calving method {name!r} is not implemented in "
                    "pism_tpu_torch (ROADMAP Queue 1 item 7)")
        self.H_threshold = cfg.get_number("calving.thickness_calving.threshold")
        self.eigen_K = cfg.get_number("calving.eigen_calving.K")
        self.vm_sigma_max = cfg.get_number("calving.vonmises_calving.sigma_max")
        self.n_glen = cfg.get_number("stress_balance.ssa.Glen_exponent")
        self.hh_B_tilde = cfg.get_number("calving.hayhurst_calving.B_tilde")
        self.hh_r = cfg.get_number("calving.hayhurst_calving.exponent_r")
        self.hh_sigma_th = cfg.get_number(
            "calving.hayhurst_calving.sigma_threshold")
        self.hh_modifier = cfg.get_number("calving.hayhurst_calving.modifier")
        self.rho_i = cfg.get_number("constants.ice.density")
        self.rho_w = cfg.get_number("constants.sea_water.density")
        self.g = cfg.get_number("constants.standard_gravity")
        self.remove_bergs = cfg.get_flag("geometry.remove_icebergs")
        self.fm_floating = cfg.get_flag("frontal_melt.include_floating_ice")
        self.float_kill = cfg.get_flag("calving.float_kill.enabled") or \
            "float_kill" in self.methods
        self.fk_margin_only = cfg.get_flag("calving.float_kill.margin_only")
        self.fk_near_gl = cfg.get_flag(
            "calving.float_kill.calve_near_grounding_line")
        self.eigen_margin_floating = cfg.get_flag(
            "calving.eigen_calving.make_margin_floating")
        # with part-grid, rate-based retreat converts front cells into
        # partially filled (Href) cells; without it, thickness scaling
        self.part_grid = cfg.get_flag("geometry.part_grid.enabled")
        self.rate_methods = tuple(m for m in RATE_METHODS if m in self.methods)
        self.rate_scaling = None
        path = cfg.get_string("calving.rate_scaling.file")
        if path:
            from ..util.forcing import ScalarForcing
            self.rate_scaling = ScalarForcing.from_file(
                path, "frac_calving_rate",
                calendar=cfg.get_string("time.calendar"),
                reference_date=cfg.get_string("time.reference_date"))
        # 2D threshold fields override the scalar thresholds where given
        self.H_threshold_field = self._read_2d(
            cfg.get_string("calving.thickness_calving.file"),
            ["calving_threshold", "thickness_calving_threshold"])
        self.vm_sigma_max_field = self._read_2d(
            cfg.get_string("calving.vonmises_calving.sigma_max_file"),
            ["vonmises_calving_threshold", "sigma_max"])
        if self.prescribed_retreat is None \
                and "prescribed_retreat" in self.methods:
            self.prescribed_retreat = self._read_retreat(cfg)

    def _read_2d(self, path, names):
        """The first of ``names`` in ``path`` (a stack: its last record),
        float64 on the card, as the JAX package loads it."""
        if not path:
            return None
        from ..io.bootstrap import read_forcing_fields
        fields, _ = read_forcing_fields(path, self.grid, names)
        for n in names:
            if n in fields:
                a = np.asarray(fields[n])
                return torch.as_tensor(a[-1] if a.ndim == 3 else a,
                                       dtype=torch.float64,
                                       device=self.device)
        raise ValueError(f"{path!r}: none of {names} found")

    def _read_retreat(self, cfg):
        """The retreat masks of geometry.front_retreat.prescribed.file."""
        path = cfg.get_string("geometry.front_retreat.prescribed.file")
        if not path:
            raise ValueError("calving method 'prescribed_retreat' needs "
                             "geometry.front_retreat.prescribed.file")
        from ..io.bootstrap import read_forcing_fields
        fields, times = read_forcing_fields(
            path, self.grid, ["land_ice_area_fraction_retreat"],
            calendar=cfg.get_string("time.calendar"),
            reference_date=cfg.get_string("time.reference_date"))
        fr = fields.get("land_ice_area_fraction_retreat")
        if fr is None:
            raise ValueError(f"{path!r} has no land_ice_area_fraction_retreat")
        fr = np.asarray(fr)
        if fr.ndim == 2:
            fr, times = fr[None], np.zeros(1)
        return PrescribedRetreat(
            times=np.asarray(times, np.float64),
            fraction=torch.as_tensor(np.nan_to_num(fr, nan=1.0),
                                     dtype=torch.float64, device=self.device))

    # -- strain-rate eigenvalues from the SSA velocity ---------------------
    def _strain_eigenvalues(self, u, v):
        sh = self.sh
        dx, dy = self.grid.dx, self.grid.dy
        ux = (sh(u, 0, 1) - sh(u, 0, -1)) / (2 * dx)
        uy = (sh(u, 1, 0) - sh(u, -1, 0)) / (2 * dy)
        vx = (sh(v, 0, 1) - sh(v, 0, -1)) / (2 * dx)
        vy = (sh(v, 1, 0) - sh(v, -1, 0)) / (2 * dy)
        exy = 0.5 * (uy + vx)
        tr = 0.5 * (ux + vy)
        det = torch.sqrt(torch.clamp((0.5 * (ux - vy)) ** 2 + exy ** 2,
                                     min=0.0))
        return tr + det, tr - det  # eigen1 >= eigen2

    def hayhurst_rate(self, geometry):
        """Hayhurst-stress calving rate [m/s] (PISM ``HayhurstCalving``;
        Mercenier et al. 2018): B_tilde (1-w)^(-r) <sigma_0 - sigma_th>^r
        with w the water-depth-to-thickness ratio, B_tilde in
        [MPa^-r / year], sigma in MPa."""
        H = geometry.ice_thickness
        Hsafe = torch.clamp(H, min=1.0)
        water_depth = torch.clamp(geometry.sea_level - geometry.bed_elevation,
                                  min=0.0)
        w = torch.clamp(water_depth / Hsafe, 0.0, self.rho_i / self.rho_w)
        sigma_0 = (0.4 - 0.45 * (w - 0.065) ** 2) * self.rho_i * self.g * H \
            * (1.0 - self.rho_w / self.rho_i * w ** 2)   # Pa
        sigma_0_mpa = torch.clamp(sigma_0, min=0.0) * 1e-6
        sigma_th_mpa = self.hh_sigma_th * 1e-6
        excess = torch.clamp(sigma_0_mpa - sigma_th_mpa, min=0.0)
        rate_per_year = self.hh_B_tilde * (1.0 - w) ** (-self.hh_r) \
            * excess ** self.hh_r
        return self.hh_modifier * rate_per_year / SEC_PER_YEAR

    def retreat_rate(self, geometry, u_ssa, v_ssa, hardness_B=None):
        """Total horizontal retreat rate [m/s] of the rate laws."""
        rate = torch.zeros_like(geometry.ice_thickness)
        if "eigen_calving" in self.methods and self.eigen_K > 0:
            l1, l2 = self._strain_eigenvalues(u_ssa, v_ssa)
            rate = rate + self.eigen_K * torch.clamp(l1, min=0.0) \
                * torch.clamp(l2, min=0.0)
        if "vonmises_calving" in self.methods and hardness_B is not None:
            # von Mises tensile stress (Morlighem et al. 2016)
            l1, l2 = self._strain_eigenvalues(u_ssa, v_ssa)
            e1, e2 = torch.clamp(l1, min=0.0), torch.clamp(l2, min=0.0)
            eff = torch.sqrt(0.5 * (e1 ** 2 + e2 ** 2))
            sigma = math.sqrt(3.0) * hardness_B * eff ** (1.0 / self.n_glen)
            speed = torch.sqrt(u_ssa ** 2 + v_ssa ** 2)
            sig_max = self.vm_sigma_max if self.vm_sigma_max_field is None \
                else self.vm_sigma_max_field.to(sigma.dtype)
            rate = rate + speed * sigma / sig_max
        if "hayhurst_calving" in self.methods:
            rate = rate + self.hayhurst_rate(geometry)
        return rate

    def _law_where(self, front, floating, marine):
        """The cells the rate laws act on: floating front cells; marine
        ones too with Hayhurst (it targets grounded termini) or
        ``eigen_calving.make_margin_floating``."""
        if "hayhurst_calving" in self.methods or self.eigen_margin_floating:
            return front & (floating | marine)
        return front & floating

    def _melt_where(self, front, floating, marine):
        """The cells a frontal-melt rate acts on: marine front cells,
        floating ones only with ``frontal_melt.include_floating_ice``."""
        where = front & marine
        return where if self.fm_floating else where & ~floating

    def applicable_rate(self, geometry, sb, hardness_B=None,
                        frontal_melt_rate=None):
        """Per-cell horizontal retreat rate [m/s] that ``step`` would apply
        on its front cells (the dt limit's input): the laws' rates and the
        frontal-melt rate."""
        mask = geometry.cell_type
        floating = S.floating_ice(mask)
        front = front_mask(S.icy(mask), mask == S.MASK_ICE_FREE_OCEAN,
                           self.sh)
        marine = geometry.sea_level - geometry.bed_elevation > 0.0
        total = torch.zeros_like(geometry.ice_thickness)
        if self.rate_methods:
            rate = self.retreat_rate(geometry, sb.u_ssa, sb.v_ssa,
                                     hardness_B=hardness_B)
            where = front & floating
            if "hayhurst_calving" in self.methods:
                where = front & (floating | marine)
            total = total + torch.where(where, rate, 0.0)
        if frontal_melt_rate is not None:
            total = total + torch.where(
                self._melt_where(front, floating, marine),
                torch.clamp(frontal_melt_rate, min=0.0), 0.0)
        return total

    def max_rate(self, geometry, sb, hardness_B=None, frontal_melt_rate=None):
        """max of ``applicable_rate``, a 0-dim device tensor (on the member
        axis one per member, (B,)): the caller reads it with its other
        maxima in one host sync and turns it into a dt with
        ``max_timestep_from_rate``."""
        return S.member_max(self.applicable_rate(
            geometry, sb, hardness_B, frontal_melt_rate), self.lead)

    def max_timestep_from_rate(self, r_max: float, dtype) -> float:
        """dt so that the fastest front cell retreats at most one grid cell
        per step (PISM ``FrontRetreat::max_timestep``); rates below 1 m/a
        (compared in the field dtype) impose no limit."""
        threshold = torch.tensor(1.0 / SEC_PER_YEAR, dtype=dtype).item()
        return self.grid.dx / r_max if r_max > threshold else math.inf

    def _retreat_partgrid(self, H, Href, rate, dt, icy, ifo):
        """Linear, part-grid-aware application of a horizontal retreat rate
        (PISM ``FrontRetreat::update_geometry``): partially filled cells
        seaward of the ice absorb the retreat first (their Href shrinks at
        the icy-neighbour mean thickness), and full front cells with an
        exposed ocean edge become partial cells with
        ``Href = H (1 - rate dt / dx)``; ``dt`` a host float, or a
        member's (B, 1, 1) tensor of such floats. Returns (H, Href,
        removed)."""
        sh = self.sh
        dx = self.grid.dx

        def nb_sum(a):
            return sh(a, 0, 1) + sh(a, 0, -1) + sh(a, 1, 0) + sh(a, -1, 0)

        def nb_max(a):
            return torch.maximum(torch.maximum(sh(a, 0, 1), sh(a, 0, -1)),
                                 torch.maximum(sh(a, 1, 0), sh(a, -1, 0)))

        Href0 = Href
        icy_f = icy.to(H.dtype)
        n_icy = nb_sum(icy_f)
        H_ref = nb_sum(torch.where(icy, H, 0.0)) / torch.clamp(n_icy, min=1.0)
        # 1. partial cells seaward of the front retreat at their fastest
        # icy neighbour's rate
        partial = ifo & (Href0 > 0.0) & (n_icy > 0)
        rate_p = nb_max(torch.where(icy, rate, 0.0))
        dfrac_p = torch.clamp(rate_p * dt / dx, 0.0, 1.0)
        dHref = torch.where(partial, torch.minimum(H_ref * dfrac_p, Href0),
                            0.0)
        Href = Href0 - dHref
        # 2. full front cells with an exposed ocean edge convert to partial
        exposed = nb_sum((ifo & (Href0 <= 0.0)).to(H.dtype)) > 0
        dfrac = torch.clamp(rate * dt / dx, 0.0, 1.0)
        convert = icy & exposed & (dfrac > 0.0)
        removed_full = torch.where(convert, H * dfrac, 0.0)
        Href = torch.where(convert, Href + H - removed_full, Href)
        H = torch.where(convert, 0.0, H)
        return H, Href, removed_full + dHref

    def step(self, geometry, sb=None, dt=0.0, t=0.0, hardness_B=None,
             frontal_melt_rate=None, with_parts: bool = False):
        """Apply the calving laws, the rate-based retreat over ``dt``
        seconds (``sb`` gives the SSA velocity, None with no rate law;
        ``hardness_B`` the vertically averaged hardness of the von Mises
        law; ``frontal_melt_rate`` [m/s] a frontal-melt coupler's rate,
        summed with the laws' into one retreat rate) and iceberg removal.
        With ``with_parts=True`` return ``(geometry, parts)``, ``parts`` the
        per-mechanism thickness changes [m] (<= 0, counted as H + Href):
        ``calving`` (the laws and iceberg removal), ``frontal_melt`` (the
        retreat's share of the melt rate) and ``forced_retreat`` (the
        prescribed retreat's)."""
        sh = self.sh
        mask = geometry.cell_type
        icy = S.icy(mask)
        floating = S.floating_ice(mask)
        ifo = mask == S.MASK_ICE_FREE_OCEAN
        front = front_mask(icy, ifo, sh)
        H = geometry.ice_thickness
        Href = geometry.ice_area_specific_volume
        H_in, Href_in = H, Href

        if self.float_kill:
            kill = floating
            if self.fk_margin_only:
                kill = kill & front
            if not self.fk_near_gl:
                # keep the floating cells attached to grounded ice
                grounded = S.grounded_ice(mask)
                near_gl = (sh(grounded, 0, 1) | sh(grounded, 0, -1)
                           | sh(grounded, 1, 0) | sh(grounded, -1, 0))
                kill = kill & ~near_gl
            H = torch.where(kill, 0.0, H)

        okm = None
        if "ocean_kill" in self.methods and self.ocean_kill_mask is not None:
            okm = self.ocean_kill_mask.to(device=H.device, dtype=torch.bool)
            H = torch.where(okm, 0.0, H)

        if "thickness_calving" in self.methods and self.H_threshold > 0:
            H_thr = self.H_threshold if self.H_threshold_field is None \
                else self.H_threshold_field.to(H.dtype)
            calve = front & floating & (H < H_thr)
            H = torch.where(calve, 0.0, H)
        C_inst = H + Href   # ice content after the instantaneous laws

        # rate-based retreat: the laws' rates and the frontal melt summed
        # into one horizontal retreat rate and applied together; the removed
        # ice is split between the two by rate share
        marine = geometry.sea_level - geometry.bed_elevation > 0.0
        rate_c = rate_f = None
        if self.rate_methods:
            r = self.retreat_rate(geometry, sb.u_ssa, sb.v_ssa,
                                  hardness_B=hardness_B)
            if self.rate_scaling is not None:
                # calving.rate_scaling.file: a scalar series times every
                # calving law's rate, in the field dtype
                r = r * torch.tensor(self.rate_scaling(t), dtype=r.dtype).item()
            rate_c = torch.where(self._law_where(front, floating, marine),
                                 torch.clamp(r, min=0.0), 0.0)
        if frontal_melt_rate is not None:
            rate_f = torch.where(self._melt_where(front, floating, marine),
                                 torch.clamp(frontal_melt_rate, min=0.0), 0.0)
        share_c = None
        if rate_c is not None or rate_f is not None:
            if rate_c is None:
                rate_c = torch.zeros_like(H)
            rate = rate_c if rate_f is None else rate_c + rate_f
            if rate_f is not None:
                pos = rate > 0.0
                share_c = torch.where(
                    pos, rate_c / torch.where(pos, rate, 1.0), 1.0)
            if self.part_grid:
                H, Href, _ = self._retreat_partgrid(H, Href, rate, dt,
                                                    icy, ifo)
            else:
                # thickness scaling: the front face sweeps rate*dt into the
                # cell of size dx
                loss_frac = torch.clamp(rate * dt / self.grid.dx, 0.0, 1.0)
                H = H - H * loss_frac
        C_rate = H + Href
        if self.prescribed_retreat is not None:
            H = self.prescribed_retreat(H, t)
        C_forced = H + Href

        geometry = geometry.replace(ice_thickness=H,
                                    ice_area_specific_volume=Href)
        if okm is not None:
            geometry = geometry.replace(ice_area_specific_volume=torch.where(
                okm, 0.0, geometry.ice_area_specific_volume))
        if self.remove_bergs:
            geometry = remove_icebergs(geometry, sh)
        if not with_parts:
            return geometry
        # per-mechanism ice-content deltas [m] (content = H + Href, so a
        # full-to-partial conversion is no loss); iceberg removal is part of
        # calving. Without frontal melt the JAX package's rate share is 1
        # exactly, so its sum is this one to the bit.
        C_out = geometry.ice_thickness + geometry.ice_area_specific_volume
        zero = torch.zeros_like(C_out)
        rate_d = C_rate - C_inst
        parts = {
            "calving": (C_inst - (H_in + Href_in))
            + (rate_d if share_c is None else rate_d * share_c)
            + (C_out - C_forced),
            "frontal_melt": zero if share_c is None
            else rate_d * (1.0 - share_c),
            "forced_retreat": zero if self.prescribed_retreat is None
            else C_forced - C_rate,
        }
        return geometry, parts


def calving_from_config(grid, config, lead: int = 0, device="cpu"):
    if not config.get_string("calving.methods") \
            and not config.get_flag("calving.float_kill.enabled") \
            and not config.get_flag("geometry.remove_icebergs"):
        return None
    return CalvingModel(grid=grid, config=config, lead=lead, device=device)
