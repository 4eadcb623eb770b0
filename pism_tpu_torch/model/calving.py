"""Calving and iceberg removal (port of ``pism_tpu/model/calving.py``:
``thickness_calving``, ``ocean_kill`` with an explicit kill mask, and
``remove_icebergs``; other methods raise).

Icebergs are removed by a flood fill from grounded ice over the icy mask.
The JAX package runs it as a ``lax.while_loop`` until no cell changes
(``pism_tpu/model/calving.py:60``); here it is a host loop that checks for
change every ``CHECK_EVERY`` sweeps. Extra sweeps after convergence change
nothing, so the result is the same with fewer host syncs.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from .. import state as S
from ..config import require
from ..ops.stencils import Shifter
from ..util.hostsync import host

CHECK_EVERY = 8


def front_mask(icy, ice_free_ocean, sh):
    """Cells at the calving front: icy with an ice-free-ocean neighbor."""
    nbr_ocean = (sh(ice_free_ocean, 0, 1) | sh(ice_free_ocean, 0, -1)
                 | sh(ice_free_ocean, 1, 0) | sh(ice_free_ocean, -1, 0))
    return icy & nbr_ocean


def remove_icebergs(geometry, sh, max_iters: Optional[int] = None):
    """Drop floating cells not connected (4-neighborhood) to grounded ice."""
    mask = geometry.cell_type
    icy = S.icy(mask)
    reached = S.grounded_ice(mask)
    if max_iters is None:
        max_iters = mask.shape[0] + mask.shape[1]
    it = 0
    while it < max_iters:
        before = reached
        for _ in range(min(CHECK_EVERY, max_iters - it)):
            reached = reached | (icy & (sh(reached, 0, 1) | sh(reached, 0, -1)
                                        | sh(reached, 1, 0) | sh(reached, -1, 0)))
            it += 1
        if not host(torch.any(reached != before)):
            break
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
    # ocean_kill``); the port takes the mask only from its caller
    ocean_kill_mask: Optional[torch.Tensor] = None

    def __post_init__(self):
        cfg = self.config
        self.sh = Shifter(self.grid)
        m = cfg.get_string("calving.methods")
        self.methods = tuple(s.strip() for s in m.split(",") if s.strip())
        for name in self.methods:
            if name not in ("thickness_calving", "ocean_kill"):
                raise NotImplementedError(
                    f"calving method {name!r} is not implemented in "
                    "pism_tpu_torch (supported: 'thickness_calving', "
                    "'ocean_kill')")
        if "ocean_kill" in self.methods and self.ocean_kill_mask is None:
            raise NotImplementedError(
                "ocean_kill without an explicit kill mask (PISM's default "
                "from the input file) is not implemented in pism_tpu_torch")
        require(cfg, "calving.float_kill.enabled", (False,))
        require(cfg, "calving.thickness_calving.file", ("",))
        require(cfg, "frontal_melt.models", ("", "none"))
        require(cfg, "calving.front_retreat.use_cfl", (False,))
        require(cfg, "geometry.front_retreat.use_cfl", (False,))
        self.H_threshold = cfg.get_number("calving.thickness_calving.threshold")
        self.remove_bergs = cfg.get_flag("geometry.remove_icebergs")

    def step(self, geometry, with_parts: bool = False):
        """Apply the calving laws and iceberg removal. With
        ``with_parts=True`` also return the calving thickness change [m]
        (<= 0, counted as H + Href)."""
        mask = geometry.cell_type
        icy = S.icy(mask)
        H = geometry.ice_thickness
        C_in = H + geometry.ice_area_specific_volume
        kill = None
        if "ocean_kill" in self.methods:
            kill = self.ocean_kill_mask.to(device=H.device, dtype=torch.bool)
            H = torch.where(kill, 0.0, H)
        if "thickness_calving" in self.methods and self.H_threshold > 0:
            front = front_mask(icy, mask == S.MASK_ICE_FREE_OCEAN, self.sh)
            calve = front & S.floating_ice(mask) & (H < self.H_threshold)
            H = torch.where(calve, 0.0, H)
        geometry = geometry.replace(ice_thickness=H)
        if kill is not None:
            geometry = geometry.replace(ice_area_specific_volume=torch.where(
                kill, 0.0, geometry.ice_area_specific_volume))
        if self.remove_bergs:
            geometry = remove_icebergs(geometry, self.sh)
        if not with_parts:
            return geometry
        return geometry, (geometry.ice_thickness
                          + geometry.ice_area_specific_volume - C_in)


def calving_from_config(grid, config):
    if not config.get_string("calving.methods") \
            and not config.get_flag("calving.float_kill.enabled") \
            and not config.get_flag("geometry.remove_icebergs"):
        return None
    return CalvingModel(grid=grid, config=config)
