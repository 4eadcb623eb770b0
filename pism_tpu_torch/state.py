"""Model state (port of ``pism_tpu/state.py``).

``Geometry`` and ``ModelState`` are dataclasses of torch tensors on one
device; ``replace`` returns a new object, as in the JAX package. Cell-type
mask values match PISM's ``MASK_*`` constants.

An ensemble's state has a leading member axis on every field (2D fields
``(B, My, Mx)``, 3D ``(B, My, Mx, Mz)``), the layout of the JAX package's
``parallel/ensemble.stack_states``; functions that shift take ``lead``, the
number of those leading dims, and the helpers at the end reduce or scale
per member.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

# PISM mask values (src/util/Mask.hh)
MASK_UNKNOWN = -1
MASK_ICE_FREE_BEDROCK = 0
MASK_GROUNDED = 2
MASK_FLOATING = 3
MASK_ICE_FREE_OCEAN = 4


@dataclass(frozen=True)
class Geometry:
    """Ice geometry; primary fields + derived fields kept consistent by
    :func:`ensure_consistency` (PISM ``Geometry::ensure_consistency``)."""

    ice_thickness: torch.Tensor            # H >= 0, (My, Mx)
    bed_elevation: torch.Tensor            # b
    sea_level: torch.Tensor                # z_sl
    ice_area_specific_volume: torch.Tensor  # part-grid Href [m]
    # derived:
    ice_surface_elevation: torch.Tensor    # s
    cell_type: torch.Tensor                # int32 MASK_*
    cell_grounded_fraction: torch.Tensor   # in [0, 1]

    def replace(self, **kw) -> "Geometry":
        return dataclasses.replace(self, **kw)


def new_geometry(thickness, bed, sea_level=None, Href=None,
                 ice_density=910.0, ocean_density=1028.0,
                 ice_free_thickness=0.01, subgl: bool = False) -> Geometry:
    thickness = torch.as_tensor(thickness)
    bed = torch.as_tensor(bed, device=thickness.device)
    z = torch.zeros_like(thickness)
    g = Geometry(
        ice_thickness=thickness,
        bed_elevation=bed,
        sea_level=z if sea_level is None else torch.as_tensor(
            sea_level, device=thickness.device),
        ice_area_specific_volume=z if Href is None else Href,
        ice_surface_elevation=z,
        cell_type=torch.zeros(thickness.shape, dtype=torch.int32,
                              device=thickness.device),
        cell_grounded_fraction=z,
    )
    return ensure_consistency(g, ice_density, ocean_density,
                              ice_free_thickness,
                              compute_grounded_fraction=subgl)


def grounded_fraction(H, b, sl, mu, lead: int = 0):
    """Sub-grid grounded area fraction by linear interpolation of the
    flotation excess F = mu H - (sl - b) between neighboring cell centers
    (PISM ``grounded_cell_fraction()``). Edge-clamped ghosts; ``lead``
    leading member dims."""
    from .ops.stencils import shift

    F = mu * H - torch.clamp(sl - b, min=0.0)

    def lam(Fa, Fb):
        """Fraction of the segment from a to b with F > 0."""
        both_pos = (Fa >= 0) & (Fb >= 0)
        both_neg = (Fa < 0) & (Fb < 0)
        diff = Fa - Fb
        cross = Fa / torch.where(diff == 0, torch.full_like(diff, 1e-30), diff)
        frac_a_pos = torch.clamp(cross, 0.0, 1.0)
        frac = torch.where(Fa >= 0, frac_a_pos, 1.0 - frac_a_pos)
        return torch.where(both_pos, 1.0, torch.where(both_neg, 0.0, frac))

    gf = 0.0
    for jy, ix in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        F_mid = 0.5 * (F + shift(F, jy, ix, lead=lead))   # value at the face
        gf = gf + lam(F, F_mid)
    return torch.clamp(gf / 4.0, 0.0, 1.0).to(H.dtype)


def ensure_consistency(g: Geometry, ice_density: float, ocean_density: float,
                       ice_free_thickness: float = 0.01,
                       compute_grounded_fraction: bool = False,
                       lead: int = 0) -> Geometry:
    """Recompute surface elevation, cell type, grounded fraction from
    (H, bed, sea_level) via the flotation criterion; ``lead`` leading
    member dims."""
    H, b, sl = g.ice_thickness, g.bed_elevation, g.sea_level
    mu = ice_density / ocean_density
    water_depth = torch.clamp(sl - b, min=0.0)
    is_floating = (H * mu) < water_depth
    has_ice = H > ice_free_thickness

    surface = torch.where(is_floating, sl + H * (1.0 - mu), b + H)

    mask = torch.where(
        has_ice,
        torch.where(is_floating, MASK_FLOATING, MASK_GROUNDED),
        torch.where(b < sl, MASK_ICE_FREE_OCEAN, MASK_ICE_FREE_BEDROCK),
    ).to(torch.int32)

    if compute_grounded_fraction:
        gf = grounded_fraction(H, b, sl, mu, lead)
        gf = torch.where(has_ice, gf,
                         torch.where(b < sl, 0.0, 1.0).to(H.dtype))
    else:
        gf = torch.where(is_floating & has_ice, 0.0, 1.0).to(H.dtype)

    return g.replace(ice_surface_elevation=surface, cell_type=mask,
                     cell_grounded_fraction=gf)


def icy(cell_type):
    return (cell_type == MASK_GROUNDED) | (cell_type == MASK_FLOATING)


def grounded(cell_type):
    return (cell_type == MASK_GROUNDED) | (cell_type == MASK_ICE_FREE_BEDROCK)


def ocean(cell_type):
    return (cell_type == MASK_FLOATING) | (cell_type == MASK_ICE_FREE_OCEAN)


def grounded_ice(cell_type):
    return cell_type == MASK_GROUNDED


def floating_ice(cell_type):
    return cell_type == MASK_FLOATING


def ice_free(cell_type):
    return (cell_type == MASK_ICE_FREE_BEDROCK) | (cell_type == MASK_ICE_FREE_OCEAN)


@dataclass(frozen=True)
class ModelState:
    """Prognostic state of the hybrid chain. Field names are those of the
    JAX ``ModelState``; optional fields stay ``None`` until the component
    that needs them is enabled (``IceModel.prepare_state``)."""

    geometry: Geometry
    enthalpy: Optional[torch.Tensor] = None           # (My, Mx, Mz) J/kg
    bedrock_temperature: Optional[torch.Tensor] = None  # (My, Mx, Mbz) K
    basal_melt_rate: Optional[torch.Tensor] = None    # m/s ice equivalent
    u_ssa: Optional[torch.Tensor] = None              # (My, Mx) m/s
    v_ssa: Optional[torch.Tensor] = None
    tillwat: Optional[torch.Tensor] = None            # till water thickness m
    till_phi: Optional[torch.Tensor] = None           # till friction angle deg
    geothermal_flux: Optional[torch.Tensor] = None    # 2D bheatflx W/m^2
    snow_depth: Optional[torch.Tensor] = None         # PDD snow bookkeeping m
    firn_depth: Optional[torch.Tensor] = None         # PDD firn bookkeeping m
    bed_uplift: Optional[torch.Tensor] = None         # Lingle-Clark viscous bed displacement m
    bed_load_reference: Optional[torch.Tensor] = None  # ice load at the reference bed m
    bed_reference: Optional[torch.Tensor] = None      # undeformed bed + initial load

    def replace(self, **kw) -> "ModelState":
        return dataclasses.replace(self, **kw)


def map_tensors(state: ModelState, fn) -> ModelState:
    """``state`` with ``fn`` applied to every tensor field, the geometry's
    included (a cast or a move to another device)."""
    def f(x):
        return fn(x) if torch.is_tensor(x) else x
    geom = Geometry(**{k.name: f(getattr(state.geometry, k.name))
                       for k in dataclasses.fields(Geometry)})
    return ModelState(geometry=geom, **{
        k.name: f(getattr(state, k.name))
        for k in dataclasses.fields(ModelState) if k.name != "geometry"})


# ---------------------------------------------------------------------------
# The member axis
# ---------------------------------------------------------------------------

def member_sum(x: torch.Tensor, lead: int = 0) -> torch.Tensor:
    """The sum over a field's grid dims: 0-dim, or one value per member
    (shape ``x.shape[:lead]``) with ``lead`` leading member dims."""
    if lead == 0:
        return torch.sum(x)
    return torch.sum(x, dim=tuple(range(lead, x.dim())))


def member_max(x: torch.Tensor, lead: int = 0) -> torch.Tensor:
    """The max over a field's grid dims, as :func:`member_sum` sums."""
    if lead == 0:
        return torch.max(x)
    return torch.amax(x, dim=tuple(range(lead, x.dim())))


def dt_divide(x: torch.Tensor, dt) -> torch.Tensor:
    """``x / max(dt, 1e-30)``. ``dt``: a host float, or a per-member tensor
    (the field dtype, shaped to broadcast) holding such floats. Torch on
    the card divides by a host float as a product with its reciprocal, and
    on the CPU divides; a tensor ``dt`` is taken the same way, so that a
    member computes what a run of it alone computes."""
    if not torch.is_tensor(dt):
        return x / max(dt, 1e-30)
    dt = torch.clamp(dt, min=1e-30)
    return x * torch.reciprocal(dt) if x.device.type == "cuda" else x / dt


def dt_scale(c: float, dt):
    """``c * dt`` formed as a host product (float64) and then rounded to
    the field dtype where a field takes it, for a host float or a
    per-member tensor ``dt`` (see :func:`dt_divide`)."""
    if not torch.is_tensor(dt):
        return c * dt
    return (c * dt.to(torch.float64)).to(dt.dtype)


def select_members(active: torch.Tensor, new: ModelState,
                   old: ModelState) -> ModelState:
    """``new`` where the member is ``active`` (a ``(B,)`` bool tensor), else
    ``old``: every field of an ensemble's state, the geometry's included
    (the select of a ``vmap``-ed device loop that freezes finished
    members)."""
    def pick(a, b):
        if a is None or b is None:
            return a
        return torch.where(active.view(-1, *(1,) * (a.dim() - 1)), a, b)

    geom = Geometry(**{k.name: pick(getattr(new.geometry, k.name),
                                    getattr(old.geometry, k.name))
                       for k in dataclasses.fields(Geometry)})
    return ModelState(geometry=geom, **{
        k.name: pick(getattr(new, k.name), getattr(old, k.name))
        for k in dataclasses.fields(ModelState) if k.name != "geometry"})
