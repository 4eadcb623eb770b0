"""MISMIP marine ice-sheet intercomparison setups (port of
``pism_tpu/verification/mismip.py``).

MISMIP experiment 1 (Pattyn et al. 2012) as PISM ships it in its example
run scripts (``examples/mismip/``): a flowline-style marine ice sheet on a
linear downward-sloping bed with Weertman sliding tau_b = C |u|^(1/3),
isothermal SSA+SIA dynamics, constant accumulation, evolving to a steady
grounding line whose flux obeys the Schoof (2007) boundary-layer relation.

MISMIP3d (Pattyn et al. 2013, BASELINE config 2; the twin of the JAX
package's ``examples/mismip3d.py`` setup): ``setup_3d`` builds the Stnd
channel [-800, 800] x [-50, 50] km on the linear bed
b = -100 - |x|/1 km, ``tau_c_perturbed`` the P75S friction patch and
``gl_x`` the sub-grid grounding line of one row.

Sliding: PISM expresses Weertman sliding through the pseudo-plastic law
with q = 1/3 and tau_c = C u_threshold^q, which reproduces
tau_b = C |u|^q exactly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import Config
from ..coupler.surface import FunctionSurface
from ..grid import Grid
from ..model.calving import CalvingModel
from ..state import ModelState, new_geometry

SEC_PER_YEAR = 3.15569259747e7

# MISMIP (Pattyn et al. 2012) experiment 1 constants
RHO_I = 900.0      # MISMIP uses 900, not PISM's 910
RHO_W = 1000.0
A_MISMIP = 4.6416e-24          # Pa^-3 s^-1 (step 1 softness)
C_SCHOOF = 7.624e6             # Pa m^-1/3 s^1/3
ACCUMULATION = 0.3 / SEC_PER_YEAR  # m/s
N_GLEN = 3.0


def bed_elevation_linear(x):
    """MISMIP experiment 1 bed: 720 m at the divide, sloping down."""
    return 720.0 - 778.5 * np.abs(np.asarray(x)) / 750.0e3


def schoof_gl_flux(H_g, A=A_MISMIP, C=C_SCHOOF, m=1.0 / 3.0,
                   rho=RHO_I, rho_w=RHO_W, g=9.81, n=N_GLEN):
    """Schoof (2007) boundary-layer grounding-line flux q(H_g) [m^2/s]."""
    theta = 1.0 - rho / rho_w
    return (A * (rho * g) ** (n + 1.0) * theta ** n / (4.0 ** n * C)) \
        ** (1.0 / (m + 1.0)) * H_g ** ((m + n + 3.0) / (m + 1.0))


@dataclass
class MISMIPSetup:
    grid: Grid
    config: Config
    state: ModelState
    surface: FunctionSurface
    calving: object = None   # CalvingModel with the ocean_kill edge mask


def initial_profile(x, H_divide: float = 2800.0, margin: float = 950.0e3):
    """Near-steady Vialov-type initial thickness (the MISMIP protocol starts
    from a semi-analytic profile, not a thin slab, whose spin-up transient
    lasts O(50 kyr))."""
    xi = np.minimum(np.abs(np.asarray(x)) / margin, 1.0)
    return H_divide * np.maximum(1.0 - xi ** (4.0 / 3.0), 0.0) ** (3.0 / 8.0)


#: experiment 1's config (``pism_tpu/verification/mismip.py:81-112``)
CONFIG = {
    "stress_balance.model": "ssa+sia",
    "stress_balance.sia.flow_law": "isothermal_glen",
    "stress_balance.ssa.flow_law": "isothermal_glen",
    "flow_law.isothermal_Glen.ice_softness": A_MISMIP,
    "constants.ice.density": RHO_I,
    "constants.sea_water.density": RHO_W,
    "basal_resistance.pseudo_plastic.enabled": True,
    "basal_resistance.pseudo_plastic.q": 1.0 / 3.0,
    "basal_resistance.pseudo_plastic.u_threshold": 100.0,  # m/a
    "basal_yield_stress.model": "constant",
    "energy.model": "none",
    "geometry.ice_free_thickness_standard": 0.01,
    # calve thin shelf ice, and kill it near the domain edge
    "calving.methods": "thickness_calving,ocean_kill",
    "calving.thickness_calving.threshold": 30.0,
    "geometry.remove_icebergs": True,
    # sub-grid front advance (Href) instead of near-zero-thickness cells
    "geometry.part_grid.enabled": True,
    "stress_balance.ssa.fd.max_speed": 150.0e3,  # m/a
    "time_stepping.maximum_time_step": 10.0,  # years
}


def setup(Mx: int = 151, My: int = 7, Lx: float = 1500.0e3,
          H_init: float = None, device="cuda") -> MISMIPSetup:
    """Half-domain flowline setup: the divide at x = 0 by the symmetry of
    the full domain [-Lx, Lx]; a narrow y extent, periodic. H_init: a
    constant slab thickness (None = the near-steady analytic profile).
    Fields are float64 on ``device``."""
    device = torch.device(device)
    wy = (My - 1) / 2.0 * (2 * Lx / (Mx - 1))
    grid = Grid(Mx=Mx, My=My, Lx=Lx, Ly=wy, periodicity="y")

    u_th = 100.0 / SEC_PER_YEAR
    config = Config(dict(CONFIG, **{
        "basal_yield_stress.constant.value": C_SCHOOF * u_th ** (1.0 / 3.0)}))

    bed = np.tile(bed_elevation_linear(grid.x)[None, :], (My, 1))
    if H_init is None:
        H0 = initial_profile(grid.x)
    else:
        H0 = np.where(np.abs(grid.x) < 700e3, H_init, 0.0)
    H0 = np.tile(H0[None, :], (My, 1))

    def t64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    state = ModelState(geometry=new_geometry(
        t64(H0), t64(bed), ice_density=RHO_I, ocean_density=RHO_W))

    def climate(geometry_, t):
        H = geometry_.ice_thickness
        return torch.full_like(H, ACCUMULATION), torch.full_like(H, 253.15)

    # a fixed calving front near the domain edge (PISM's MISMIP scripts use
    # ``-calving ocean_kill``): without it the shelf reaches the boundary
    dx = 2 * Lx / (Mx - 1)
    kill = np.abs(np.tile(grid.x[None, :], (My, 1))) > Lx - 2.5 * dx
    calving = CalvingModel(grid=grid, config=config,
                           ocean_kill_mask=torch.as_tensor(kill, device=device))
    return MISMIPSetup(grid=grid, config=config, state=state,
                       surface=FunctionSurface(climate), calving=calving)


def grounding_line_position(geometry, grid) -> float:
    """x of the last grounded cell along the centre row (x > 0 side)."""
    mask = geometry.cell_type.cpu().numpy()
    c = mask.shape[0] // 2
    x = np.asarray(grid.x)
    grounded = (mask[c] == 2) & (x >= 0)
    if not grounded.any():
        return 0.0
    return float(x[np.where(grounded)[0].max()])


# --------------------------------------------------------------------------
# MISMIP3d (Pattyn et al. 2013)
# --------------------------------------------------------------------------

# MISMIP3d constants (Pattyn et al. 2013, Table 2)
A_3D = 1.0e-25            # Pa^-3 s^-1  (3.1536e-18 Pa^-3 a^-1)
C_3D = 1.0e7              # Pa m^-1/3 s^1/3
M_EXP = 1.0 / 3.0
ACC_3D = 0.5 / SEC_PER_YEAR   # m/s
G_3D = 9.8
XC, YC, AMP = 150.0e3, 10.0e3, 0.75
TAU_C0 = C_3D * (100.0 / SEC_PER_YEAR) ** M_EXP   # C at u_threshold


def bed_3d(x):
    """b(x) = -100 - |x|/1000 m (divide at x = 0, symmetric half-domains)."""
    return -100.0 - np.abs(np.asarray(x)) / 1.0e3


def setup_3d(dx, Lx=800.0e3, Ly=50.0e3, float32=False,
             device="cuda") -> MISMIPSetup:
    """MISMIP3d's Stnd setup at spacing ``dx`` [m] (the JAX example's
    ``make_setup``): an odd My, so that one row lies on the centre line
    (1601 x 101 at 1 km), the Vialov start, the ocean-kill edge mask.
    Fields are float64 on ``device``; the uniform friction is
    ``TAU_C0``, through ``GivenYieldStress``."""
    device = torch.device(device)
    Mx = int(round(2 * Lx / dx)) + 1
    My = 2 * int(round(Ly / dx)) + 1
    grid = Grid(Mx=Mx, My=My, Lx=Lx, Ly=Ly)
    config = Config({               # examples/mismip3d.py:74-96
        "stress_balance.model": "ssa+sia",
        "stress_balance.sia.flow_law": "isothermal_glen",
        "stress_balance.ssa.flow_law": "isothermal_glen",
        "flow_law.isothermal_Glen.ice_softness": A_3D,
        "constants.ice.density": RHO_I,
        "constants.sea_water.density": RHO_W,
        "constants.standard_gravity": G_3D,
        "basal_resistance.pseudo_plastic.enabled": True,
        "basal_resistance.pseudo_plastic.q": M_EXP,
        "basal_resistance.pseudo_plastic.u_threshold": 100.0,  # m/a
        "basal_yield_stress.model": "given",
        "energy.model": "none",
        "geometry.ice_free_thickness_standard": 0.01,
        "geometry.part_grid.enabled": True,
        "geometry.grounded_cell_fraction": True,
        "geometry.remove_icebergs": True,
        "calving.methods": "thickness_calving,ocean_kill",
        "calving.thickness_calving.threshold": 30.0,
        "stress_balance.ssa.fd.max_speed": 150.0e3,
        "time_stepping.maximum_time_step": 10.0,
        "runtime.float_dtype": "float32" if float32 else "float64",
    })

    def t64(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    bed = np.tile(bed_3d(grid.x)[None, :], (My, 1))
    # start near the Schoof semi-analytic steady state (grounding line
    # ~606 km for these parameters)
    H0 = np.tile(initial_profile(grid.x, H_divide=2000.0,
                                 margin=620.0e3)[None, :], (My, 1))
    state = ModelState(geometry=new_geometry(
        t64(H0), t64(bed), ice_density=RHO_I, ocean_density=RHO_W))

    def climate(geometry_, t):
        H = geometry_.ice_thickness
        return torch.full_like(H, ACC_3D), torch.full_like(H, 253.15)

    kill = np.abs(np.tile(grid.x[None, :], (My, 1))) > Lx - 2.5 * dx
    calving = CalvingModel(grid=grid, config=config,
                           ocean_kill_mask=torch.as_tensor(kill, device=device))
    return MISMIPSetup(grid=grid, config=config, state=state,
                       surface=FunctionSurface(climate), calving=calving)


def tau_c_perturbed(grid, tau_c0, x_b):
    """P75S friction: C* = C (1 - 0.75 exp(-(x-x_b)^2/2xc^2 - y^2/2yc^2)),
    on both symmetric half-domains."""
    y, x = np.meshgrid(grid.y, grid.x, indexing="ij")
    a = AMP * (np.exp(-((x - x_b) ** 2) / (2 * XC ** 2)
                      - y ** 2 / (2 * YC ** 2))
               + np.exp(-((x + x_b) ** 2) / (2 * XC ** 2)
                        - y ** 2 / (2 * YC ** 2)))
    return tau_c0 * (1.0 - np.minimum(a, AMP))


def gl_x(state, grid, row):
    """Sub-grid grounding-line x on row ``row`` (x > 0 side): the last
    grounded cell, extended by the grounded fraction of the next."""
    mask = state.geometry.cell_type[row].cpu().numpy()
    frac = state.geometry.cell_grounded_fraction[row].double().cpu().numpy()
    x = np.asarray(grid.x)
    sel = (mask == 2) & (x >= 0)
    if not sel.any():
        return 0.0
    i = np.where(sel)[0].max()
    f = frac[i + 1] if i + 1 < x.size else 0.0
    return float(x[i] + f * grid.dx)
