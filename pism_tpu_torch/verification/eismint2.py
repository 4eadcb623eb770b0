"""EISMINT II simplified-geometry experiments (port of
``pism_tpu/verification/eismint2.py``; Payne et al. 2000, J. Glaciol.
46(153)): radially symmetric SMB and surface temperature on a 1500x1500 km
domain, thermomechanically coupled SIA.

Experiment parameters (Payne et al. 2000, Table 2):
  A: M_max=0.5 m/a, R_el=450 km, T_min=238.15 K  (from zero ice)
  B: as A but T_min=243.15 K                      (restart from A)
  C: as A but M_max=0.25 m/a, R_el=425 km         (restart from A)
  D: as A but R_el=425 km                         (restart from A)
  E: as A with sliding in an annular sector       (restart from A)
  F: as A but T_min=223.15 K                      (from zero ice)
  G: as A with linear basal sliding                (from zero ice)
  H: as G, sliding only where the base is temperate
  I-L: A on the "trough" (I, J) and "mound" (K, L) beds; J and L slide
       as G does
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..config import Config
from ..coupler.surface import FunctionSurface
from ..grid import Grid
from ..model.energy import bootstrap_enthalpy
from ..physics.enthalpy_converter import EnthalpyConverter
from ..state import ModelState, new_geometry

SEC_PER_YEAR = 3.15569259747e7

#: shared constants (Payne et al. 2000 Table 1)
T_MIN_DEFAULT = 238.15      # K
S_T = 1.67e-2 / 1e3         # K/m
M_MAX_DEFAULT = 0.5 / SEC_PER_YEAR   # m/s
S_B = 1.0e-2 / 1e3 / SEC_PER_YEAR    # 1/s  (m/a per km -> 1/s)
R_EL_DEFAULT = 450.0e3      # m
GEOTHERMAL = 0.042          # W/m^2

EXPERIMENTS = {
    "A": dict(),
    "B": dict(T_min=243.15),
    "C": dict(M_max=0.25 / SEC_PER_YEAR, R_el=425.0e3),
    "D": dict(R_el=425.0e3),
    # E: A plus sliding u_b = -mu tau_d with the per-cell coefficient of
    # ``sliding_mu_map_E`` (an annular sector about the summit)
    "E": dict(sliding_sector=True),
    "F": dict(T_min=223.15),
    "G": dict(sliding=True),
    "H": dict(sliding=True, melt_only=True),
    "I": dict(bed="trough"),
    "J": dict(bed="trough", sliding=True),
    "K": dict(bed="mound"),
    "L": dict(bed="mound", sliding=True),
}


def trough_topography(grid):
    """EISMINT II "trough" bed: a 1000 m plateau with a channel (width
    w = 200 km, centered on y = 0) descending linearly eastward from the
    domain center to sea level at the east edge."""
    X, Y = np.meshgrid(grid.x, grid.y)
    b0, w = 1000.0, 200.0e3
    slope = b0 / grid.Lx
    in_channel = (X >= 0.0) & (np.abs(Y) <= w / 2.0)
    depression = slope * X * np.cos(np.pi * Y / w)
    return np.where(in_channel, b0 - np.maximum(depression, 0.0), b0)


def mound_topography(grid):
    """EISMINT II "mound" bed: |a sin(pi x / w) + a cos(pi y / w)|,
    a = 250 m, w = 150 km, x and y measured from the domain's corner."""
    X, Y = np.meshgrid(grid.x, grid.y)
    a, w = 250.0, 150.0e3
    ewd, nsd = X + grid.Lx, Y + grid.Ly
    return np.abs(a * np.sin(np.pi * ewd / w) + a * np.cos(np.pi * nsd / w))


#: EISMINT II linear sliding coefficient (Payne et al. 2000 eq. 4):
#: u_b = -B tau_b with B = 1e-3 m a^-1 Pa^-1.
SLIDING_B = 1.0e-3 / SEC_PER_YEAR  # m s^-1 Pa^-1

#: experiment E sliding-patch peak coefficient [m s^-1 Pa^-1]
MU_MAX_E = 2.5e-11


def sliding_mu_map_E(grid):
    """Experiment E's sliding coefficient: an annular sector about the
    summit, 200 km < r < 700 km and 10 deg < theta < 40 deg (theta from
    the +x axis), with mu = MU_MAX_E times quadratic bumps in r and theta
    (zero on the sector's edges, peak at its center)."""
    X, Y = np.meshgrid(grid.x, grid.y)
    r = np.sqrt(X ** 2 + Y ** 2)
    theta = np.arctan2(Y, X)
    r1, r2 = 200.0e3, 700.0e3
    t1, t2 = np.deg2rad(10.0), np.deg2rad(40.0)
    inside = (r > r1) & (r < r2) & (theta > t1) & (theta < t2)
    mu = MU_MAX_E * (4.0 * (r - r1) * (r2 - r) / (r2 - r1) ** 2) \
                  * (4.0 * (theta - t1) * (t2 - theta) / (t2 - t1) ** 2)
    return np.where(inside, mu, 0.0)


@dataclass
class EISMINT2Setup:
    grid: Grid
    config: Config
    state: ModelState
    surface: FunctionSurface
    geothermal: float = GEOTHERMAL
    sliding_mu: object = None    # experiment E's per-cell sliding coefficient


def setup(experiment: str = "A", Mx: int = 61, Mz: int = 61,
          Lz: float = 5000.0, dtype=torch.float64,
          device="cuda") -> EISMINT2Setup:
    """Grid, config, initial state (zero ice) and climate of one
    experiment, every field in ``dtype`` on ``device``; E's sliding map as
    a float64 tensor on ``device``."""
    params = EXPERIMENTS[experiment.upper()]
    T_min = params.get("T_min", T_MIN_DEFAULT)
    M_max = params.get("M_max", M_MAX_DEFAULT)
    R_el = params.get("R_el", R_EL_DEFAULT)
    device = torch.device(device)

    grid = Grid(Mx=Mx, My=Mx, Lx=750.0e3, Ly=750.0e3, Mz=Mz, Lz=Lz,
                vertical_spacing="quadratic", lam=4.0)
    config = Config({
        "stress_balance.model": "sia",
        "stress_balance.sia.flow_law": "pb",   # EISMINT II two-branch Arrhenius
        "stress_balance.sia.surface_gradient_method": "mahaffy",
        "energy.model": "enthalpy",
        "grid.Mx": Mx, "grid.My": Mx, "grid.Mz": Mz,
        "grid.Lx": 750.0e3, "grid.Ly": 750.0e3, "grid.Lz": Lz,
        "bootstrapping.defaults.geothermal_flux": GEOTHERMAL,
    })
    if params.get("sliding"):
        # G, H, J, L: linear hard-bed sliding u_b = -B tau_b
        config.update({
            "stress_balance.model": "weertman_sliding+sia",
            "stress_balance.weertman_sliding.k": SLIDING_B,
            "stress_balance.weertman_sliding.exponent": 1.0,
            "stress_balance.weertman_sliding.melt_only":
                bool(params.get("melt_only", False)),
        })
    sliding_mu = None
    if params.get("sliding_sector"):
        config.update({
            "stress_balance.model": "weertman_sliding+sia",
            "stress_balance.weertman_sliding.exponent": 1.0,
        })
        sliding_mu = torch.as_tensor(sliding_mu_map_E(grid),
                                     dtype=torch.float64, device=device)

    d = torch.as_tensor(grid.radius, dtype=torch.float64, device=device)

    def climate(geometry, t):
        dt_ = geometry.ice_thickness.dtype
        dd = d.to(dt_)
        smb = torch.minimum(torch.tensor(M_max, dtype=dt_, device=device),
                            S_B * (R_el - dd))
        return smb, T_min + S_T * dd

    zeros = torch.zeros(grid.shape2, dtype=torch.float64, device=device)
    bed = {"trough": trough_topography, "mound": mound_topography}.get(
        params.get("bed"))
    geometry = new_geometry(zeros, zeros.clone() if bed is None else
                            torch.as_tensor(bed(grid), dtype=torch.float64,
                                            device=device))
    EC = EnthalpyConverter.from_config(config)
    E0 = bootstrap_enthalpy(grid, EC, zeros, T_min + S_T * d,
                            geothermal=GEOTHERMAL)
    state = ModelState(geometry=geometry, enthalpy=E0,
                       basal_melt_rate=zeros.clone())
    if dtype != torch.float64:
        from ..setups import to_dtype
        state = to_dtype(state, dtype)
    return EISMINT2Setup(grid=grid, config=config, state=state,
                         surface=FunctionSurface(climate),
                         sliding_mu=sliding_mu)


#: Published steady-state benchmarks for experiment A (Payne et al. 2000,
#: mean of participating models) used as sanity targets, not exact parity:
EXPECTED_A = {
    "volume_km3": 2.128e6,
    "area_km2": 1.034e6,
    "divide_thickness_m": 3688.3,
    "divide_basal_temp_K": 255.605,
}
