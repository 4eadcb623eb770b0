"""EISMINT II simplified-geometry experiments (port of
``pism_tpu/verification/eismint2.py``; Payne et al. 2000, J. Glaciol.
46(153)): radially symmetric SMB and surface temperature on a 1500x1500 km
flat-bed domain, thermomechanically coupled SIA.

Experiment parameters (Payne et al. 2000, Table 2):
  A: M_max=0.5 m/a, R_el=450 km, T_min=238.15 K  (from zero ice)
  B: as A but T_min=243.15 K                      (restart from A)
  C: as A but M_max=0.25 m/a, R_el=425 km         (restart from A)
  D: as A but R_el=425 km                         (restart from A)
  F: as A but T_min=223.15 K                      (from zero ice)
E and G-L (sliding, non-flat beds) raise NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass

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
    "F": dict(T_min=223.15),
}


@dataclass
class EISMINT2Setup:
    grid: Grid
    config: Config
    state: ModelState
    surface: FunctionSurface
    geothermal: float = GEOTHERMAL
    sliding_mu: object = None    # experiment E's sliding map (not ported)


def setup(experiment: str = "A", Mx: int = 61, Mz: int = 61,
          Lz: float = 5000.0, dtype=torch.float64,
          device="cuda") -> EISMINT2Setup:
    """Grid, config, initial state (zero ice) and climate of one
    experiment, every field in ``dtype`` on ``device``."""
    name = experiment.upper()
    if name not in EXPERIMENTS:
        raise NotImplementedError(
            f"EISMINT II experiment {name} (sliding or a non-flat bed) is "
            "not implemented in pism_tpu_torch (supported: "
            f"{', '.join(EXPERIMENTS)})")
    params = EXPERIMENTS[name]
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

    d = torch.as_tensor(grid.radius, dtype=torch.float64, device=device)

    def climate(geometry, t):
        dt_ = geometry.ice_thickness.dtype
        dd = d.to(dt_)
        smb = torch.minimum(torch.tensor(M_max, dtype=dt_, device=device),
                            S_B * (R_el - dd))
        return smb, T_min + S_T * dd

    zeros = torch.zeros(grid.shape2, dtype=torch.float64, device=device)
    geometry = new_geometry(zeros, zeros.clone())
    EC = EnthalpyConverter.from_config(config)
    E0 = bootstrap_enthalpy(grid, EC, zeros, T_min + S_T * d,
                            geothermal=GEOTHERMAL)
    state = ModelState(geometry=geometry, enthalpy=E0,
                       basal_melt_rate=zeros.clone())
    if dtype != torch.float64:
        from ..setups import to_dtype
        state = to_dtype(state, dtype)
    return EISMINT2Setup(grid=grid, config=config, state=state,
                         surface=FunctionSurface(climate))


#: Published steady-state benchmarks for experiment A (Payne et al. 2000,
#: mean of participating models) used as sanity targets, not exact parity:
EXPECTED_A = {
    "volume_km3": 2.128e6,
    "area_km2": 1.034e6,
    "divide_thickness_m": 3688.3,
    "divide_basal_temp_K": 255.605,
}
