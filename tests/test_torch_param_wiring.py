"""Parameter wiring of the MISMIP modules (the isothermal SSA+SIA with no
energy model, the constant and given yield stresses, periodic grids):
every key the JAX twins read on this path is read by the port on the same
path, or the port raises NotImplementedError when it (or the key that
gates its use) is set off its default, as
``tests/test_torch_coupler_factory.py::test_parameter_wiring`` holds the
bootstrap, coupler and PIK modules."""

import numpy as np
import pytest

from pism_tpu import Config as JConfig
from pism_tpu_torch import Config

#: the keys MISMIP3d and MISMIP experiment 1 set or rely on
MISMIP_KEYS = {"basal_yield_stress.constant.value",
               "basal_yield_stress.given.file",
               "flow_law.isothermal_Glen.ice_softness",
               "stress_balance.ssa.flow_law", "grid.periodicity",
               "geometry.grounded_cell_fraction"}
#: read by the JAX flow-law factory before it picks the law; the isothermal
#: law uses none of them
UNUSED = {"constants.ideal_gas_constant", "flow_law.Paterson_Budd.A_cold",
          "flow_law.Paterson_Budd.A_warm", "flow_law.Paterson_Budd.Q_cold",
          "flow_law.Paterson_Budd.Q_warm",
          "flow_law.Paterson_Budd.T_critical",
          # the JAX SSA reads it for regional mode's no_model_mask, which
          # the port's SSA does not take (ROADMAP Queue 1 item 7)
          "regional.zero_gradient"}
#: keys whose use another setting gates, with that setting: the port refuses
#: the setting
GATED = {
    "fracture_density.softening_lower_limit": {"fracture_density.enabled":
                                               True},
    "stress_balance.ssa.fd.lateral_drag.viscosity": {
        "stress_balance.ssa.fd.lateral_drag.enabled": True},
    "stress_balance.ssa.fd.mixed_production_rtol": {
        "stress_balance.ssa.fd.solve_dtype": "mixed",
        "runtime.float_dtype": "float32"},
}
BASE = {"stress_balance.model": "ssa+sia", "energy.model": "none",
        "stress_balance.sia.flow_law": "isothermal_glen",
        "stress_balance.ssa.flow_law": "isothermal_glen",
        "grid.periodicity": "y", "grid.Mx": 9, "grid.My": 5,
        "geometry.grounded_cell_fraction": True}


def _tauc_file(path):
    from scipy.io import netcdf_file
    from pism_tpu_torch import Grid
    g = Grid.from_config(Config(BASE))
    with netcdf_file(str(path), "w") as f:
        f.createDimension("x", g.Mx)
        f.createDimension("y", g.My)
        f.createVariable("x", "d", ("x",))[:] = g.x
        f.createVariable("y", "d", ("y",))[:] = g.y
        f.createVariable("tauc", "d", ("y", "x"))[:] = np.full(g.shape2, 1e5)


def _run(pkg, cfg):
    """The path's modules: the grid from the config, each yield stress of
    the factory, the flow laws, the SSA, and (port) the model that builds
    them, whose refusals gate the keys above."""
    if pkg == "jax":
        from pism_tpu.grid import Grid
        from pism_tpu.model.ssa import SSAFD
        from pism_tpu.physics import basal, rheology
    else:
        from pism_tpu_torch.coupler.surface import Uniform
        from pism_tpu_torch.grid import Grid
        from pism_tpu_torch.model.icemodel import IceModel
        from pism_tpu_torch.model.ssa import SSAFD
        from pism_tpu_torch.physics import basal, rheology
    grid = Grid.from_config(cfg)
    for name in ("constant", "given"):
        cfg.update({"basal_yield_stress.model": name})
        basal.yield_stress_from_config(cfg, grid)
        if pkg != "jax":
            IceModel(grid=grid, config=cfg, surface=Uniform(), device="cpu")
    rheology.flow_law_from_config(cfg, "sia")
    SSAFD(grid=grid, config=cfg, flow_law=rheology.flow_law_from_config(
        cfg, "ssa"))


def _reads(pkg, over):
    cfg = (JConfig if pkg == "jax" else Config)(dict(BASE, **over))
    _run(pkg, cfg)
    return set(cfg.used_parameters())


def test_mismip_parameter_wiring(tmp_path):
    path = tmp_path / "tauc.nc"
    _tauc_file(path)
    over = {"basal_yield_stress.given.file": str(path)}
    jax_reads, port_reads = _reads("jax", over), _reads("torch", over)
    assert MISMIP_KEYS <= jax_reads and MISMIP_KEYS <= port_reads
    missing = jax_reads - port_reads - UNUSED
    assert missing == set(GATED)
    for key in sorted(missing):
        with pytest.raises(NotImplementedError):
            _reads("torch", dict(over, **GATED[key]))
    # a flow law the port lacks is refused on this path
    with pytest.raises(NotImplementedError):
        _reads("torch", dict(over, **{"stress_balance.ssa.flow_law": "hooke"}))
