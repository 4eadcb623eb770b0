"""pism_tpu_torch package boundary: no JAX import, one parameter database,
identical grids and config lookups, and NotImplementedError for every
configuration value the port does not implement."""

import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import pism_tpu_torch as pt  # noqa: E402
from pism_tpu import Config as JConfig, Grid as JGrid  # noqa: E402
from pism_tpu.config.parameters import PARAMETERS as J_PARAMETERS  # noqa: E402
from pism_tpu_torch.config import PARAMETERS as T_PARAMETERS  # noqa: E402


def test_port_imports_no_jax():
    """A fresh interpreter imports the whole port without jax or pism_tpu
    (this test process has both loaded already)."""
    code = (
        "import sys\n"
        "import pism_tpu_torch, pism_tpu_torch.setups, pism_tpu_torch.convert\n"
        "import pism_tpu_torch.model.icemodel, pism_tpu_torch.ops.kernels.ssa_matvec\n"
        "import pism_tpu_torch.ops.kernels.pcr, pism_tpu_torch.ops.kernels.sia_thermo\n"
        "import pism_tpu_torch.verification.eismint2\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'pism_tpu' or m.startswith('pism_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_one_parameter_database():
    assert T_PARAMETERS == J_PARAMETERS
    assert len(T_PARAMETERS) > 500


@pytest.mark.parametrize("kw", [
    dict(Mx=76, My=141, Lx=750e3, Ly=1400e3, Mz=41, Lz=4000.0),
    dict(Mx=16, My=29, Lx=750e3, Ly=1400e3, Mz=41, Lz=4000.0,
         vertical_spacing="equal"),
    dict(Mx=10, My=12, Lx=50e3, Ly=60e3, Mz=5, Lz=1000.0,
         registration="center", x0=3e3, y0=-2e3),
])
def test_grid_matches(kw):
    gj, gt = JGrid(**kw), pt.Grid(**kw)
    for name in ("x", "y", "z", "zb", "dz"):
        np.testing.assert_array_equal(getattr(gt, name), getattr(gj, name))
    assert (gt.dx, gt.dy, gt.shape2, gt.shape3) == \
        (gj.dx, gj.dy, gj.shape2, gj.shape3)


def test_config_lookups_match():
    over = {"stress_balance.model": "ssa+sia", "time_stepping.skip.max": 7,
            "basal_resistance.pseudo_plastic.q": 0.3}
    cj, ct = JConfig(over), pt.Config(over)
    for key, units in (("time_stepping.maximum_time_step", "seconds"),
                       ("stress_balance.ssa.fd.max_speed", "m s-1"),
                       ("surface.pdd.factor_snow", "m K-1 s-1"),
                       ("hydrology.tillwat_decay_rate", "m s-1"),
                       ("constants.ice.density", None),
                       ("basal_resistance.pseudo_plastic.q", None)):
        assert ct.get_number(key, units) == cj.get_number(key, units)
    assert ct.get_string("stress_balance.model") == "ssa+sia"
    assert ct.get_int("time_stepping.skip.max") == 7
    assert ct.is_set("time_stepping.skip.max") and not ct.is_set("grid.Mx")
    assert ct.non_default() == cj.non_default()
    with pytest.raises(KeyError):
        pt.Config({"no.such.parameter": 1})


@pytest.mark.parametrize("override", [
    {"stress_balance.ssa.fd.line_pcr_dtype": "bf16"},
    {"stress_balance.ssa.flow_law": "isothermal_glen"},
    {"stress_balance.model": "weertman_sliding+sia"},
    {"stress_balance.ssa.fd.line_block": 64},
    {"stress_balance.ssa.fd.preconditioner": "mg"},
    {"stress_balance.ssa.fd.krylov_method": "cg"},
    {"grid.periodicity": "xy"},
    {"hydrology.model": "routing"},
    {"bed_deformation.model": "lc"},
    {"calving.methods": "eigen_calving"},
    {"surface.pdd.method": "random_process"},
    {"stress_balance.ssa.fd.velocity_change_rtol": 0.0,
     "runtime.float_dtype": "float32"},
    {"age.enabled": True},
    {"energy.model": "none"},
])
def test_unsupported_config_raises(override):
    from pism_tpu_torch import setups

    if "grid.periodicity" in override:
        # the port's grid comes from the setup; a periodic grid raises in
        # every component that builds a Shifter
        grid = pt.Grid(Mx=8, My=8, Lx=1e5, Ly=1e5, periodicity="xy")
        from pism_tpu_torch.ops.stencils import Shifter
        with pytest.raises(NotImplementedError):
            Shifter(grid)
        return
    dtype = override.pop("runtime.float_dtype", "float64")
    with pytest.raises(NotImplementedError):
        setups.hybrid_greenland_model(dtype, km=200.0, extra_cfg=override)


def test_supported_config_builds():
    from pism_tpu_torch import setups

    model, state, grid = setups.hybrid_greenland_model("float32", km=200.0)
    assert state.geometry.ice_thickness.dtype == torch.float32
    assert state.enthalpy.shape == grid.shape3
    assert model.skip_max == 10


def test_line_pcr_kernels_config_builds():
    """``line_pcr_impl = pallas_sublane`` (path A) builds; its
    preconditioner is the PCR kernels' route."""
    from pism_tpu_torch import setups

    model, state, grid = setups.hybrid_greenland_model(
        "float32", km=200.0,
        extra_cfg={"stress_balance.ssa.fd.line_pcr_impl": "pallas_sublane"})
    assert model.ssa.pcr_impl == "pallas_sublane"
    assert state.geometry.ice_thickness.dtype == torch.float32
