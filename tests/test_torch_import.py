"""pism_tpu_torch package boundary: no JAX import, one parameter database,
identical grids and config lookups, and NotImplementedError for every
configuration value the port does not implement."""

import pathlib
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
        "import pism_tpu_torch.ops.kernels.member_dot\n"
        "import pism_tpu_torch.verification.eismint2\n"
        "import pism_tpu_torch.parallel.ensemble\n"
        "import pism_tpu_torch.examples.paleo_ensemble\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'pism_tpu' or m.startswith('pism_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


_PURITY = """
import importlib, os, pkgutil, sys
root = sys.argv[1]
jax_pkg = os.path.join(root, "pism_tpu") + os.sep
opened = []

def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes)):
        opened.append(os.path.abspath(os.fsdecode(args[0])))

sys.addaudithook(hook)
import pism_tpu_torch
names = [m.name for m in pkgutil.walk_packages(pism_tpu_torch.__path__,
                                               "pism_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(p for p in opened if p.startswith(jax_pkg))
assert not bad, bad
mods = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "pism_tpu"))
assert not mods, mods
own = os.path.join(root, "pism_tpu_torch", "config")
assert any(p.startswith(own) and "parameters" in os.path.basename(p)
           for p in opened), "the hook saw no read of the port's own copy"
print(len(names), "modules")
"""


def test_port_reads_no_file_of_the_jax_package():
    """A fresh interpreter imports every module of the port under an audit
    hook on ``open``: no file under ``pism_tpu/`` is read and neither jax nor
    pism_tpu is in ``sys.modules``."""
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", _PURITY, str(root)],
                         capture_output=True, text=True, timeout=120,
                         cwd=root)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[0]) >= 30


def test_one_parameter_database():
    assert T_PARAMETERS == J_PARAMETERS
    assert len(T_PARAMETERS) > 500


def test_parameter_copy_matches_key_for_key():
    """The port's own copy (``pism_tpu_torch/config/parameters.py``):
    every name, default, unit and description equals the JAX package's."""
    from pism_tpu_torch.config import parameters

    assert pathlib.Path(parameters.__file__).parent.name == "config"
    assert "pism_tpu_torch" in pathlib.Path(parameters.__file__).parts
    assert T_PARAMETERS is not J_PARAMETERS
    assert list(T_PARAMETERS) == list(J_PARAMETERS)
    for key, value in J_PARAMETERS.items():
        assert T_PARAMETERS[key] == value, key


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
    {"stress_balance.ssa.flow_law": "hooke"},
    {"stress_balance.model": "weertman_sliding+sia"},
    {"stress_balance.ssa.fd.line_block": 64},
    {"stress_balance.ssa.fd.preconditioner": "mg"},
    {"stress_balance.ssa.fd.krylov_method": "cg"},
    {"grid.periodicity": "xy"},
    {"hydrology.model": "routing"},
    {"bed_deformation.model": "given"},
    {"calving.methods": "prescribed_retreat"},
    {"surface.pdd.method": "random_process"},
    {"stress_balance.ssa.fd.velocity_change_rtol": 0.0,
     "runtime.float_dtype": "float32"},
    {"age.enabled": True},
    {"energy.model": "none"},
])
def test_unsupported_config_raises(override):
    from pism_tpu_torch import setups

    if "grid.periodicity" in override:
        # the port's grid comes from the setup; a periodic grid raises with
        # a mesh, in the SSA and the stress balance
        grid = pt.Grid(Mx=8, My=8, Lx=1e5, Ly=1e5, periodicity="xy")
        from pism_tpu_torch.model.ssa import SSAFD
        from pism_tpu_torch.parallel import make_mesh
        from pism_tpu_torch.physics.rheology import flow_law_from_config
        cfg = pt.Config({})
        with pytest.raises(NotImplementedError):
            SSAFD(grid=grid, config=cfg, flow_law=flow_law_from_config(
                cfg, "ssa"), mesh=make_mesh(["cpu"] * 4, (2, 2)))
        return
    dtype = override.pop("runtime.float_dtype", "float64")
    with pytest.raises(NotImplementedError):
        setups.hybrid_greenland_model(dtype, km=200.0, device="cpu",
                                      extra_cfg=override)


def test_supported_config_builds():
    from pism_tpu_torch import setups

    model, state, grid = setups.hybrid_greenland_model("float32", km=200.0,
                                                       device="cpu")
    assert state.geometry.ice_thickness.dtype == torch.float32
    assert state.enthalpy.shape == grid.shape3
    assert model.skip_max == 10


def test_line_pcr_kernels_config_builds():
    """``line_pcr_impl = pallas_sublane`` (path A) builds; its
    preconditioner is the PCR kernels' route."""
    from pism_tpu_torch import setups

    model, state, grid = setups.hybrid_greenland_model(
        "float32", km=200.0, device="cpu",
        extra_cfg={"stress_balance.ssa.fd.line_pcr_impl": "pallas_sublane"})
    assert model.ssa.pcr_impl == "pallas_sublane"
    assert state.geometry.ice_thickness.dtype == torch.float32


def _entry_points():
    from pism_tpu_torch import convert, setups
    from pism_tpu_torch.model.icemodel import IceModel
    from pism_tpu_torch.verification import eismint2, mismip, runner

    return {"setups.hybrid_greenland_model": setups.hybrid_greenland_model,
            "setups.eismint2_model": setups.eismint2_model,
            "setups.halfar_model": setups.halfar_model,
            "setups.antarctica_pik_model": setups.antarctica_pik_model,
            "setups.mismip3d_model": setups.mismip3d_model,
            "setups.mismip_model": setups.mismip_model,
            "setups.paleo_ensemble_model": setups.paleo_ensemble_model,
            "setups.hybrid_ensemble_model": setups.hybrid_ensemble_model,
            "verification.mismip.setup": mismip.setup,
            "verification.mismip.setup_3d": mismip.setup_3d,
            "verification.eismint2.setup": eismint2.setup,
            "verification.runner.run_test": runner.run_test,
            "convert.state_from_numpy": convert.state_from_numpy,
            "IceModel": IceModel}


@pytest.mark.parametrize("name", list(_entry_points()))
def test_entry_points_default_to_the_card(name):
    import inspect

    fn = _entry_points()[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_default_device_does_not_fall_back_to_the_cpu():
    """Without ``device`` a setup puts its fields on the card; on a machine
    without one the call raises torch's own error instead of running on the
    CPU."""
    from pism_tpu_torch import setups

    if torch.cuda.is_available():
        _, state, _, _ = setups.halfar_model("B", Mx=11)
        assert state.geometry.ice_thickness.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            setups.halfar_model("B", Mx=11)
