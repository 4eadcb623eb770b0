"""MISMIP3d (BASELINE config 2) and MISMIP experiment 1 in the port
against the JAX package on the CPU, float64.

- ``ConstantYieldStress`` and ``GivenYieldStress`` (an array, and ``tauc``
  from a classic NetCDF file with a NaN in it), the SSA hardness without an
  enthalpy field, ``schoof_gl_flux``, ``grounding_line_position`` and
  ``gl_x`` against their JAX twins.
- MISMIP3d at 50 km (33 x 3, ``setups.mismip3d_model`` against the JAX
  ``examples/mismip3d.py``'s ``make_setup`` with ``GivenYieldStress``) and
  MISMIP experiment 1 at 51 x 5 on its periodic-y grid
  (``setups.mismip_model`` against ``verification/mismip.py``'s
  ``setup``): equal initial states, one ``step_once`` step, and a few
  steps held by steps, dt-limit hits and volume (2e-4). The SSA solves of
  both setups stop on the velocity-change test, not on the residual
  tolerance (|F|^2 ~ 1e6-1e9 x the tolerance), so one step is held at the
  amplification envelope: H within 1e-10 of max H, the velocities within
  1e-9 of max |u| (measured: H 1.5e-11, u and v 2.8e-10 at 50 km; 8e-20
  and 6e-17 on the periodic grid). Over a few steps the periodic solves
  part (max |u| 1.8e-3 apart after 20 a) while H, the mask and the volume
  stay close.
- Both setups, with no enthalpy field, through ``IceModel.run`` with every
  registered spatial diagnostic and scalar series written, then restarted
  through a NetCDF file: the continuation equal to the bit.
- A mesh with a periodic grid raises NotImplementedError; the example's
  command line runs at 50 km and prints the JAX example's JSON keys.
"""

import dataclasses
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pism_tpu import Grid as JGrid
from pism_tpu import state as JS
from pism_tpu.model.icemodel import IceModel as JIceModel
from pism_tpu.model.ssa import SSAFD as JSSAFD
from pism_tpu.physics import basal as j_basal
from pism_tpu.physics.rheology import flow_law_from_config as j_law
from pism_tpu.verification import mismip as j_mismip
from pism_tpu_torch import Config, Grid, Time, setups
from pism_tpu_torch.convert import state_to_numpy
from pism_tpu_torch.examples import mismip3d as t_m3
from pism_tpu_torch.io import checkpoint as ckpt
from pism_tpu_torch.io.nc4 import File
from pism_tpu_torch.model import diagnostics as t_diag
from pism_tpu_torch.model.output import OutputManager
from pism_tpu_torch.model.ssa import SSAFD
from pism_tpu_torch.physics import basal as t_basal
from pism_tpu_torch.physics.rheology import flow_law_from_config as t_law
from pism_tpu_torch.state import ModelState, new_geometry
from pism_tpu_torch.verification import mismip as t_mismip

torch.set_num_threads(2)

SPY = 3.15569259747e7
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_example():
    """The JAX package's ``examples/mismip3d.py`` as a module; its import
    points JAX's compilation cache at the repository, which is undone."""
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    old = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "jax_mismip3d_example", ROOT / "examples" / "mismip3d.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        for k, v in old.items():
            jax.config.update(k, v)
    return mod


J_M3 = _jax_example()


def _jax_numpy(st):
    d = {f.name: np.asarray(getattr(st.geometry, f.name))
         for f in dataclasses.fields(st.geometry)}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if f.name != "geometry" and v is not None:
            d[f.name] = np.asarray(v)
    return d


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# -- the leaves ------------------------------------------------------------

def _marine_state(pkg, grid):
    """A geometry with grounded ice, floating ice and open ocean."""
    x = np.tile(np.asarray(grid.x)[None, :], (grid.My, 1))
    H = np.where(np.abs(x) < 0.6 * grid.Lx, 1000.0 - 1e-3 * np.abs(x), 0.0)
    bed = -100.0 - 2e-3 * np.abs(x)
    if pkg == "jax":
        return JS.ModelState(geometry=JS.new_geometry(
            jnp.asarray(H), jnp.asarray(bed), ice_density=900.0,
            ocean_density=1000.0))
    return ModelState(geometry=new_geometry(
        torch.tensor(H), torch.tensor(bed), ice_density=900.0,
        ocean_density=1000.0))


def _tauc_file(path, grid, tauc):
    from scipy.io import netcdf_file
    with netcdf_file(str(path), "w") as f:
        f.createDimension("x", grid.Mx)
        f.createDimension("y", grid.My)
        f.createVariable("x", "d", ("x",))[:] = grid.x
        f.createVariable("y", "d", ("y",))[:] = grid.y
        f.createVariable("tauc", "d", ("y", "x"))[:] = tauc


def test_yield_stresses_match_jax(tmp_path):
    kw = dict(Mx=21, My=5, Lx=400e3, Ly=80e3)
    jg, tg = JGrid(**kw), Grid(**kw)
    js, ts = _marine_state("jax", jg), _marine_state("torch", tg)
    ocean = np.asarray(JS.ocean(js.geometry.cell_type))
    assert ocean.any() and (~ocean).any()
    tauc = np.random.default_rng(0).uniform(1e4, 2e5, size=tg.shape2)
    tauc[2, 3] = np.nan                       # the file route's nan_to_num
    path = tmp_path / "tauc.nc"
    _tauc_file(path, tg, tauc)
    over = {"basal_yield_stress.constant.value": 7.5e4,
            "basal_yield_stress.given.file": str(path)}
    from pism_tpu import Config as JConfig
    jc, tc = JConfig(over), Config(over)
    cases = [
        (j_basal.ConstantYieldStress(jc), t_basal.ConstantYieldStress(tc)),
        (j_basal.GivenYieldStress(jc, tau_c=np.nan_to_num(tauc)),
         t_basal.GivenYieldStress(tc, tau_c=np.nan_to_num(tauc))),
        (j_basal.GivenYieldStress(jc, grid=jg),
         t_basal.GivenYieldStress(tc, grid=tg))]
    for name in ("constant", "given", "mohr_coulomb"):
        jc.update({"basal_yield_stress.model": name})
        tc.update({"basal_yield_stress.model": name})
        cases.append((j_basal.yield_stress_from_config(jc, jg),
                      t_basal.yield_stress_from_config(tc, tg)))
        assert type(cases[-1][1]).__name__ == type(cases[-1][0]).__name__
    for jy, ty in cases:
        want = np.asarray(jy.compute(js))
        got = ty.compute(ts)
        assert got.dtype == torch.float64
        np.testing.assert_array_equal(got.numpy(), want)
        assert np.all(got.numpy()[ocean] == 0.0)
    # float32 fields get tau_c rounded to float32
    s32 = ts.replace(geometry=dataclasses.replace(
        ts.geometry, ice_thickness=ts.geometry.ice_thickness.float()))
    assert cases[2][1].compute(s32).dtype == torch.float32
    with pytest.raises(ValueError):
        t_basal.GivenYieldStress(Config({}))
    tc.update({"basal_yield_stress.model": "tillphi"})
    with pytest.raises(NotImplementedError):
        t_basal.yield_stress_from_config(tc, tg)


def test_ssa_hardness_without_enthalpy():
    """``energy.model = none``: B = the law's hardness at zero enthalpy and
    pressure, scaled by the SSA enhancement factor, as in JAX."""
    kw = dict(Mx=9, My=5, Lx=100e3, Ly=50e3)
    over = {"stress_balance.ssa.flow_law": "isothermal_glen",
            "flow_law.isothermal_Glen.ice_softness": 1e-25,
            "stress_balance.ssa.enhancement_factor": 0.7}
    from pism_tpu import Config as JConfig
    jc, tc = JConfig(over), Config(over)
    jssa = JSSAFD(grid=JGrid(**kw), config=jc, flow_law=j_law(jc, "ssa"))
    tssa = SSAFD(grid=Grid(**kw), config=tc, flow_law=t_law(tc, "ssa"))
    js, ts = _marine_state("jax", JGrid(**kw)), _marine_state("torch", Grid(**kw))
    want = np.asarray(jssa._hardness(js))
    got = tssa._hardness(ts)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.flat[0] == pytest.approx(1e-25 ** (-1 / 3) * 0.7 ** (-1 / 3))


def test_schoof_flux_and_grounding_lines():
    for H in (500.0, 800.0, 1200.0):
        assert t_mismip.schoof_gl_flux(H) == j_mismip.schoof_gl_flux(H)
    kw = dict(Mx=31, My=5, Lx=600e3, Ly=40e3)
    jg, tg = JGrid(**kw), Grid(**kw)
    js, ts = _marine_state("jax", jg), _marine_state("torch", tg)
    js = js.replace(geometry=JS.ensure_consistency(js.geometry, 900.0, 1000.0,
                                                   0.01, True))
    from pism_tpu_torch import state as TS
    ts = ts.replace(geometry=TS.ensure_consistency(ts.geometry, 900.0, 1000.0,
                                                   0.01, True))
    x = t_mismip.grounding_line_position(ts.geometry, tg)
    assert x == j_mismip.grounding_line_position(js.geometry, jg) and x > 0
    for row in (0, 2):
        want = J_M3.gl_x(js, jg, row)
        assert t_mismip.gl_x(ts, tg, row) == want and want > x
    np.testing.assert_array_equal(
        t_mismip.tau_c_perturbed(tg, t_mismip.TAU_C0, 150e3),
        J_M3.tau_c_perturbed(jg, J_M3.C_3D * (100.0 / SPY) ** J_M3.M_EXP,
                             150e3))


# -- the chains ------------------------------------------------------------

def _chains(which):
    """(JAX model, JAX initial state, port model, port initial state)."""
    if which == "mismip3d":
        grid, cfg, st, surf, calv, tc0 = J_M3.make_setup(50e3)
        cfg.update({"runtime.device_loop": False})
        jm = JIceModel(grid=grid, config=cfg, surface=surf, calving=calv,
                       yield_stress=j_basal.GivenYieldStress(
                           cfg, tau_c=np.full(grid.shape2, tc0)))
        tm, ts, _ = setups.mismip3d_model("float64", km=50.0, device="cpu")
    else:
        ms = j_mismip.setup(Mx=51, My=5)
        ms.config.update({"runtime.device_loop": False})
        jm = JIceModel(grid=ms.grid, config=ms.config, surface=ms.surface,
                       calving=ms.calving)
        st = ms.state
        tm, ts, _ = setups.mismip_model("float64", 51, 5, device="cpu")
    return jm, jm.prepare_state(st), tm, ts


#: (one step's cap, the few steps' span) in years
SPANS = {"mismip3d": (0.2, 30.0), "mismip1": (0.5, 20.0)}


@pytest.fixture(scope="module", params=sorted(SPANS))
def chain(request):
    which = request.param
    jm, js, tm, ts = _chains(which)
    out = {"which": which, "init": (_jax_numpy(js), state_to_numpy(ts)),
           "periodic": tm.grid.periodicity}
    for key, years in zip(("one", "few"), SPANS[which]):
        j1, jt, jst = jm.step_once(js, 0.0, years * SPY)
        t1, tt, tst = tm.step_once(ts, 0.0, years * SPY)
        out[key] = ((_jax_numpy(j1), float(jt), jst),
                    (state_to_numpy(t1), tt, tst))
    return out


def test_initial_states_equal(chain):
    jd, td = chain["init"]
    assert set(jd) == set(td)
    for k in jd:
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
    assert chain["periodic"] == ("none" if chain["which"] == "mismip3d"
                                 else "y")


def _hits(jst):
    return {k: int(v) for k, v in jst.limit_hits_dict().items()}


def test_one_step_matches_jax(chain):
    (jd, jt, jst), (td, tt, tst) = chain["one"]
    assert tst.nsteps == int(jst.nsteps) == 1 and tt == pytest.approx(jt)
    assert tst.limit_hits_dict() == _hits(jst)
    np.testing.assert_array_equal(td["cell_type"], jd["cell_type"])
    assert _rel(td["ice_thickness"], jd["ice_thickness"]) <= 1e-10
    assert _rel(td["cell_grounded_fraction"],
                jd["cell_grounded_fraction"]) <= 1e-10
    speed = np.abs(jd["u_ssa"]).max()
    for k in ("u_ssa", "v_ssa"):
        assert np.abs(td[k] - jd[k]).max() <= 1e-9 * speed, k
    assert np.all(np.isfinite(td["u_ssa"])) and speed > 0


def test_few_steps_match_jax(chain):
    (jd, jt, jst), (td, tt, tst) = chain["few"]
    assert tst.nsteps == int(jst.nsteps) >= 3 and tt == pytest.approx(jt)
    assert tst.limit_hits_dict() == _hits(jst)
    V = jd["ice_thickness"].sum()
    assert abs(td["ice_thickness"].sum() - V) <= 2e-4 * V
    assert tst.ssa_newton_iters > 0 and tst.ssa_krylov_iters > 0


def _port_chain(which):
    if which == "mismip3d":
        return setups.mismip3d_model("float64", km=50.0, device="cpu")
    return setups.mismip_model("float64", 51, 5, device="cpu")


@pytest.mark.parametrize("which", sorted(SPANS))
def test_run_with_every_diagnostic_then_restart(tmp_path, which):
    """The ``ssa+sia`` route without an enthalpy field through
    ``IceModel.run`` with an ``OutputManager`` that writes every registered
    spatial diagnostic and spatial rate and every scalar series and rate at
    two times: every record finite, of the grid's shape. The state at the
    run's end, saved to a classic NetCDF file and read back (the ``-i``
    path, ``io/checkpoint``), continues equal to the bit to the run
    continued in memory."""
    model, state, grid = _port_chain(which)
    assert state.enthalpy is None
    half = SPANS[which][1] / 2 * SPY
    om = OutputManager(
        grid=grid, config=model.config, ts_times=[half / 2, half],
        ts_vars=tuple(t_diag.SCALAR) + tuple(t_diag.RATE),
        ts_file=str(tmp_path / "ts.nc"), extra_times=[half / 2, half],
        extra_vars=tuple(t_diag.SPATIAL) + tuple(t_diag.SPATIAL_RATE),
        extra_file=str(tmp_path / "ex.nc"), format="netcdf3")
    sB, stB = model.run(state, Time(0.0, half), output=om)
    om.close()
    assert stB.nsteps >= 2
    for name, vars_, shape in (
            ("ex.nc", tuple(t_diag.SPATIAL) + tuple(t_diag.SPATIAL_RATE),
             (2, grid.My, grid.Mx)),
            ("ts.nc", tuple(t_diag.SCALAR) + tuple(t_diag.RATE), (2,))):
        with File(str(tmp_path / name), "r") as f:
            assert f.read("time").tolist() == [half / 2, half]
            for v in vars_:
                x = f.read(v)
                assert x.shape == shape and np.all(np.isfinite(x)), (name, v)
    with File(str(tmp_path / "ex.nc"), "r") as f:
        assert np.abs(f.read("velbar_mag")).max() > 0
        assert np.all(f.read("tauc")[-1] >= 0) and f.read("tauc").max() > 0

    path = str(tmp_path / "restart.nc")
    ckpt.save_state(path, sB, grid, half, config=model.config,
                    format="netcdf3")
    sB2, t2 = ckpt.load_state(path, config=model.config, device="cpu")
    assert t2 == half and sB2.enthalpy is None
    sA, stA = model.run(sB, Time(half, 2 * half))
    sA2, stA2 = model.run(sB2, Time(t2, 2 * half))
    assert stA2.nsteps == stA.nsteps >= 2
    a, b = state_to_numpy(sA), state_to_numpy(sA2)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_mesh_with_periodic_grid_raises():
    from pism_tpu_torch.parallel import make_mesh
    mesh = make_mesh(["cpu"] * 4, (2, 2))
    grid = Grid(Mx=12, My=8, Lx=100e3, Ly=60e3, periodicity="y")
    cfg = Config({"stress_balance.ssa.flow_law": "isothermal_glen"})
    with pytest.raises(NotImplementedError):
        SSAFD(grid=grid, config=cfg, flow_law=t_law(cfg, "ssa"), mesh=mesh)
    from pism_tpu_torch.model.stressbalance import StressBalance
    with pytest.raises(NotImplementedError):
        StressBalance(grid=grid, config=Config({}), sia_flow_law=None,
                      mesh=mesh)


def test_example_command_line(capsys):
    """``python -m pism_tpu_torch.examples.mismip3d --device cpu --dx-km
    50`` runs Stnd, P75S and P75R through ``IceModel.run`` and prints the
    JAX example's JSON keys."""
    assert t_m3.main(["--device", "cpu", "--dx-km", "50", "--stnd-years",
                      "20", "--perturb-years", "10",
                      "--recovery-years", "10"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"dx_km", "gl_stnd_km", "gl_p75s_center_km",
                        "gl_p75s_edge_km", "gl_p75r_km",
                        "reversibility_residual_km"}
    assert 400.0 < out["gl_stnd_km"] < 800.0
