"""The new physics on whole chains, ``pism_tpu_torch`` against
``pism_tpu`` on the CPU in float64.

- The tracer chain (``setups.TRACER_CFG`` on the 100 km synthetic
  Greenland chain: age with the age-coupled enhancement, isochrones every
  0.25 a, CH warming, k(T), upstream w) for 2 model years, from one numpy
  state with the pressure-melting ties broken as in
  ``tests/test_torch_hybrid_chain.py``: equal steps, dt-limit hits, end
  time and active isochrone layer; the volume within 1e-9; H, E, the age,
  the CH state and every isochrone layer (whose content says on which
  substep each layer switched on) within that file's 5e-7 of their max,
  the velocities within its 5e-2.
- Fracture density with softening (``setups.FRACTURE_CFG``) on the PIK
  chain at 200 km (21 x 21, Mz 11, the size ``tests/test_torch_
  antarctica.py`` holds the chain at: PICO's melt turns inf at 100 km on
  this state, and 41 x 41 passes this suite's 31 x 31), the default
  minmod transport (each transport's step is held to JAX in
  ``tests/test_torch_fracture.py``): one step from 0 a, with phi, its age and H within 5e-7 of their max and
  the velocities within that file's 1e-6; then 2 a with equal steps and
  hits, the volume within 1e-9 and phi at the envelope (the SSA solves of
  this chain stagnate and part the velocities by percents from the second
  solve on, so the damage moves with them): max phi within 2e-2, the
  damaged floating area within 10%.
- The new components under a 2 x 2 mesh of CPU devices against their
  unmeshed run: equal steps and hits, every new field within 1e-12 of its
  max (the meshed chain's bound in ``tests/test_torch_sharded.py``).
"""

import os
import tempfile

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

_env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
_cache = (jax.config.jax_compilation_cache_dir,
          jax.config.jax_persistent_cache_min_compile_time_secs)
os.environ["JAX_COMPILATION_CACHE_DIR"] = tempfile.mkdtemp()
import bench  # noqa: E402

jax.config.update("jax_compilation_cache_dir", _cache[0])
jax.config.update("jax_persistent_cache_min_compile_time_secs", _cache[1])
if _env is None:
    del os.environ["JAX_COMPILATION_CACHE_DIR"]
else:
    os.environ["JAX_COMPILATION_CACHE_DIR"] = _env

import test_torch_antarctica as TA  # noqa: E402
from pism_tpu_torch import setups  # noqa: E402
from pism_tpu_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402
from pism_tpu_torch.model.icemodel import IceModel  # noqa: E402
from test_torch_hybrid_chain import (  # noqa: E402
    break_pressure_melting_ties, jax_to_numpy, numpy_to_jax)

SPY = 3.15569259747e7
YEARS = 2.0


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.fixture(scope="module")
def tracers():
    jm, js, _ = bench.hybrid_greenland_model("float64", km=100,
                                             extra_cfg=setups.TRACER_CFG)
    tm, ts, grid = setups.hybrid_greenland_model(
        "float64", km=100, device="cpu", extra_cfg=setups.TRACER_CFG)
    d0 = (jax_to_numpy(jm.prepare_state(js)),
          state_to_numpy(tm.prepare_state(ts)))
    d, _ = break_pressure_melting_ties(d0[0], grid, tm.EC)
    d["ch_enthalpy"] = d["enthalpy"]
    a, ta, sa = jm.step_once(numpy_to_jax(d), 0.0, YEARS * SPY)
    b, tb, sb = tm.step_once(state_from_numpy(d, device="cpu"), 0.0,
                             YEARS * SPY)
    return dict(d0=d0, d=d, grid=grid, model=tm,
                jax=(jax_to_numpy(a), float(ta), sa),
                torch=(state_to_numpy(b), tb, sb))


def test_tracer_initial_states_equal(tracers):
    a, b = tracers["d0"]
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert int(b["iso_top"]) == 0 and b["age"].max() == 15000.0 * SPY


def test_tracer_steps_hits_and_switches_equal(tracers):
    (a, ta, sa), (b, tb, sb) = tracers["jax"], tracers["torch"]
    assert sb.nsteps == int(sa.nsteps) > 0
    assert sb.limit_hits_dict() == sa.limit_hits_dict()
    assert tb == ta
    assert int(b["iso_top"]) == int(a["iso_top"]) == 7
    assert abs(b["ice_thickness"].sum() - a["ice_thickness"].sum()) \
        <= 1e-9 * a["ice_thickness"].sum()


@pytest.mark.parametrize("field,tol", [
    ("ice_thickness", 5e-7), ("enthalpy", 5e-7), ("age", 5e-7),
    ("ch_enthalpy", 5e-7), ("iso_layers", 5e-7), ("u_ssa", 5e-2),
    ("v_ssa", 5e-2)])
def test_tracer_fields_agree(tracers, field, tol):
    (a, _, _), (b, _, _) = tracers["jax"], tracers["torch"]
    assert np.isfinite(b[field]).all()
    assert _rel(b[field], a[field]) <= tol
    if field == "iso_layers":
        # every layer on its own, against the field's max: a switch one
        # substep off moves a substep's accumulation (centimetres) between
        # two layers
        scale = np.abs(a[field]).max()
        for k in range(int(b["iso_top"]) + 1):
            assert np.abs(b[field][..., k] - a[field][..., k]).max() \
                <= tol * scale, k


def test_tracer_chain_acts(tracers):
    """Both enhancements occur (old ice glacial, new ice Holocene); the
    age stays within [0, t + age.initial_value]; the layers sum to H."""
    b, tb, _ = tracers["torch"]
    m = tracers["model"]
    st = state_from_numpy(b, device="cpu")
    e = m.stress_balance.age_enhancement(st, tb).numpy()
    z = np.asarray(tracers["grid"].z)
    ice = (z <= b["ice_thickness"][..., None]) \
        & np.isin(b["cell_type"], (2, 3))[..., None]
    assert set(np.unique(e[ice])) == {1.0, 3.0}
    assert b["age"].min() >= 0.0
    assert b["age"][ice].max() <= (tb + 15000.0 * SPY) * (1 + 1e-12)
    icy = np.isin(b["cell_type"], (2, 3))
    np.testing.assert_allclose(b["iso_layers"].sum(-1)[icy],
                               b["ice_thickness"][icy], rtol=1e-12)


@pytest.fixture(scope="module")
def fracture():
    extra = setups.FRACTURE_CFG      # the default minmod transport
    jm, js = TA.jax_chain(extra)
    tm, ts, grid = setups.antarctica_pik_model("float64", km=TA.KM,
                                               device="cpu", Mz=TA.MZ,
                                               extra_cfg=extra)
    d0 = (TA.jax_to_numpy(js), state_to_numpy(ts))
    d, _ = TA.untie(d0[0], grid, tm.EC)
    out = {"d0": d0, "grid": grid}
    j1, _, sj1 = jm.step_once(TA.numpy_to_jax(d), 0.0, 0.25 * SPY)
    t1, _, st1 = tm.step_once(state_from_numpy(d, device="cpu"), 0.0,
                              0.25 * SPY)
    out["one"] = ((TA.jax_to_numpy(j1), sj1), (state_to_numpy(t1), st1))
    j2, tj, sj = jm.step_once(TA.numpy_to_jax(d), 0.0, YEARS * SPY)
    t2, tt, st = tm.step_once(state_from_numpy(d, device="cpu"), 0.0,
                              YEARS * SPY)
    out["run"] = ((TA.jax_to_numpy(j2), tj, sj), (state_to_numpy(t2), tt, st))
    return out


def test_fracture_initial_states_equal(fracture):
    a, b = fracture["d0"]
    assert sorted(a) == sorted(b) and "fracture_density" in b
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_fracture_one_step(fracture):
    (a, sa), (b, sb) = fracture["one"]
    assert sb.nsteps == int(sa.nsteps) == 1
    assert b["fracture_density"].max() > 0.0
    for name, tol in (("ice_thickness", 5e-7), ("fracture_density", 5e-7),
                      ("fracture_age", 5e-7), ("u_ssa", 1e-6),
                      ("v_ssa", 1e-6)):
        assert _rel(b[name], a[name]) <= tol, name
    np.testing.assert_array_equal(b["fracture_density"] > 0,
                                  a["fracture_density"] > 0)


def test_fracture_run(fracture):
    (a, ta, sa), (b, tb, sb) = fracture["run"]
    assert sb.nsteps == int(sa.nsteps) and tb == pytest.approx(ta)
    assert sb.limit_hits_dict() == sa.limit_hits_dict()
    assert TA._volume_rel(b, a) <= 1e-9
    pa, pb = a["fracture_density"], b["fracture_density"]
    assert 0.0 <= pb.min() and pb.max() <= 1.0
    assert abs(pb.max() - pa.max()) <= 2e-2 * pa.max()
    fa = ((pa > 0) & (a["cell_type"] == 3)).sum()
    fb = ((pb > 0) & (b["cell_type"] == 3)).sum()
    assert fa > 0 and abs(fb - fa) <= 0.1 * fa


def test_new_components_meshed_match_unmeshed():
    """The tracer chain with fracture density added (its SSA bc-free
    shelf cells) at 100 km on a (2, 2) mesh of CPU devices against the
    same model without a mesh, 1 model year."""
    from pism_tpu_torch.parallel import make_mesh

    extra = dict(setups.TRACER_CFG, **setups.FRACTURE_CFG)
    mesh = make_mesh(["cpu"] * 4, (2, 2))
    model, state, grid = setups.hybrid_greenland_model(
        "float64", 100.0, device="cpu", mesh=mesh, extra_cfg=extra)
    ref = IceModel(grid=grid, config=model.config, surface=model.surface,
                   ocean=model.ocean, device="cpu")
    a, ta, sa = ref.step_once(state, 0.0, 1.0 * SPY)
    b, tb, sb = model.step_once(state, 0.0, 1.0 * SPY)
    assert ta == tb and a.iso_top == b.iso_top
    assert sb.nsteps == sa.nsteps > 0
    assert sb.limit_hits_dict() == sa.limit_hits_dict()
    for name in ("ice_thickness", "age", "ch_enthalpy", "iso_layers",
                 "fracture_density", "fracture_age"):
        x = getattr(a.geometry if name == "ice_thickness" else a, name)
        y = getattr(b.geometry if name == "ice_thickness" else b, name)
        assert bool(torch.isfinite(y).all())
        assert float((x - y).abs().max()) <= 1e-12 * max(
            float(x.abs().max()), 1.0), name


@pytest.mark.parametrize("flag", ["age.enabled", "age.isochrones.enabled",
                                  "fracture_density.enabled",
                                  "energy.ch_warming.enabled"])
def test_new_components_refused_on_the_member_axis(flag):
    """Each new component raises on an ensemble's member axis, naming the
    ROADMAP item that holds it."""
    from pism_tpu_torch import Config, Grid
    from pism_tpu_torch.coupler.surface import Uniform

    cfg = Config({flag: True, "stress_balance.model": "sia"})
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        IceModel(grid=Grid(Mx=5, My=5, Lx=1e5, Ly=1e5, Mz=5, Lz=1e3),
                 config=cfg, surface=Uniform(), device="cpu",
                 member_axis=True)
