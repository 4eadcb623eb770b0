"""Frontal melt (``coupler/frontalmelt.py``) and the front retreat it drives
(``model/calving.py``), pism_tpu_torch against pism_tpu on the CPU in
float64: each frontal-melt model and its factory, and the calving step's
applicable rate, its dt limit and its per-mechanism parts with a
frontal-melt rate, alone (``methods = ("none",)``) and summed with the
calving laws' rates, on the calving tests' geometry (20 x 24 cells: a
grounded island, a floating tongue, a grounded marine margin, a berg,
part-grid Href in the ocean). All to 1e-12 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pism_tpu import Config as JConfig, Grid as JGrid
from pism_tpu import state as JS
from pism_tpu.coupler import frontalmelt as j_fm
from pism_tpu.model import calving as j_calv
from pism_tpu_torch import Config, Grid
from pism_tpu_torch import state as TS
from pism_tpu_torch.coupler import frontalmelt as t_fm
from pism_tpu_torch.model import calving as t_calv

from test_torch_calving import (DT, GRID, SB, SPY, _close, _inputs, _jgeom,
                                _tgeom)

torch.set_num_threads(2)


def _fields(seed=5):
    rng = np.random.default_rng(seed)
    shape = (GRID["My"], GRID["Mx"])
    return dict(theta=rng.uniform(-0.5, 4.0, shape),
                rate=rng.uniform(-10.0, 400.0, shape) / SPY,
                discharge=rng.uniform(0.0, 50.0, shape),
                Q=rng.uniform(0.0, 1e-2, shape),
                W=rng.uniform(0.0, 0.5, shape))


def _pair(jcls, tcls, **kw):
    return (jcls(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                    for k, v in kw.items()}),
            tcls(**{k: torch.tensor(v) if isinstance(v, np.ndarray) else v
                    for k, v in kw.items()}))


@pytest.mark.parametrize("hydro", ["Q", "W", None])
def test_discharge_routing(hydro):
    geom, *_ = _inputs()
    f = _fields()
    jm, tm = _pair(j_fm.DischargeRouting, t_fm.DischargeRouting,
                   theta=f["theta"], A=2e-4, B=0.2)
    key = {"Q": "hydro_Q", "W": "hydro_W"}.get(hydro)
    kw = {} if key is None else {key: f[hydro]}
    js = JS.ModelState(geometry=_jgeom(geom),
                       **{k: jnp.asarray(v) for k, v in kw.items()})
    ts = TS.ModelState(geometry=_tgeom(geom),
                       **{k: torch.tensor(v) for k, v in kw.items()})
    _close(tm(ts.geometry, 0.0, state=ts), jm(js.geometry, 0.0, state=js),
           f"routing ({hydro})")


def test_constant_given_discharge_given():
    geom, *_ = _inputs()
    f = _fields()
    for jm, tm in (_pair(j_fm.Constant, t_fm.Constant, rate=120.0 / SPY),
                   _pair(j_fm.Given, t_fm.Given, rate_field=f["rate"]),
                   _pair(j_fm.DischargeGiven, t_fm.DischargeGiven,
                         theta=f["theta"], discharge=f["discharge"])):
        _close(tm(_tgeom(geom), 0.0), jm(_jgeom(geom), 0.0),
               type(tm).__name__)


@pytest.mark.parametrize("name,inputs", [
    ("constant", {}), ("given", {"frontal_melt_rate": "rate"}),
    ("routing", {"theta_ocean": "theta"}),
    ("discharge_given", {"theta_ocean": "theta",
                         "subglacial_discharge": "discharge"})])
def test_factory(name, inputs):
    geom, *_ = _inputs()
    f = _fields()
    cfg = {"frontal_melt.models": name,
           "frontal_melt.constant.melt_rate": 80.0,
           "frontal_melt.routing.parameter_a": 4e-4,
           "frontal_melt.routing.power_beta": 1.3}
    jm = j_fm.frontal_melt_from_config(
        JConfig(cfg), inputs={k: jnp.asarray(f[v]) for k, v in inputs.items()})
    tm = t_fm.frontal_melt_from_config(
        Config(cfg), inputs={k: torch.tensor(f[v]) for k, v in inputs.items()})
    assert type(tm).__name__ == type(jm).__name__
    _close(tm(_tgeom(geom), 0.0), jm(_jgeom(geom), 0.0), name)
    if inputs:
        with pytest.raises(ValueError):
            t_fm.frontal_melt_from_config(Config(cfg))
    assert t_fm.frontal_melt_from_config(Config({})) is None


def _models(over, methods=()):
    cfg = dict({"runtime.float_dtype": "float64",
                "geometry.part_grid.enabled": True,
                "geometry.remove_icebergs": True,
                "calving.eigen_calving.K": 3.0e16}, **over)
    return (j_calv.CalvingModel(grid=JGrid(**GRID), config=JConfig(cfg),
                                methods=methods),
            t_calv.CalvingModel(grid=Grid(**GRID), config=Config(cfg),
                                methods=methods))


CASES = [
    ({"calving.methods": ""}, ("none",)),
    ({"calving.methods": "", "frontal_melt.include_floating_ice": True},
     ("none",)),
    ({"calving.methods": "eigen_calving"}, ()),
    ({"calving.methods": "eigen_calving,thickness_calving",
      "calving.thickness_calving.threshold": 150.0,
      "frontal_melt.include_floating_ice": True}, ()),
    ({"calving.methods": "hayhurst_calving",
      "geometry.part_grid.enabled": False}, ()),
    ({"calving.methods": "", "geometry.part_grid.enabled": False,
      "frontal_melt.include_floating_ice": True}, ("none",)),
]


@pytest.mark.parametrize("over,methods", CASES)
def test_calving_with_frontal_melt(over, methods):
    geom, u, v, B = _inputs()
    rate = _fields()["rate"]
    jm, tm = _models(over, methods)
    jsb, tsb = SB(jnp.asarray(u), jnp.asarray(v)), \
        SB(torch.tensor(u), torch.tensor(v))
    jr, tr = jnp.asarray(rate), torch.tensor(rate)
    _close(tm.applicable_rate(_tgeom(geom), tsb, frontal_melt_rate=tr),
           jm.applicable_rate(_jgeom(geom), jsb, frontal_melt_rate=jr),
           "applicable rate")
    dt_port = tm.max_timestep_from_rate(
        float(tm.max_rate(_tgeom(geom), tsb, frontal_melt_rate=tr)),
        torch.float64)
    dt_jax = float(jm.max_timestep(_jgeom(geom), jsb, frontal_melt_rate=jr))
    assert dt_port == pytest.approx(dt_jax, rel=1e-12)
    jout, jparts = jm.step(_jgeom(geom), jsb, DT, t=3.0 * SPY,
                           frontal_melt_rate=jr, with_parts=True)
    tout, tparts = tm.step(_tgeom(geom), tsb, DT, t=3.0 * SPY,
                           frontal_melt_rate=tr, with_parts=True)
    for name in ("ice_thickness", "ice_area_specific_volume"):
        _close(getattr(tout, name), getattr(jout, name), name)
    for k in ("calving", "frontal_melt", "forced_retreat"):
        _close(tparts[k], jparts[k], k)
    assert float(tparts["frontal_melt"].sum()) < 0.0


def test_frontal_melt_builds_a_front_retreat():
    """With frontal melt and no calving law the model builds the front
    retreat of ``methods = ("none",)``; the member axis and a mesh refuse
    frontal melt, naming the ROADMAP items."""
    from pism_tpu_torch import setups
    from pism_tpu_torch.parallel import make_mesh

    model, state, grid = setups.hybrid_greenland_model(
        "float64", 200.0, device="cpu", frontal_melt="routing",
        extra_cfg={"calving.methods": "", "geometry.remove_icebergs": False})
    assert model.calving.methods == ("none",)
    with pytest.raises(NotImplementedError, match="item 10"):
        setups.hybrid_greenland_model(
            "float64", 200.0, device="cpu", frontal_melt="routing",
            mesh=make_mesh(["cpu"] * 4, (2, 2)))
    import dataclasses
    with pytest.raises(NotImplementedError, match="item 3"):
        dataclasses.replace(model, member_axis=True)
