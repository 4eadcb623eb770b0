"""Lingle-Clark bed deformation (``model/beddef.py``), pism_tpu_torch
(``torch.fft``) against pism_tpu (``jnp.fft``) on the CPU in float64, on a
25 x 21 grid with a load made from a seed: ``initialize`` (no uplift, an
uplift-rate field, the ``bed_deformation.bed_uplift_file``), then steps
with and without the update interval (inside an interval, across one,
with a step longer than the interval) and with the elastic plate: the
bed, the viscous displacement and the references to 1e-10 of their max.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pism_tpu import Config as JConfig, Grid as JGrid
from pism_tpu import state as JS
from pism_tpu.model.beddef import LingleClark as JLC
from pism_tpu_torch import Config, Grid
from pism_tpu_torch import state as TS
from pism_tpu_torch.io.nc4 import File
from pism_tpu_torch.model.beddef import LingleClark, \
    bed_deformation_from_config

torch.set_num_threads(2)

SPY = 3.15569259747e7
GRID = dict(Mx=25, My=21, Lx=600e3, Ly=500e3)
RTOL = 1e-10


def _fields(seed=2):
    g = JGrid(**GRID)
    X, Y = np.meshgrid(g.x, g.y)
    rng = np.random.default_rng(seed)
    bed = 300.0 - 600.0 * ((X / 6e5) ** 2 + (Y / 5e5) ** 2) \
        + 20.0 * rng.normal(size=X.shape)
    H0 = 2000.0 * np.clip(1 - (X / 4e5) ** 2 - (Y / 3e5) ** 2, 0, None)
    H1 = H0 * 1.2 + rng.uniform(0, 50, X.shape)
    uplift = (5e-3 * np.exp(-(X ** 2 + Y ** 2) / 2e5 ** 2)
              + 1e-4 * rng.normal(size=X.shape)) / SPY
    return bed, H0, H1, uplift


def _close(got, want, name):
    g, w = got.numpy(), np.asarray(want, np.float64)
    assert g.shape == w.shape, name
    scale = max(np.abs(w).max(), 1e-300)
    err = np.abs(g - w).max()
    assert err <= RTOL * scale, f"{name}: {err:.3e} > {RTOL:.0e} * {scale:.3e}"


def _compare(ts, js):
    _close(ts.geometry.bed_elevation, js.geometry.bed_elevation, "bed")
    for name in ("bed_uplift", "bed_reference", "bed_load_reference"):
        _close(getattr(ts, name), getattr(js, name), name)


def _pair(over, uplift=None):
    bed, H0, _, up = _fields()
    cfg = dict({"runtime.float_dtype": "float64",
                "bed_deformation.model": "lc"}, **over)
    jm = JLC(grid=JGrid(**GRID), config=JConfig(cfg))
    tm = bed_deformation_from_config(Grid(**GRID), Config(cfg))
    assert isinstance(tm, LingleClark)
    js = jm.initialize(
        JS.ModelState(geometry=JS.new_geometry(jnp.asarray(H0),
                                               jnp.asarray(bed))),
        uplift_rate=None if uplift is None else jnp.asarray(up))
    ts = tm.initialize(
        TS.ModelState(geometry=TS.new_geometry(torch.tensor(H0),
                                               torch.tensor(bed))),
        uplift_rate=None if uplift is None else torch.tensor(up))
    return jm, tm, js, ts


@pytest.mark.parametrize("uplift", [None, "field"])
def test_initialize_matches(uplift):
    _, _, js, ts = _pair({}, uplift)
    _compare(ts, js)
    if uplift is not None:
        assert float(ts.bed_uplift.abs().max()) > 0.0


def test_initialize_from_uplift_file(tmp_path):
    bed, H0, _, up = _fields()
    g = Grid(**GRID)
    path = str(tmp_path / "uplift.nc")
    with File(path, "w", format="netcdf3") as f:
        f.define_dimension("y", g.My, g.y)
        f.define_dimension("x", g.Mx, g.x)
        f.write("dbdt", up, ("y", "x"), {"units": "m s-1"})
    over = {"bed_deformation.bed_uplift_file": path}
    jm, tm, js, ts = _pair(over)
    _compare(ts, js)
    _, _, js2, ts2 = _pair({}, "field")
    _close(ts.bed_uplift, ts2.bed_uplift, "file against field")


STEPS = [
    # (config, [(dt [a], end time [a])...])
    ({}, [(3.0, 3.0), (4.0, 7.0), (5.0, 12.0), (1.0, 13.0)]),
    ({}, [(25.0, 25.0)]),
    ({"bed_deformation.update_interval": 0.0}, [(3.0, 3.0), (0.5, 3.5)]),
    ({"bed_deformation.lc.elastic_model": True}, [(12.0, 12.0), (9.0, 21.0)]),
    ({"bed_deformation.update_interval": 0.0,
      "bed_deformation.lc.elastic_model": True}, [(2.0, 2.0)]),
]


@pytest.mark.parametrize("over,steps", STEPS)
@pytest.mark.parametrize("uplift", [None, "field"])
def test_steps_match(over, steps, uplift):
    jm, tm, js, ts = _pair(over, uplift)
    _, _, H1, _ = _fields()
    js = js.replace(geometry=js.geometry.replace(
        ice_thickness=jnp.asarray(H1)))
    ts = ts.replace(geometry=ts.geometry.replace(
        ice_thickness=torch.tensor(H1)))
    bed0 = ts.geometry.bed_elevation
    for dt, t in steps:
        js = jm.step(js, jnp.asarray(dt * SPY), t=jnp.asarray(t * SPY))
        ts = tm.step(ts, dt * SPY, t=t * SPY)
        _compare(ts, js)
    # the bed moved under the added load
    assert float((ts.geometry.bed_elevation - bed0).abs().max()) > 0.0


def test_step_inside_an_interval_changes_nothing():
    jm, tm, js, ts = _pair({})
    out = tm.step(ts, 3.0 * SPY, t=5.0 * SPY)
    assert out is ts
