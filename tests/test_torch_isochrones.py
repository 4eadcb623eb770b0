"""Isochrone layer tracing (``model/isochrones.py``): ``pism_tpu_torch``
against ``pism_tpu`` on the CPU.

The five cases of the JAX package's ``tests/test_isochrones.py`` run on
the port with their assertions, each result held to the JAX twin's
(within 1e-12 relative in float64). Then: one substep with transport,
accumulation and surface and basal melt from random layers and fluxes
(1e-12 in float64, float32 rounding in float32); the substep on which a
new layer switches on, decided by the port on the host from the float64
clock and by JAX on the device, equal over a run of substeps whose start
times straddle the deposition times; the deposition-time parser of the
JAX ``IceModel``; and the ``isochrone_depth`` diagnostic.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu import Config as JConfig, Grid as JGrid  # noqa: E402
from pism_tpu.model import diagnostics as j_diag  # noqa: E402
from pism_tpu.model.isochrones import (  # noqa: E402
    IsochroneState as JIsoState, Isochrones as JIsochrones)
from pism_tpu.state import ModelState as JState  # noqa: E402
from pism_tpu.state import new_geometry as j_new_geometry  # noqa: E402
import pism_tpu_torch as pt  # noqa: E402
from pism_tpu_torch.model import diagnostics as t_diag  # noqa: E402
from pism_tpu_torch.model import isochrones as t_iso  # noqa: E402
from pism_tpu_torch.state import ModelState, new_geometry  # noqa: E402

SPY = 3.15569259747e7
DEP = [100.0 * SPY, 200.0 * SPY, 300.0 * SPY]


def _rel(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


class Pair:
    """The JAX and the port's isochrones on one grid, stepped together
    from numpy inputs; ``check`` holds the two states."""

    def __init__(self, grid_kw, n_layers=6, H0=1000.0, dtype=np.float64):
        self.dtype = dtype
        self.jg, self.tg = JGrid(**grid_kw), pt.Grid(**grid_kw)
        self.jm = JIsochrones(grid=self.jg, n_layers=n_layers)
        self.jstep = jax.jit(self.jm.step)
        self.tm = t_iso.Isochrones(grid=self.tg, n_layers=n_layers)
        H0 = np.full(self.jg.shape2, H0, dtype) if np.ndim(H0) == 0 \
            else H0.astype(dtype)
        self.ji = self.jm.initialize(jnp.asarray(H0), DEP)
        self.ti = self.tm.initialize(torch.as_tensor(H0), DEP)

    def step(self, t, dt, Qe, Qn, H_old, H_new, smb, bmb):
        c = lambda a: np.asarray(a, self.dtype)     # noqa: E731
        self.ji = self.jstep(self.ji, jnp.float64(t), jnp.asarray(c(dt)), *(
            jnp.asarray(c(a)) for a in (Qe, Qn, H_old, H_new, smb, bmb)))
        self.ti = self.tm.step(self.ti, t, float(c(dt)), *(
            torch.as_tensor(c(a)) for a in (Qe, Qn, H_old, H_new, smb, bmb)))
        return self.ti

    def check(self, tol=1e-12):
        assert self.ti.top == int(self.ji.top)
        assert _rel(self.ti.layers, self.ji.layers) <= tol


@pytest.fixture
def setup():
    return Pair(dict(Mx=8, My=6, Lx=40e3, Ly=30e3))


def test_accumulation_fills_active_layer(setup):
    p = setup
    zero = np.zeros(p.jg.shape2)
    smb = np.full(p.jg.shape2, 0.5 / SPY)
    dt = 50.0 * SPY
    H0 = np.full(p.jg.shape2, 1000.0)
    H1 = H0 + 0.5 * 50.0
    iso = p.step(0.0, dt, zero, zero, H0, H1, smb, zero)
    assert float(iso.layers[3, 3, 0]) == pytest.approx(1025.0)
    assert iso.top == 0
    p.check()
    # t = 150 a: layer 1 has activated (deposition time 100 a)
    H2 = H1 + 25.0
    iso = p.step(150.0 * SPY, dt, zero, zero, H1, H2, smb, zero)
    assert iso.top == 1
    assert float(iso.layers[3, 3, 1]) == pytest.approx(25.0)
    np.testing.assert_allclose(iso.layers.sum(-1).numpy(), H2, rtol=1e-12)
    p.check()


def test_surface_melt_eats_top_layers(setup):
    p = setup
    zero = np.zeros(p.jg.shape2)
    H0 = np.full(p.jg.shape2, 1000.0)
    dt = 30.0 * SPY
    iso = p.step(150.0 * SPY, dt, zero, zero, H0, H0 + 30,
                 np.full(p.jg.shape2, 1.0 / SPY), zero)
    assert iso.top == 1 and float(iso.layers[2, 2, 1]) == pytest.approx(30.0)
    # melt 40 m: all 30 m of layer 1 and 10 m of layer 0
    iso = p.step(180.0 * SPY, dt, zero, zero, H0 + 30, H0 - 10,
                 np.full(p.jg.shape2, -40.0 / (30.0 * SPY)), zero)
    assert float(iso.layers[2, 2, 1]) == pytest.approx(0.0, abs=1e-9)
    assert float(iso.layers[2, 2, 0]) == pytest.approx(990.0)
    p.check()


def test_basal_melt_eats_bottom_layer(setup):
    p = setup
    zero = np.zeros(p.jg.shape2)
    H0 = np.full(p.jg.shape2, 1000.0)
    iso = p.step(0.0, 10.0 * SPY, zero, zero, H0, H0 - 20, zero,
                 np.full(p.jg.shape2, 20.0 / (10.0 * SPY)))
    assert float(iso.layers[2, 2, 0]) == pytest.approx(980.0)
    p.check()


def test_depths_monotone(setup):
    p = setup
    zero = np.zeros(p.jg.shape2)
    smb = np.full(p.jg.shape2, 0.5 / SPY)
    t, H = 0.0, np.full(p.jg.shape2, 1000.0)
    for _ in range(6):
        H2 = H + 0.5 * 60.0
        iso = p.step(t, 60.0 * SPY, zero, zero, H, H2, smb, zero)
        t += 60.0 * SPY
        H = H2
    depths = p.tm.isochrone_depths(iso, torch.as_tensor(H)).numpy()[2, 2]
    d = depths[iso.layers.numpy()[2, 2] > 0]
    assert np.all(np.diff(d) <= 1e-9)        # younger layers shallower
    assert _rel(p.tm.isochrone_depths(iso),
                p.jm.isochrone_depths(p.ji, jnp.asarray(H))) <= 1e-12
    p.check()


def test_isochrone_depth_diagnostic(setup):
    """isochrone_depth: the depth of each layer's top below the surface,
    zero for the top layer, monotone with the layer index; equal to JAX's
    diagnostic, and a (My, Mx, 1) zero field without isochrones."""
    p = setup
    zero = np.zeros(p.jg.shape2)
    p.step(150.0 * SPY, 20.0 * SPY, zero, zero, np.full(p.jg.shape2, 1e3),
           np.full(p.jg.shape2, 1e3 + 20.0), np.full(p.jg.shape2, 1.0 / SPY),
           zero)
    H0 = np.full(p.jg.shape2, 1020.0)
    state = ModelState(geometry=new_geometry(torch.as_tensor(H0),
                                             torch.zeros(p.tg.shape2,
                                                         dtype=torch.float64)),
                       iso_layers=p.ti.layers, iso_top=p.ti.top)
    jstate = JState(geometry=j_new_geometry(jnp.asarray(H0),
                                            jnp.zeros(p.jg.shape2)),
                    iso_layers=p.ji.layers, iso_top=p.ji.top)
    d = t_diag.SPATIAL["isochrone_depth"].func(
        state, SimpleNamespace(grid=p.tg), 0.0).numpy()
    assert d.shape == p.tg.shape2 + (6,)
    layers = p.ti.layers.numpy()
    np.testing.assert_allclose(d[..., 0], layers[..., 1:].sum(-1), atol=1e-9)
    assert (np.diff(d, axis=-1) <= 1e-9).all()
    assert np.all(d[..., -1] == 0.0)
    want = j_diag.SPATIAL["isochrone_depth"].func(
        jstate, SimpleNamespace(grid=p.jg), 0.0)
    assert _rel(d, want) <= 1e-12
    empty = t_diag.SPATIAL["isochrone_depth"].func(
        state.replace(iso_layers=None), SimpleNamespace(grid=p.tg), 0.0)
    assert tuple(empty.shape) == p.tg.shape2 + (1,) and not empty.any()


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 2e-6)])
def test_transport_and_melt_substeps_match(dtype, tol):
    """Five substeps from random layers with random staggered fluxes of
    both signs, accumulation in some cells, surface and basal melt in
    others."""
    rng = np.random.default_rng(17)
    kw = dict(Mx=17, My=13, Lx=160e3, Ly=120e3)
    H0 = rng.uniform(0.0, 2000.0, (13, 17))
    p = Pair(kw, n_layers=8, H0=H0, dtype=dtype)
    lay = rng.uniform(0.0, 1.0, (13, 17, 8)) * (np.arange(8) <= 3)
    lay = lay / lay.sum(-1, keepdims=True) * H0[..., None]
    p.ji = JIsoState(layers=jnp.asarray(lay.astype(dtype)), top=p.ji.top + 3,
                     deposition_times=p.ji.deposition_times)
    p.ti = t_iso.IsochroneState(torch.as_tensor(lay.astype(dtype)), 3,
                                p.ti.deposition_times)
    H, t = H0, 250.0 * SPY
    for _ in range(5):
        Qe, Qn = (rng.standard_normal(H.shape) * 1e-3 for _ in range(2))
        smb = rng.uniform(-2.0, 1.0, H.shape) / SPY
        bmb = rng.uniform(-0.2, 0.5, H.shape) / SPY
        H_new = np.maximum(H + rng.uniform(-5.0, 5.0, H.shape), 0.0)
        p.step(t, 3.0 * SPY, Qe, Qn, H, H_new, smb, bmb)
        p.check(tol)
        H, t = H_new, t + 3.0 * SPY
    assert p.ti.top == 3     # no deposition time after 300 a


def test_switch_substep_matches():
    """Substeps of a float32 run (dt_sub rounded to float32, the step's
    start time a float64 sum of them, as the models form them) whose
    start times straddle the deposition times every 0.25 a: after each
    substep the port's top layer equals JAX's, and so the layers."""
    kw = dict(Mx=6, My=5, Lx=30e3, Ly=25e3)
    dep = [0.25 * k * SPY for k in range(1, 9)]
    jg, tg = JGrid(**kw), pt.Grid(**kw)
    jm = JIsochrones(grid=jg, n_layers=6)
    tm = t_iso.Isochrones(grid=tg, n_layers=6)
    H = np.full(jg.shape2, 800.0, np.float32)
    ji, ti = jm.initialize(jnp.asarray(H), dep), \
        tm.initialize(torch.as_tensor(H), dep)
    zero = np.zeros(jg.shape2, np.float32)
    smb = np.full(jg.shape2, 0.3 / SPY, np.float32)
    jstep = jax.jit(jm.step)
    t, tops = 0.0, []
    for step_dt in (0.1, 0.15, 0.2499999, 0.05, 0.2, 0.25, 0.3, 0.1, 0.4):
        dt = float(np.float32(step_dt * SPY))
        sub = float(np.float32(np.float32(dt) / np.float32(10)))
        for _ in range(10):
            # every substep of a step starts at the step's start time
            ji = jstep(ji, jnp.float64(t), jnp.float32(sub),
                         *(jnp.asarray(a) for a in (zero, zero, H, H + 0.1,
                                                    smb, zero)))
            ti = tm.step(ti, t, sub, *(torch.as_tensor(a) for a in (
                zero, zero, H, H + 0.1, smb, zero)))
            assert ti.top == int(ji.top)
            tops.append(ti.top)
        t += dt
    assert tops[-1] == 5 and len(set(tops)) == 6
    assert _rel(ti.layers, ji.layers) <= 2e-6


def test_deposition_times_parser():
    """The keys the JAX IceModel reads (``isochrones.*`` over
    ``age.isochrones.*``), the times array of its ``__post_init__``."""
    from pism_tpu.model.icemodel import IceModel as JIceModel   # noqa: F401
    from pism_tpu.cli import parse_times
    for over, n in (({"age.isochrones.deposition_times": "0.25:0.25:1"}, 16),
                    ({"isochrones.deposition_times": "1,2,5",
                      "age.isochrones.deposition_times": "9"}, 16),
                    ({"age.isochrones.deposition_times": "0:1:40",
                      "isochrones.bootstrapping.n_layers": 7}, 7),
                    ({}, 16)):
        jc, tc = JConfig(over), pt.Config(over)
        spec = jc.get_string("isochrones.deposition_times") \
            if jc.is_set("isochrones.deposition_times") \
            else jc.get_string("age.isochrones.deposition_times")
        dep = parse_times(spec, SPY) if spec else []
        assert t_iso.deposition_times(tc) == dep
        assert t_iso.n_layers(tc) == n
        times = np.full((n,), np.inf)
        times[1:1 + min(len(dep), n - 1)] = dep[: n - 1]
        np.testing.assert_array_equal(t_iso.times_array(n, dep), times)
