"""The subglacial hydrology of pism_tpu_torch (``physics/hydrology.py``:
null, routing, distributed, steady; Mohr-Coulomb's
``add_transportable_water``; ``pismv`` test P) against pism_tpu on the
same float64 inputs, made with numpy from a seed on a 31 x 31 ice cap
(the test-P cap on a noisy bed, ocean around it).

Tolerances: W and P within 1e-10 of their max after several steps (the
subcycles take the same substeps: the port forms each on the host in the
field dtype as the JAX loop does on the device), the steady discharge
within 1e-12 of its max, the yield stress within 1e-12, test P's error
numbers within 1e-8 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu import Config as JConfig, Grid as JGrid  # noqa: E402
from pism_tpu import state as JS  # noqa: E402
from pism_tpu.physics import basal as j_basal, hydrology as j_hyd  # noqa: E402
from pism_tpu.verification import runner as j_runner  # noqa: E402
from pism_tpu_torch import Config as TConfig, Grid as TGrid  # noqa: E402
from pism_tpu_torch import state as TS  # noqa: E402
from pism_tpu_torch.physics import basal as t_basal, hydrology as t_hyd  # noqa: E402
from pism_tpu_torch.verification import runner as t_runner  # noqa: E402
from pism_tpu_torch.verification.hydrology_exact import RoutingSteady  # noqa: E402

SPY = 3.15569259747e7
GRID = dict(Mx=31, My=31, Lx=30e3, Ly=30e3)


def check(got, ref, rtol, name=""):
    """max |got - ref| <= rtol * max |ref| (exact for an all-zero ref)."""
    g = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    r = np.asarray(ref)
    assert g.shape == r.shape, name
    err = np.abs(g - r).max()
    assert err <= rtol * np.abs(r).max(), f"{name}: {err:.3e}"


@pytest.fixture(scope="module")
def cap():
    """Numpy fields of the cap: geometry, till water half saturated, basal
    melt, routed water, pressure between 0.3 and 1 of overburden, sliding
    velocities, a surface input field and a runoff field [m/s]."""
    rng = np.random.default_rng(19)
    sol = RoutingSteady()
    g = TGrid(**GRID)
    r = g.radius
    H = sol.thickness(r)
    bed = sol.bed(r) + rng.normal(0.0, 5.0, size=g.shape2)
    W_max = 2.0
    till = np.where(rng.uniform(size=g.shape2) < 0.5, W_max,
                    rng.uniform(0.0, W_max, size=g.shape2))
    return dict(
        H=H, bed=bed, tillwat=till,
        bmr=rng.uniform(0.0, 3e-9, size=g.shape2),
        W=np.where(H > 0, rng.uniform(0.0, 0.3, size=g.shape2), 0.0),
        P=910.0 * 9.81 * H * rng.uniform(0.3, 1.0, size=g.shape2),
        u=rng.normal(0.0, 3e-6, size=g.shape2),
        v=rng.normal(0.0, 3e-6, size=g.shape2),
        surface_input=rng.uniform(0.0, 2e-8, size=g.shape2),
        runoff=rng.uniform(0.0, 5e-8, size=g.shape2),
        Q=rng.uniform(0.0, 1e-2, size=g.shape2))


def _states(cap, **fields):
    """The JAX and the port state of the cap with the named fields."""
    jg = JS.new_geometry(jnp.asarray(cap["H"]), jnp.asarray(cap["bed"]))
    tg = TS.new_geometry(torch.tensor(cap["H"]), torch.tensor(cap["bed"]))
    names = {"tillwat": "tillwat", "bmr": "basal_melt_rate", "W": "hydro_W",
             "P": "hydro_P", "Q": "hydro_Q", "u": "u_ssa", "v": "v_ssa"}
    kw = {names[k]: cap[k] if v is None else v for k, v in fields.items()}
    return (JS.ModelState(geometry=jg, **{k: jnp.asarray(v)
                                          for k, v in kw.items()}),
            TS.ModelState(geometry=tg, **{k: torch.tensor(v)
                                          for k, v in kw.items()}))


def _models(cls_name, over, **kw):
    jm = getattr(j_hyd, cls_name)(grid=JGrid(**GRID), config=JConfig(over),
                                  **{k: jnp.asarray(v) for k, v in kw.items()})
    tm = getattr(t_hyd, cls_name)(grid=TGrid(**GRID), config=TConfig(over),
                                  **{k: torch.tensor(v) for k, v in kw.items()})
    return jm, tm


@pytest.mark.parametrize("add_to_till", [True, False])
def test_null_transport_surface_input_and_runoff(cap, add_to_till):
    over = {"hydrology.surface_input_from_runoff": True,
            "hydrology.add_water_input_to_till_storage": add_to_till}
    jm, tm = _models("NullTransport", over,
                     surface_input=cap["surface_input"])
    js, ts = _states(cap, tillwat=None, bmr=None)
    dt = 0.3 * SPY
    jw = jm.step(js, dt, runoff=jnp.asarray(cap["runoff"])).tillwat
    tw = tm.step(ts, dt, runoff=torch.tensor(cap["runoff"])).tillwat
    check(tw, jw, 1e-12, "tillwat")
    if add_to_till:
        # the inputs reach the till
        without = t_hyd.NullTransport(grid=TGrid(**GRID),
                                      config=TConfig({})).step(ts, dt).tillwat
        assert float((tw - without).abs().max()) > 0.0


def _run(jm, tm, js, ts, dt, n, **kw):
    """n steps of dt through both models (the JAX step jitted)."""
    jstep = jax.jit(lambda s: jm.step(s, dt, **kw))
    for _ in range(n):
        js = jstep(js)
        ts = tm.step(ts, dt, **kw)
    return js, ts


@pytest.mark.parametrize("over", [
    {},
    {"hydrology.routing.include_floating_ice": True,
     "hydrology.add_water_input_to_till_storage": False},
    {"hydrology.thickness_power_in_flux": 1.5,
     "hydrology.gradient_power_in_flux": 1.25,
     "hydrology.surface_input_from_runoff": True},
])
def test_routing_steps(cap, over):
    jm, tm = _models("Routing", over)
    js, ts = _states(cap, tillwat=None, bmr=None, W=None)
    n0 = t_hyd.SUBCYCLES
    kw = {"runoff": cap["runoff"]} \
        if over.get("hydrology.surface_input_from_runoff") else {}
    jstep = jax.jit(lambda s: jm.step(
        s, 0.05 * SPY, **{k: jnp.asarray(v) for k, v in kw.items()}))
    for _ in range(3):
        js = jstep(js)
        ts = tm.step(ts, 0.05 * SPY,
                     **{k: torch.tensor(v) for k, v in kw.items()})
    assert t_hyd.SUBCYCLES - n0 >= 3
    check(ts.hydro_W, js.hydro_W, 1e-10, "W")
    check(ts.tillwat, js.tillwat, 1e-12, "tillwat")
    assert float(ts.hydro_W.max()) > 0.0


def test_distributed_steps(cap):
    jm, tm = _models("Distributed", {})
    js, ts = _states(cap, tillwat=None, bmr=None, W=None, P=None, u=None,
                     v=None)
    js, ts = _run(jm, tm, js, ts, 0.02 * SPY, 3)
    check(ts.hydro_W, js.hydro_W, 1e-10, "W")
    check(ts.hydro_P, js.hydro_P, 1e-10, "P")
    # the pressure stays within [0, overburden] and left overburden
    P_ov = 910.0 * 9.81 * ts.geometry.ice_thickness
    assert bool((ts.hydro_P >= 0.0).all() and (ts.hydro_P <= P_ov).all())


def test_distributed_starts_at_overburden(cap):
    jm, tm = _models("Distributed", {})
    js, ts = _states(cap, tillwat=None, bmr=None)
    js, ts = _run(jm, tm, js, ts, 0.01 * SPY, 1)
    check(ts.hydro_P, js.hydro_P, 1e-10, "P")


@pytest.mark.parametrize("max_iters", [4096, 3, 0])
def test_steady_fixed_point(cap, max_iters):
    """The flow accumulation to its fixed point, and a fixed point cut at
    a few sweeps (the JAX loop stops at exactly max_iters)."""
    over = {"hydrology.steady_max_iterations": max_iters,
            "hydrology.tillwat_decay_rate": 0.0}   # the saturated till overflows
    jm, tm = _models("Steady", over)
    js, ts = _states(cap, tillwat=None, bmr=None)
    jq = jax.jit(lambda s: jm.step(s, 86400.0))(js).hydro_Q
    n0 = t_hyd.STEADY_SWEEPS
    tq = tm.step(ts, 86400.0).hydro_Q
    sweeps = t_hyd.STEADY_SWEEPS - n0
    check(tq, jq, 1e-12, "Q")
    if max_iters < 8:
        assert sweeps == max_iters
    else:
        # converged: one more sweep changes nothing, so the count stops
        # on a check
        assert 0 < sweeps < 4096 and sweeps % 8 == 0
        assert float(tq.max()) > 0.0


@pytest.mark.parametrize("t_years,crossed", [(10.05, True), (10.5, False)])
def test_steady_update_interval(cap, t_years, crossed):
    """With a stored discharge the fixed point reruns only in a step that
    crosses a multiple of hydrology.steady.flux_update_interval (10 a)."""
    jm, tm = _models("Steady", {"hydrology.tillwat_decay_rate": 0.0})
    js, ts = _states(cap, tillwat=None, bmr=None, Q=None)
    dt, t = 0.1 * SPY, t_years * SPY
    jq = jax.jit(lambda s: jm.step(s, dt, t=t))(js).hydro_Q
    tq = tm.step(ts, dt, t=t).hydro_Q
    check(tq, jq, 1e-12, "Q")
    carried = bool(torch.equal(tq, torch.tensor(cap["Q"])))
    assert carried is not crossed


def test_yield_stress_add_transportable_water(cap):
    over = {"basal_yield_stress.add_transportable_water": True,
            "basal_yield_stress.mohr_coulomb.till_log_factor_transportable_water":
            0.3}
    js, ts = _states(cap, tillwat=cap["tillwat"] * 0.5, W=None)
    jt = j_basal.MohrCoulombYieldStress(JConfig(over)).compute(js)
    tt = t_basal.MohrCoulombYieldStress(TConfig(over)).compute(ts)
    check(tt, jt, 1e-12, "tau_c")
    plain = t_basal.MohrCoulombYieldStress(TConfig({})).compute(ts)
    assert float((plain - tt).max()) > 0.0   # the water weakens the till


def test_run_P_matches_jax():
    """Test P at 21 x 21 for 0.25 a through both runners."""
    je = j_runner.run_P(Mx=21, years=0.25)
    te = t_runner.run_test("P", Mx=21, years=0.25, device="cpu")
    assert set(te) == set(je)
    for k in je:
        assert te[k] == pytest.approx(je[k], rel=1e-8), k


def test_routing_steady_state_matches_exact():
    """The port alone at 51 x 51 for 120 weeks, under the JAX test's
    bounds (``tests/test_hydrology_exact.py``)."""
    sol = RoutingSteady()
    grid = TGrid(Mx=51, My=51, Lx=30e3, Ly=30e3)
    cfg = TConfig({"hydrology.model": "routing",
                   "hydrology.tillwat_decay_rate": 0.0,
                   "hydrology.hydraulic_conductivity": sol.k,
                   "hydrology.alpha": sol.alpha, "hydrology.beta": sol.beta})
    r = grid.radius
    W_max = cfg.get_number("hydrology.tillwat_max")
    state = TS.ModelState(
        geometry=TS.new_geometry(torch.tensor(sol.thickness(r)),
                                 torch.tensor(sol.bed(r))),
        tillwat=torch.full(grid.shape2, W_max, dtype=torch.float64),
        basal_melt_rate=torch.tensor(np.where(r < sol.R_i, sol.melt, 0.0)),
        hydro_W=torch.zeros(grid.shape2, dtype=torch.float64))
    hydro = t_hyd.Routing(grid=grid, config=cfg)
    for _ in range(120):
        state = hydro.step(state, 7.0 * 24 * 3600.0)
    W = state.hydro_W.numpy()
    We = sol.water_thickness(r)
    sel = (r > 0.2 * sol.R_i) & (r < 0.9 * sol.R_i)
    rel = np.abs(W[sel] - We[sel]) / We[sel]
    assert np.median(rel) < 0.15
    assert np.mean(rel) < 0.25
    assert W[r < 0.05 * sol.R_i].max() < 2.0 * We[sel].max()


def test_factory_and_unknown_name(tmp_path):
    """``hydrology_from_config`` builds each model, reads the surface
    input field of ``hydrology.surface_input.file``, and refuses an
    unknown name as the JAX factory does."""
    from scipy.io import netcdf_file
    g = TGrid(**GRID)
    path = tmp_path / "input.nc"
    with netcdf_file(str(path), "w") as f:
        f.createDimension("x", g.Mx)
        f.createDimension("y", g.My)
        f.createVariable("x", "d", ("x",))[:] = g.x
        f.createVariable("y", "d", ("y",))[:] = g.y
        v = f.createVariable("water_input_rate", "d", ("y", "x"))
        v[:] = np.full(g.shape2, 0.5)
        v.units = "m year-1"
    for name, cls in (("null", "NullTransport"), ("routing", "Routing"),
                      ("distributed", "Distributed"), ("steady", "Steady")):
        cfg = {"hydrology.model": name,
               "hydrology.surface_input.file": str(path)}
        jm = j_hyd.hydrology_from_config(JGrid(**GRID), JConfig(cfg))
        tm = t_hyd.hydrology_from_config(g, TConfig(cfg), device="cpu")
        assert type(tm).__name__ == type(jm).__name__ == cls
        check(tm.surface_input, jm.surface_input, 0.0, "surface input")
    with pytest.raises(ValueError):
        t_hyd.hydrology_from_config(g, TConfig({"hydrology.model": "x"}),
                                    device="cpu")
