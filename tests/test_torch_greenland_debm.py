"""The Greenland dEBM chain (``examples/greenland_debm.py``), pism_tpu_torch
against pism_tpu at 100 km (16x29x41) in float64, two model years through
``IceModel.step_once`` from one numpy state, and the same chain from the
same state to mid-July of the second year (1.55 a), where the stored
albedo is a summer one and the melt-albedo feedback shows in it (at 2 a
it is winter's albedo_max everywhere). After each run, the bounds that
``tests/test_torch_hybrid_chain.py`` holds the PDD chain to: step counts
and dt-limit hits equal, the ice volume within 1e-9 relative, H, the
part-grid fields, the enthalpy, the till water, the snow depth and the
albedo within 5e-7 of their maxima, the last solve's velocities within
5e-2 of max|u|; and the example's summer summary equal. As there, the
enthalpies that the bootstrap puts exactly at the pressure-melting value
are moved 1 J/kg below it first (the JAX package's jitted energy step
decides those ties at random).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pism_tpu import state as JS
from pism_tpu_torch.convert import state_from_numpy, state_to_numpy
from pism_tpu_torch.examples import greenland_debm

torch.set_num_threads(2)

SPY = 3.15569259747e7
YEARS = 2.0
#: the second run's end [a]: mid-July of the second year
SUMMER = 1.55
KM = 100.0


def jax_model(km, warming=0.0, paleo=False):
    """The JAX example's chain (``examples/greenland_debm.py``, float64)."""
    from pism_tpu import Config, Grid
    from pism_tpu.coupler import atmosphere as atm
    from pism_tpu.coupler.debm import DEBMSimple
    from pism_tpu.coupler.ocean import Constant as OceanConstant
    from pism_tpu.model.icemodel import IceModel

    dx = km * 1e3
    Lx, Ly = 750e3, 1400e3
    grid = Grid(Mx=int(2 * Lx / dx) + 1, My=int(2 * Ly / dx) + 1, Lx=Lx,
                Ly=Ly, Mz=41, Lz=4000.0)
    cfg = Config({
        "stress_balance.model": "ssa+sia", "energy.model": "enthalpy",
        "basal_resistance.pseudo_plastic.enabled": True,
        "basal_resistance.pseudo_plastic.q": 0.25,
        "basal_yield_stress.model": "mohr_coulomb",
        "calving.methods": "thickness_calving",
        "calving.thickness_calving.threshold": 50.0,
        "geometry.remove_icebergs": True,
        "geometry.part_grid.enabled": True,
        "time_stepping.skip.enabled": True, "time_stepping.skip.max": 10,
        "runtime.float_dtype": "float64", "runtime.device_loop": True,
        "surface.debm_simple.paleo.enabled": bool(paleo)})
    X, Y = np.meshgrid(grid.x, grid.y)
    lat = 60.0 + (Y + Ly) / (2 * Ly) * 23.0
    lon = -42.0 + X / Lx * 10.0
    precip = np.clip(0.6 - 0.25 * (lat - 60.0) / 23.0, 0.05, None) / SPY
    a = atm.SeariseGreenland(latitude=jnp.asarray(lat),
                             longitude=jnp.asarray(lon),
                             precipitation=jnp.asarray(precip))
    if warming:
        a = atm.DeltaT(inner=a, offset=lambda t: warming)
    surface = DEBMSimple(atmosphere=a, latitude=jnp.asarray(lat), config=cfg)
    return IceModel(grid=grid, config=cfg, surface=surface,
                    ocean=OceanConstant(config=cfg))


def jax_to_numpy(st):
    d = {f.name: np.asarray(getattr(st.geometry, f.name))
         for f in dataclasses.fields(st.geometry)}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if f.name != "geometry" and v is not None:
            d[f.name] = np.asarray(v)
    return d


def numpy_to_jax(d):
    names = {f.name for f in dataclasses.fields(JS.Geometry)}
    geom = JS.Geometry(**{k: jnp.asarray(d[k]) for k in names})
    return JS.ModelState(geometry=geom, **{
        k: jnp.asarray(v) for k, v in d.items() if k not in names})


def break_pressure_melting_ties(d, grid, EC):
    """Move enthalpies that sit exactly at E_s(p) 1 J/kg below it."""
    H = torch.tensor(d["ice_thickness"])
    z = torch.as_tensor(grid.z)
    Es = EC.enthalpy_cts(EC.pressure(torch.clamp(H[..., None] - z, min=0.0)))
    E = d["enthalpy"]
    tie = np.abs(E - Es.numpy()) <= 1e-9 * np.abs(Es.numpy())
    return dict(d, enthalpy=np.where(tie, E - 1.0, E))


@pytest.fixture(scope="module")
def chain():
    tm, ts, grid = greenland_debm.greenland_debm_model("float64", KM,
                                                       device="cpu")
    jm = jax_model(KM)
    d0 = state_to_numpy(ts)
    js0 = jm.prepare_state(JS.ModelState(geometry=JS.new_geometry(
        jnp.asarray(d0["ice_thickness"]), jnp.asarray(d0["bed_elevation"]))))
    d0_jax = jax_to_numpy(js0)
    d = break_pressure_melting_ties(d0_jax, grid, tm.EC)
    out = dict(d0_jax=d0_jax, d0_torch=d0, model=tm, jax_model=jm)
    for run, years in (("summer", SUMMER), ("end", YEARS)):
        js, tj, sj = jm.step_once(numpy_to_jax(d), 0.0, years * SPY)
        ts, tt, st = tm.step_once(state_from_numpy(d, device="cpu"), 0.0,
                                  years * SPY)
        out[run] = dict(jax=(jax_to_numpy(js), float(tj), sj),
                        torch=(state_to_numpy(ts), tt, st), state=ts,
                        jax_state=js)
    return out


def jax_summer_albedo(surface, state, t):
    """The JAX example's summer albedo and melt (``examples/greenland_debm.py``
    ``main``): the feedback at the next mid-July instant after ``t``."""
    t_summer = (np.floor(t / SPY) + 0.55) * SPY
    atm_in = surface.atmosphere(state.geometry, t_summer)
    frac = t_summer / SPY - np.floor(t_summer / SPY)
    T = atm_in.temperature + (atm_in.temperature_july - atm_in.temperature) \
        * np.cos(2.0 * np.pi * (frac - 0.5))
    M = surface.melt_components(t_summer, T,
                                state.geometry.ice_surface_elevation,
                                state.surface_albedo)[3]
    alb = None
    for _ in range(3):
        alb = surface.albedo_from_melt(M)
        M = surface.melt_components(t_summer, T,
                                    state.geometry.ice_surface_elevation,
                                    alb)[3]
    return np.asarray(alb), np.asarray(M)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def test_initial_states_equal(chain):
    a, b = chain["d0_jax"], chain["d0_torch"]
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert np.all(b["surface_albedo"] == 0.82)


def test_step_counts_and_limit_hits_equal(chain):
    for run, t_end in (("summer", SUMMER), ("end", YEARS)):
        (_, tj, sj), (_, tt, st) = chain[run]["jax"], chain[run]["torch"]
        assert st.nsteps == int(sj.nsteps) > 0, run
        assert st.limit_hits_dict() == sj.limit_hits_dict(), run
        assert tt == pytest.approx(t_end * SPY, abs=1e-6) and tt == tj, run


def test_ice_volume(chain):
    for run in ("summer", "end"):
        (a, _, sj), (b, _, st) = chain[run]["jax"], chain[run]["torch"]
        vj, vt = a["ice_thickness"].sum(), b["ice_thickness"].sum()
        assert abs(vt - vj) <= 1e-9 * vj, run
        assert float(st.sum_smb) == pytest.approx(float(sj.sum_smb),
                                                  rel=1e-6), run


@pytest.mark.parametrize("field,tol", [
    ("ice_thickness", 5e-7), ("ice_area_specific_volume", 5e-7),
    ("enthalpy", 5e-7), ("tillwat", 5e-7), ("snow_depth", 5e-7),
    ("surface_albedo", 5e-7), ("u_ssa", 5e-2), ("v_ssa", 5e-2),
])
def test_fields_agree(chain, field, tol):
    (a, _, _), (b, _, _) = chain["end"]["jax"], chain["end"]["torch"]
    assert np.all(np.isfinite(b[field]))
    if np.abs(a[field]).max() == 0.0:
        assert np.abs(b[field]).max() == 0.0
    else:
        assert _rel(b[field], a[field]) <= tol


@pytest.mark.parametrize("field,tol", [
    ("ice_thickness", 5e-7), ("enthalpy", 5e-7), ("snow_depth", 5e-7),
    ("surface_albedo", 5e-7), ("u_ssa", 5e-2), ("v_ssa", 5e-2),
])
def test_summer_fields_agree(chain, field, tol):
    (a, _, _), (b, _, _) = chain["summer"]["jax"], chain["summer"]["torch"]
    assert np.all(np.isfinite(b[field]))
    assert _rel(b[field], a[field]) <= tol


def test_summer_albedo_feedback(chain):
    """At mid-July the stored albedo has come down from albedo_max where
    the ice melts, the same cells in both packages."""
    (a, _, _), (b, _, _) = chain["summer"]["jax"], chain["summer"]["torch"]
    below_j, below_t = a["surface_albedo"] < 0.82, b["surface_albedo"] < 0.82
    assert below_t.sum() > 0
    np.testing.assert_array_equal(below_t, below_j)
    assert b["surface_albedo"].min() == pytest.approx(
        a["surface_albedo"].min(), abs=5e-7 * 0.82)


def test_albedo_bounds_and_summary(chain):
    (b, _, _) = chain["end"]["torch"]
    alb = b["surface_albedo"]
    assert alb.min() >= 0.47 and alb.max() <= 0.82
    s = greenland_debm.summary(chain["model"], chain["end"]["state"],
                               YEARS * SPY)
    assert not s["nan"] and 0.47 <= s["summer_albedo_min"] <= 0.82
    assert s["summer_melt_max_m_a"] > 0.0


@pytest.mark.parametrize("run", ["summer", "end"])
def test_summary_matches_jax(chain, run):
    """The example's summer fields (the feedback evaluated at the next
    mid-July from the stored albedo) against the JAX example's on the JAX
    state: the summer albedo and melt over the ice within 5e-7 of their
    maxima."""
    run = chain[run]
    t = run["torch"][1]
    alb_t, M_t = greenland_debm.summer_albedo(chain["model"].surface,
                                              run["state"], t)
    alb_j, M_j = jax_summer_albedo(chain["jax_model"].surface,
                                   run["jax_state"], t)
    ice = run["jax"][0]["ice_thickness"] > 1.0
    alb_t, M_t = alb_t.numpy()[ice], M_t.numpy()[ice]
    alb_j, M_j = alb_j[ice], M_j[ice]
    assert alb_j.min() < 0.82 and M_j.max() > 0.0
    assert _rel(alb_t, alb_j) <= 5e-7
    assert _rel(M_t, M_j) <= 5e-7
