"""The hysteresis sweep (``examples/hysteresis.py``), pism_tpu_torch against
pism_tpu at 100 km (17x17x21) in float64: its first two levels (0 and 8 K)
as the JAX example runs them, 2 a and then 4 a (level i advances by
t_i + years_per_level), each level a model of its own from the same
numpy state, with the bounds of ``tests/test_torch_hybrid_chain.py``:
step counts and dt-limit hits equal, the ice volume within 1e-9 relative,
H within 5e-7 of max H, the velocities within 5e-2 of max|u|; and the
sweep's records and gaps."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pism_tpu import state as JS
from pism_tpu_torch.convert import state_to_numpy
from pism_tpu_torch.examples import hysteresis

torch.set_num_threads(2)

SPY = 3.15569259747e7
KM, YEARS, DT_MAX = 100.0, 2.0, 8.0


def jax_setup(km):
    """The JAX example's grid, initial state and ``build_model``."""
    from pism_tpu import Config, Grid
    from pism_tpu.coupler import atmosphere as atm
    from pism_tpu.coupler.ocean import PIK
    from pism_tpu.coupler.ocean import DeltaT as OceanDeltaT
    from pism_tpu.coupler.pdd import TemperatureIndex
    from pism_tpu.model.icemodel import IceModel

    dx = km * 1e3
    L = 800e3
    M = int(2 * L / dx) + 1
    grid = Grid(Mx=M, My=M, Lx=L, Ly=L, Mz=21, Lz=4500.0)
    cfg = Config({
        "stress_balance.model": "ssa+sia", "energy.model": "none",
        "stress_balance.sia.flow_law": "isothermal_glen",
        "stress_balance.ssa.flow_law": "isothermal_glen",
        "basal_resistance.pseudo_plastic.enabled": True,
        "basal_yield_stress.model": "mohr_coulomb",
        "calving.methods": "thickness_calving,float_kill",
        "geometry.remove_icebergs": True,
        "runtime.float_dtype": "float64", "runtime.device_loop": True})
    X, Y = np.meshgrid(grid.x, grid.y)
    r = np.sqrt(X ** 2 + Y ** 2)
    bed = 500.0 - 1.3e-3 * r + 250.0 * np.sin(np.pi * r / 500e3)
    H = np.maximum(3200.0 * (1.0 - (r / 650e3) ** 2), 0.0) * (bed > -800.0)

    def build_model(dT):
        a = atm.DeltaT(
            inner=atm.ElevationChange(
                inner=atm.Uniform(temperature=252.15, temperature_july=263.15,
                                  precipitation=0.25 / SPY),
                reference_surface=jnp.zeros(grid.shape2), lapse_rate=8e-3),
            offset=lambda t, d=dT: d)
        return IceModel(grid=grid, config=cfg,
                        surface=TemperatureIndex(atmosphere=a, config=cfg),
                        ocean=OceanDeltaT(inner=PIK(config=cfg),
                                          offset=lambda t, d=dT: 0.25 * d))

    state = build_model(0.0).prepare_state(JS.ModelState(
        geometry=JS.new_geometry(jnp.asarray(H), jnp.asarray(bed))))
    return grid, state, build_model


def jax_to_numpy(st):
    d = {f.name: np.asarray(getattr(st.geometry, f.name))
         for f in dataclasses.fields(st.geometry)}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if f.name != "geometry" and v is not None:
            d[f.name] = np.asarray(v)
    return d


@pytest.fixture(scope="module")
def sweeps():
    tgrid, tstate, tbuild = hysteresis.setup(KM, "float64", "cpu")
    jgrid, jstate, jbuild = jax_setup(KM)
    up, dTs = hysteresis.levels(DT_MAX, 2)
    out = {"init": (state_to_numpy(tstate), jax_to_numpy(jstate)),
           "torch": [], "jax": []}
    for rec, s, t, stats in hysteresis.sweep(tgrid, tstate, tbuild, dTs[:2],
                                             len(up), YEARS):
        out["torch"].append((rec, state_to_numpy(s), t, stats))
    t = 0.0
    for dT in dTs[:2]:
        jstate, t, stats = jbuild(float(dT)).step_once(jstate, t,
                                                       t + YEARS * SPY)
        out["jax"].append((jax_to_numpy(jstate), float(t), stats))
    return out


def test_initial_states_equal(sweeps):
    a, b = sweeps["init"]
    assert sorted(a) == sorted(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("level", [0, 1])
def test_levels_match(sweeps, level):
    rec, b, tt, st = sweeps["torch"][level]
    a, tj, sj = sweeps["jax"][level]
    assert st.nsteps == int(sj.nsteps) > 0 and rec["steps"] == st.nsteps
    assert st.limit_hits_dict() == sj.limit_hits_dict()
    assert tt == pytest.approx(tj, abs=1e-6)
    vj, vt = a["ice_thickness"].sum(), b["ice_thickness"].sum()
    assert abs(vt - vj) <= 1e-9 * vj
    for name, tol in (("ice_thickness", 5e-7), ("snow_depth", 5e-7),
                      ("u_ssa", 5e-2), ("v_ssa", 5e-2)):
        assert np.all(np.isfinite(b[name]))
        assert np.abs(b[name] - a[name]).max() \
            <= tol * max(np.abs(a[name]).max(), 1e-300), name


def test_sweep_records(sweeps):
    recs = [r[0] for r in sweeps["torch"]]
    assert [r["dT"] for r in recs] == [0.0, 8.0]
    assert all(r["branch"] == "up" for r in recs)
    # the JAX example's level lengths: 2 a, then t + 2 a = 4 a
    assert sweeps["torch"][1][2] == pytest.approx(6.0 * SPY, abs=1e-6)
    g = hysteresis.gaps(recs + [dict(recs[0], branch="down",
                                     volume_1e6_km3=1.0)])
    assert g == {0.0: round(recs[0]["volume_1e6_km3"] - 1.0, 4)}
