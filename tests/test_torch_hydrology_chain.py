"""The hybrid chain with routed water: pism_tpu_torch against pism_tpu on
the 100 km synthetic-Greenland chain in float64 with
``hydrology.model = routing``, the PDD's runoff as the water input, a
till saturated under the grounded ice and ``add_transportable_water``,
two model years through ``IceModel.step_once``.

Both packages build the chain (``bench.hybrid_greenland_model`` with the
hydrology keys, ``setups.hybrid_greenland_model(..., hydrology=
"routing")``) and run it from one numpy state, the enthalpy ties broken as
``tests/test_torch_hybrid_chain.py`` breaks them. Held as that chain is:
steps and dt-limit hits equal; the ice volume and the total subglacial
water (till + routed) within 2e-4 relative (the envelope of
``docs/VALIDATION.md:807-812``); the routed water non-zero.
"""

import numpy as np
import pytest
import torch

from test_torch_hybrid_chain import (bench, break_pressure_melting_ties,
                                     jax_to_numpy, numpy_to_jax)

from pism_tpu_torch import setups
from pism_tpu_torch.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

SPY = 3.15569259747e7
YEARS = 2.0
HYDRO = {"hydrology.model": "routing",
         "hydrology.surface_input_from_runoff": True,
         "basal_yield_stress.add_transportable_water": True}


@pytest.fixture(scope="module")
def chain():
    tm, ts, grid = setups.hybrid_greenland_model(
        "float64", km=100, device="cpu", hydrology="routing")
    jm, js, _ = bench.hybrid_greenland_model("float64", km=100,
                                             extra_cfg=HYDRO)
    d0 = jax_to_numpy(js)
    # the setup's saturated till
    d0["tillwat"] = state_to_numpy(ts)["tillwat"]
    d, _ = break_pressure_melting_ties(d0, grid, tm.EC)
    js, tj, sj = jm.step_once(numpy_to_jax(d), 0.0, YEARS * SPY)
    t_init = state_to_numpy(ts)
    ts, tt, st = tm.step_once(state_from_numpy(d, device="cpu"), 0.0,
                              YEARS * SPY)
    return dict(d0=d0, t_init=t_init, jax=(jax_to_numpy(js), float(tj), sj),
                torch=(state_to_numpy(ts), tt, st), cfg=tm.config)


def test_same_configuration_and_initial_state(chain):
    for k, v in HYDRO.items():
        assert chain["cfg"]._get(k) == v
    a, b = chain["d0"], chain["t_init"]
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_steps_and_limit_hits_equal(chain):
    (_, tj, sj), (_, tt, st) = chain["jax"], chain["torch"]
    assert st.nsteps == int(sj.nsteps) > 0
    assert st.limit_hits_dict() == sj.limit_hits_dict()
    assert tt == tj


def test_volume_and_water(chain):
    (a, _, _), (b, _, _) = chain["jax"], chain["torch"]
    vj, vt = a["ice_thickness"].sum(), b["ice_thickness"].sum()
    assert abs(vt - vj) <= 2e-4 * vj
    wj = (a["tillwat"] + a["hydro_W"]).sum()
    wt = (b["tillwat"] + b["hydro_W"]).sum()
    assert abs(wt - wj) <= 2e-4 * wj
    assert b["hydro_W"].max() > 0.0 and np.isfinite(b["hydro_W"]).all()
