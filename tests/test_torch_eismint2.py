"""EISMINT II experiment A, pism_tpu_torch against pism_tpu: the setups,
and the SIA-only thermomechanical chain from zero ice through
``IceModel.step_once``, 21x21x21 in float64 for 5000 model years (125
steps, 53 of them bound by the SIA diffusivity limit).

Both runs use the JAX setup's config with the bed smoother off
(``stress_balance.sia.bed_smoother.range = 0``, the port's path B): on the
flat bed it is the identity (checked below). On the CPU the JAX package
takes its plain SIA path; the port takes its plain path under ``auto`` and
the plain version of the fused kernel K3 under ``sia.pallas = on``.

Tolerances. Step counts and dt-limit hits are equal. H agrees to 1e-8 of
max H and the volume to 1e-9 relative: the SIA is a diffusion, so the
rounding differences of the two packages do not grow, unlike the hybrid
chain's SSA solve (measured: H within 5.2e-16 of max H, equal volumes,
enthalpy within 1.3e-15 relative). For the Paterson-Budd law K3's plain
version performs the plain path's operations in the same order, so it is
held to the same bounds.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu import state as JS  # noqa: E402
from pism_tpu.model.icemodel import IceModel as JIceModel  # noqa: E402
from pism_tpu.verification import eismint2 as j_e2  # noqa: E402
from pism_tpu_torch import setups  # noqa: E402
from pism_tpu_torch.convert import (state_from_numpy, state_to_numpy,  # noqa: E402
                                    surface_to_numpy)
from pism_tpu_torch.verification import eismint2 as t_e2  # noqa: E402

SPY = 3.15569259747e7
YEARS = 5000.0
MX = MZ = 21


def jax_to_numpy(st):
    d = {f.name: np.asarray(getattr(st.geometry, f.name))
         for f in dataclasses.fields(st.geometry)}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if f.name != "geometry" and v is not None:
            d[f.name] = np.asarray(v)
    return d


def _jax_model():
    es = j_e2.setup("A", Mx=MX, Mz=MZ, Lz=5000.0)
    es.config.update({"runtime.float_dtype": "float64",
                      **setups.EISMINT2_CFG})
    return JIceModel(grid=es.grid, config=es.config, surface=es.surface), es


@pytest.fixture(scope="module")
def runs():
    jm, es = _jax_model()
    d0 = jax_to_numpy(es.state)
    js, tj, sj = jm.step_once(es.state, 0.0, YEARS * SPY)
    out = {"jax": (jax_to_numpy(js), float(tj), sj)}
    for pallas in ("auto", "on"):
        tm, ts, _ = setups.eismint2_model(
            "float64", Mx=MX, Mz=MZ, device="cpu",
            extra_cfg={"stress_balance.sia.pallas": pallas})
        ts, tt, st = tm.step_once(state_from_numpy(d0, device="cpu"), 0.0,
                                  YEARS * SPY)
        out[pallas] = (state_to_numpy(ts), tt, st)
    return out


@pytest.mark.parametrize("experiment", ["A", "B", "C", "D", "F"])
def test_setups_equal(experiment):
    """Grid, config, initial state and climate (at t = 0 and on a nonzero
    geometry) of each ported experiment."""
    je = j_e2.setup(experiment, Mx=MX, Mz=MZ)
    te = t_e2.setup(experiment, Mx=MX, Mz=MZ, device="cpu")
    for name in ("x", "y", "z", "dx", "dy", "shape3"):
        np.testing.assert_array_equal(getattr(te.grid, name),
                                      getattr(je.grid, name))
    assert te.config.to_dict() == je.config.to_dict()
    assert te.geothermal == je.geothermal
    a, b = jax_to_numpy(je.state), state_to_numpy(te.state)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    H = np.asarray(je.grid.radius) * 1e-3
    for t, st in ((0.0, te.state), (1e10, te.state.replace(
            geometry=te.state.geometry.replace(
                ice_thickness=torch.as_tensor(H))))):
        jsmb, jT = je.surface.fn(JS.new_geometry(jnp.asarray(H),
                                                 jnp.zeros_like(H)), t)
        got = surface_to_numpy(te.surface, st, t)
        np.testing.assert_array_equal(got["smb"], np.asarray(jsmb))
        np.testing.assert_array_equal(got["temperature"], np.asarray(jT))


@pytest.mark.parametrize("experiment", ["E", "G", "H", "I", "J", "K", "L"])
def test_unported_experiments_raise(experiment):
    with pytest.raises(NotImplementedError):
        t_e2.setup(experiment, Mx=MX, Mz=MZ, device="cpu")


def test_expected_a_is_the_reference():
    assert t_e2.EXPECTED_A == j_e2.EXPECTED_A


@pytest.mark.parametrize("route", ["auto", "on"])
def test_steps_and_limit_hits_equal(runs, route):
    (_, tj, sj), (_, tt, st) = runs["jax"], runs[route]
    assert st.nsteps == int(sj.nsteps) > 0
    assert st.limit_hits_dict() == sj.limit_hits_dict()
    assert tt == tj == pytest.approx(YEARS * SPY, abs=1e-6)
    assert st.ssa_krylov_iters == 0 and st.ssa_newton_iters == 0


@pytest.mark.parametrize("route", ["auto", "on"])
def test_thickness_and_volume(runs, route):
    (a, _, _), (b, _, _) = runs["jax"], runs[route]
    Ha, Hb = a["ice_thickness"], b["ice_thickness"]
    assert np.all(np.isfinite(Hb)) and Ha.max() > 1000.0
    assert np.abs(Hb - Ha).max() <= 1e-8 * Ha.max()
    assert abs(Hb.sum() - Ha.sum()) <= 1e-9 * Ha.sum()
    Ea, Eb = a["enthalpy"], b["enthalpy"]
    assert np.abs(Eb - Ea).max() <= 1e-8 * np.abs(Ea).max()


def test_sliding_velocity_is_absent(runs):
    """The sia model carries no SSA velocity, as in the JAX package."""
    (a, _, _), (b, _, _) = runs["jax"], runs["auto"]
    assert "u_ssa" not in a and "u_ssa" not in b
    assert "tillwat" not in a and "tillwat" not in b


def test_bed_smoother_is_identity_on_the_flat_bed():
    """The JAX setup's 5 km bed smoother and range 0 give the same run."""
    out = []
    for rng in (5.0e3, 0.0):
        tm, ts, _ = setups.eismint2_model(
            "float64", Mx=MX, Mz=MZ, device="cpu",
            extra_cfg={"stress_balance.sia.bed_smoother.range": rng})
        ts, _, st = tm.step_once(ts, 0.0, 500.0 * SPY)
        out.append((state_to_numpy(ts)["ice_thickness"], st.nsteps))
    assert out[0][1] == out[1][1]
    np.testing.assert_array_equal(out[0][0], out[1][0])
