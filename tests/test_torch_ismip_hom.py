"""The Blatter-Pattyn solver's verification problems and its composite
model, pism_tpu_torch against pism_tpu on the CPU in float64:

- the XZ problems (``verification/blatter_xz.py``) at the JAX tests'
  grids: the errors within 1e-6 relative of the JAX package's at 17 x 9
  and 49 x 13, and the JAX tests' bounds on the refinement (33 x 17,
  49 x 25);
- ``stress_balance.model = blatter`` in ``IceModel`` on the JAX test's
  Mohr-Coulomb dome with enthalpy (16 x 16 x 11, 60 a) through both
  packages: equal steps and dt-limit hits, the volume within 1e-8. The
  initial enthalpies tied at the melting point are moved 1 J/kg below it
  first: the JAX package decides those ties at random under ``jit``
  (ROADMAP "Reference quirks"; with the ties its jitted step's enthalpy
  differs from its own eager step's by 3%);
- ISMIP-HOM A and C at 20 x 20 x 8, L = 5 and 160 km, through the port's
  ``examples/ismip_hom.py`` against the JAX example's ``run_one``: equal
  records and Newton sweeps, the surface transect within 1e-6 relative.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pism_tpu.verification import blatter_xz as j_xz

from pism_tpu_torch.examples import ismip_hom as t_ismip
from pism_tpu_torch.verification import blatter_xz as t_xz

SPY = 3.15569259747e7
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def port_xz():
    """The port's XZ solves at the JAX tests' four grids, once for the
    file: {(fn, Mx, Mz): (error, scale, info)}."""
    out = {}
    for fn, Mx, Mz in (("solve_xz", 17, 9), ("solve_xz", 33, 17),
                       ("solve_xz_cfbc", 49, 13), ("solve_xz_cfbc", 49, 25)):
        info = {}
        e, sc = getattr(t_xz, fn)(Mx, Mz, device="cpu", info=info)
        out[fn, Mx, Mz] = (e, sc, info)
    return out


@pytest.mark.parametrize("fn,Mx,Mz", [("solve_xz", 17, 9),
                                      ("solve_xz_cfbc", 49, 13)])
def test_xz_errors_match(port_xz, fn, Mx, Mz):
    ej, sj = getattr(j_xz, fn)(Mx, Mz)
    et, st, info = port_xz[fn, Mx, Mz]
    assert st == sj
    assert abs(et - ej) <= 1e-6 * ej
    assert info["newton_iters"] >= 1


def test_xz_refinement_bounds(port_xz):
    """The JAX tests' bounds (``tests/test_blatter.py``) on the port."""
    (e1, scale, _), (e2, _, _) = (port_xz["solve_xz", 17, 9],
                                  port_xz["solve_xz", 33, 17])
    assert e1 / scale < 0.05 and e2 < 0.35 * e1
    c1, c2 = (port_xz["solve_xz_cfbc", 49, Mz][0] for Mz in (13, 25))
    assert c1 < 0.06 and c2 < 0.35 * c1


def _untie(state, model):
    """Enthalpies at the melting point moved 1 J/kg below it."""
    E, EC = state.enthalpy, model.EC
    z = torch.as_tensor(model.grid.z, dtype=E.dtype)
    Es = EC.enthalpy_cts(EC.pressure(torch.clamp(
        state.geometry.ice_thickness[..., None] - z, min=0.0)))
    tie = (E - Es).abs() <= 1e-9 * Es.abs()
    return state.replace(enthalpy=torch.where(tie, E - 1.0, E)), \
        int(tie.sum())


def test_blatter_composite_dome_matches():
    from pism_tpu import Config as JConfig, Grid as JGrid, Time as JTime
    from pism_tpu.coupler.surface import Uniform as JUniform
    from pism_tpu.model.icemodel import IceModel as JIceModel
    from pism_tpu.state import ModelState as JState, new_geometry as j_geom

    import pism_tpu_torch as pt
    from pism_tpu_torch.coupler.surface import Uniform
    from pism_tpu_torch.model.blatter import BlatterSolver
    from pism_tpu_torch.model.icemodel import IceModel
    from pism_tpu_torch.state import ModelState, new_geometry

    over = {"stress_balance.model": "blatter", "energy.model": "enthalpy",
            "basal_yield_stress.model": "mohr_coulomb",
            "hydrology.model": "null", "time_stepping.maximum_time_step": 20.0}
    kw = dict(Mx=16, My=16, Lx=300e3, Ly=300e3, Mz=11, Lz=3000.0)
    gj, gt = JGrid(**kw), pt.Grid(**kw)
    r = np.asarray(gj.radius)
    H = 2500.0 * np.maximum(1.0 - (r / 280e3) ** 2, 0.0)
    mt = IceModel(grid=gt, config=pt.Config(over), device="cpu",
                  surface=Uniform(smb=0.3 / SPY, temperature=253.15))
    assert isinstance(mt.blatter, BlatterSolver) and mt.ssa is None
    st = mt.prepare_state(ModelState(geometry=new_geometry(
        torch.as_tensor(H), torch.zeros(gt.shape2, dtype=torch.float64))))
    st, n_ties = _untie(st, mt)
    assert n_ties > 0
    mj = JIceModel(grid=gj, config=JConfig(over),
                   surface=JUniform(smb=0.3 / SPY, temperature=253.15))
    sj = mj.prepare_state(JState(geometry=j_geom(jnp.asarray(H),
                                                 jnp.zeros(gj.shape2))))
    sj = sj.replace(enthalpy=jnp.asarray(st.enthalpy.numpy()))
    sj, stj = mj.run(sj, JTime(0.0, 60.0 * SPY))
    st, stt = mt.run(st, pt.Time(0.0, 60.0 * SPY))
    assert stt.nsteps == int(stj.nsteps) >= 3
    assert stt.limit_hits_dict() == stj.limit_hits_dict()
    vj = float(jnp.sum(sj.geometry.ice_thickness))
    vt = float(st.geometry.ice_thickness.sum())
    assert abs(vt - vj) <= 1e-8 * vj
    H1 = st.geometry.ice_thickness.numpy()
    assert np.isfinite(H1).all() and vt > float(np.sum(H))
    speed = np.hypot(st.u_ssa.numpy(), st.v_ssa.numpy()) * SPY
    assert 1.0 < speed.max() < 2000.0
    assert stt.ssa_newton_iters > 0 and stt.ssa_krylov_iters > 0


@pytest.fixture(scope="module")
def jax_example():
    """The JAX package's ``examples/ismip_hom.py`` as a module whose
    ``run_one`` returns its numbers unrounded (its ``round`` shadowed)."""
    spec = importlib.util.spec_from_file_location(
        "jax_ismip_hom_example", ROOT / "examples" / "ismip_hom.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.round = lambda x, ndigits=None: x
    return mod


@pytest.mark.parametrize("exp,L", [("A", 5.0), ("A", 160.0), ("C", 5.0),
                                   ("C", 160.0)])
def test_ismip_hom_matches_jax_example(jax_example, exp, L):
    raw = jax_example.run_one(exp, L, 20, 8)
    rt = t_ismip.run_one(exp, L, 20, 8, device="cpu", raw=True)
    digits = {"umin": 2, "umax": 2, "umean": 2, "max_over_sia": 3}
    assert {k: v for k, v in rt.items()
            if k not in ("krylov_iters", "seconds", "_us", "_u")} \
        == {k: round(v, digits[k]) if k in digits else v
            for k, v in raw.items()}
    us = rt["_us"]
    for k, got in (("umin", us.min()), ("umax", us.max()),
                   ("umean", us.mean())):
        assert abs(got - raw[k]) <= 1e-6 * abs(raw[k]), k
    assert rt["krylov_iters"] > 0
