"""Ice age (``model/age.py``) and the age-coupled SIA enhancement
(``stress_balance.sia.e_age_coupling``): ``pism_tpu_torch`` against
``pism_tpu`` on the CPU, the same numpy inputs (seeded) to both.

The cases of the JAX package's own tests (``tests/test_age_btu.py``'s age
cases; ``tests/test_round4_params.py::test_enhancement_field_matches_scalar``
and ``::test_e_age_coupling_in_stress_balance``) run on the port with
their assertions, and each result is held to the JAX twin's: within 1e-12
relative in float64. One age step from a random state with random 3D
velocities, within 1e-12 in float64 and within float32 rounding (2e-6 of
the field's max: a few ulps of the solve's 2 Mz steps) in float32. The
enhancement field the stress balance forms from the age equals JAX's, and
a field enhancement takes the plain flux path even under
``stress_balance.sia.pallas = on``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu import Config as JConfig, Grid as JGrid  # noqa: E402
from pism_tpu.model.age import AgeModel as JAgeModel  # noqa: E402
from pism_tpu.model.stressbalance import StressBalance as JSB  # noqa: E402
from pism_tpu.ops import sia as j_sia  # noqa: E402
from pism_tpu.ops.sia3d import SIA3D as JSIA3D  # noqa: E402
from pism_tpu.ops.stencils import Shifter as JShifter  # noqa: E402
from pism_tpu.physics.enthalpy_converter import (  # noqa: E402
    EnthalpyConverter as JEC)
from pism_tpu.physics.rheology import PatersonBudd as JPB  # noqa: E402
from pism_tpu.state import ModelState as JState  # noqa: E402
from pism_tpu.state import new_geometry as j_new_geometry  # noqa: E402
import pism_tpu_torch as pt  # noqa: E402
from pism_tpu_torch.model.age import AgeModel  # noqa: E402
from pism_tpu_torch.model.stressbalance import StressBalance  # noqa: E402
from pism_tpu_torch.ops import sia as t_sia  # noqa: E402
from pism_tpu_torch.ops.kernels import sia_thermo as K3  # noqa: E402
from pism_tpu_torch.ops.sia3d import SIA3D  # noqa: E402
from pism_tpu_torch.ops.stencils import Shifter  # noqa: E402
from pism_tpu_torch.physics.enthalpy_converter import (  # noqa: E402
    EnthalpyConverter)
from pism_tpu_torch.physics.rheology import PatersonBudd  # noqa: E402
from pism_tpu_torch.state import ModelState, new_geometry  # noqa: E402

SPY = 3.15569259747e7


def _rel(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _sia3(u, v, w, pkg):
    """SIA3D of numpy fields for the JAX package ("jax") or the port."""
    if pkg == "jax":
        z = jnp.zeros(u.shape)
        return JSIA3D(u=jnp.asarray(u), v=jnp.asarray(v), w=jnp.asarray(w),
                      strain_heating=z, max_u=jnp.zeros(()),
                      max_v=jnp.zeros(()))
    z = torch.zeros(u.shape, dtype=torch.float64)
    return SIA3D(u=torch.as_tensor(u), v=torch.as_tensor(v),
                 w=torch.as_tensor(w), strain_heating=z,
                 max_u=torch.zeros(()), max_v=torch.zeros(()))


def _models(grid_kw):
    jg, tg = JGrid(**grid_kw), pt.Grid(**grid_kw)
    return (jg, JAgeModel(grid=jg, config=JConfig({"age.enabled": True})),
            tg, AgeModel(grid=tg, config=pt.Config({"age.enabled": True})))


def test_age_grows_without_flow():
    kw = dict(Mx=5, My=5, Lx=50e3, Ly=50e3, Mz=11, Lz=2000.0,
              vertical_spacing="equal")
    jg, jam, tg, am = _models(kw)
    H = np.full(jg.shape2, 1500.0)
    z3 = np.zeros(jg.shape3)
    jstate = JState(geometry=j_new_geometry(jnp.asarray(H),
                                            jnp.zeros(jg.shape2)),
                    age=jnp.zeros(jg.shape3))
    state = ModelState(geometry=new_geometry(torch.as_tensor(H),
                                             torch.zeros(tg.shape2,
                                                         dtype=torch.float64)),
                       age=torch.zeros(tg.shape3, dtype=torch.float64))
    dt = 100.0 * SPY
    A, jA = state.age, jstate.age
    for _ in range(5):
        A = am.step(state.replace(age=A), _sia3(z3, z3, z3, "torch"), dt)
        jA = jam.step(jstate.replace(age=jA), _sia3(z3, z3, z3, "jax"), dt)
    # within the ice, age advanced by 500 years exactly (dA/dt = 1)
    assert float(A[2, 2, 0]) == pytest.approx(500 * SPY, rel=1e-10)
    assert float(A[2, 2, -1]) == 0.0           # above the surface: zero
    assert _rel(A, jA) <= 1e-12


def test_age_downward_advection_limits_surface_age():
    """With downward w (accumulation) the steady age at depth is finite and
    grows toward the base; 200 steps, the port's profile against JAX's."""
    kw = dict(Mx=5, My=5, Lx=50e3, Ly=50e3, Mz=21, Lz=2000.0,
              vertical_spacing="equal")
    jg, jam, tg, am = _models(kw)
    H = np.full(jg.shape2, 1850.0)
    z3 = np.zeros(jg.shape3)
    w = np.full(jg.shape3, -0.3 / SPY)        # 0.3 m/a downward
    jstate = JState(geometry=j_new_geometry(jnp.asarray(H),
                                            jnp.zeros(jg.shape2)),
                    age=jnp.zeros(jg.shape3))
    state = ModelState(geometry=new_geometry(torch.as_tensor(H),
                                             torch.zeros(tg.shape2,
                                                         dtype=torch.float64)),
                       age=torch.zeros(tg.shape3, dtype=torch.float64))
    jsia3, sia3 = _sia3(z3, z3, w, "jax"), _sia3(z3, z3, w, "torch")
    jstep = jax.jit(lambda A: jam.step(jstate.replace(age=A), jsia3,
                                       200.0 * SPY))
    A, jA = state.age, jstate.age
    for _ in range(200):
        A = am.step(state.replace(age=A), sia3, 200.0 * SPY)
        jA = jstep(jA)
    prof = A.numpy()[2, 2] / SPY
    assert prof[-1] == 0.0                     # above the surface: no ice
    assert np.all(np.diff(prof[:19]) <= 1e-6)  # older downward within ice
    assert 2000 < prof[10] < 4500              # ~ depth / |w|
    assert _rel(A, jA) <= 1e-12


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 2e-6)])
def test_age_step_matches(dtype, tol):
    """One step from a random age on a dome with an ice-free margin and a
    floating edge, under random 3D velocities of both signs."""
    kw = dict(Mx=23, My=19, Lx=220e3, Ly=180e3, Mz=15, Lz=3000.0)
    jg, jam, tg, am = _models(kw)
    rng = np.random.default_rng(7)
    X, Y = np.meshgrid(np.asarray(jg.x), np.asarray(jg.y))
    H = 2600.0 * np.maximum(1.0 - (X / 200e3) ** 2 - (Y / 160e3) ** 2,
                            0.0) ** 0.5
    bed = np.where(X > 150e3, -800.0, 100.0)
    A0 = rng.uniform(0.0, 2e4, jg.shape3) * SPY
    u, v = (rng.standard_normal(jg.shape3) * 50.0 / SPY for _ in range(2))
    w = rng.standard_normal(jg.shape3) * 0.3 / SPY
    c = lambda a: a.astype(dtype)                      # noqa: E731
    jstate = JState(geometry=j_new_geometry(jnp.asarray(c(H)),
                                            jnp.asarray(c(bed))),
                    age=jnp.asarray(c(A0)))
    state = ModelState(geometry=new_geometry(torch.as_tensor(c(H)),
                                             torch.as_tensor(c(bed))),
                       age=torch.as_tensor(c(A0)))
    jsia3 = JSIA3D(*(jnp.asarray(c(x)) for x in (u, v, w, 0 * u)),
                   max_u=jnp.zeros(()), max_v=jnp.zeros(()))
    sia3 = SIA3D(*(torch.as_tensor(c(x)) for x in (u, v, w, 0 * u)),
                 max_u=torch.zeros(()), max_v=torch.zeros(()))
    dt = 0.7 * SPY
    dt_f = float(np.asarray(dt, dtype))
    want = jam.step(jstate, jsia3, jnp.asarray(dt_f, dtype))
    got = am.step(state, sia3, dt_f)
    assert got.dtype == torch.float32 if dtype == np.float32 \
        else got.dtype == torch.float64
    assert _rel(got, want) <= tol
    assert float(got.min()) >= 0.0


# --------------------------------------------- the age-coupled enhancement
def _dome_sia(Mz=11):
    grid_kw = dict(Mx=21, My=21, Lx=200e3, Ly=200e3, Mz=Mz, Lz=3000.0)
    x = np.asarray(JGrid(**grid_kw).x) / 200e3
    H = 2500.0 * np.maximum(1.0 - x[None, :] ** 2 - x[:, None] ** 2, 0.0)
    return grid_kw, H


def _diffusivity_max(enhancement, pkg):
    grid_kw, H = _dome_sia()
    if pkg == "jax":
        cfg = JConfig({"grid.Mz": 11})
        grid = JGrid(**grid_kw)
        law = JPB(EC=JEC.from_config(cfg))
        geom = j_new_geometry(jnp.asarray(H), jnp.zeros(grid.shape2))
        E3 = jnp.full(grid.shape3, 9.0e4)
        e = enhancement if np.ndim(enhancement) == 0 \
            else jnp.asarray(enhancement)
        return float(j_sia.diffusivity(law, geom, E3, grid, JShifter(grid),
                                       enhancement=e).max_D)
    cfg = pt.Config({"grid.Mz": 11})
    grid = pt.Grid(**grid_kw)
    law = PatersonBudd(EC=EnthalpyConverter.from_config(cfg))
    geom = new_geometry(torch.as_tensor(H), torch.zeros(grid.shape2,
                                                        dtype=torch.float64))
    E3 = torch.full(grid.shape3, 9.0e4, dtype=torch.float64)
    e = enhancement if np.ndim(enhancement) == 0 \
        else torch.as_tensor(enhancement)
    return float(t_sia.diffusivity(law, geom, E3, grid, Shifter(grid),
                                   enhancement=e).max_D)


def test_enhancement_field_matches_scalar():
    """A spatially constant 3D enhancement reproduces the scalar path."""
    grid3 = (21, 21, 11)
    d_scalar = _diffusivity_max(3.0, "torch")
    d_field = _diffusivity_max(np.full(grid3, 3.0), "torch")
    assert d_field == pytest.approx(d_scalar, rel=1e-12)
    d6 = _diffusivity_max(np.full(grid3, 6.0), "torch")
    assert d6 > 1.5 * d_scalar
    assert d_field == pytest.approx(_diffusivity_max(np.full(grid3, 3.0),
                                                     "jax"), rel=1e-12)
    # a varying field, averaged onto the faces
    e = 1.0 + np.random.default_rng(3).uniform(0.0, 4.0, grid3)
    assert _diffusivity_max(e, "torch") == pytest.approx(
        _diffusivity_max(e, "jax"), rel=1e-12)


def _coupling(pkg, dtype=np.float64):
    Mz = 11
    over = {"grid.Mz": Mz, "age.enabled": True,
            "stress_balance.sia.e_age_coupling": True,
            "stress_balance.sia.enhancement_factor_interglacial": 8.0}
    grid_kw, H = _dome_sia(Mz)
    rng = np.random.default_rng(11)
    # ages straddling every bound of the coupling at t = 2 ka: Holocene,
    # glacial, Eemian
    age = rng.choice([100.0, 13.0e3, 13.8e3, 80.0e3, 120.0e3, 140.0e3],
                     size=(21, 21, Mz)) * SPY
    H, age = H.astype(dtype), age.astype(dtype)
    if pkg == "jax":
        cfg, grid = JConfig(over), JGrid(**grid_kw)
        sb = JSB(grid=grid, config=cfg, sia_flow_law=JPB(
            EC=JEC.from_config(cfg)), model="sia", compute_3d=False)
        state = JState(geometry=j_new_geometry(jnp.asarray(H),
                                               jnp.zeros(grid.shape2, dtype)),
                       enthalpy=jnp.full(grid.shape3, 9.0e4, dtype),
                       age=jnp.asarray(age))
        return sb, state
    cfg, grid = pt.Config(dict(over, **{"stress_balance.model": "sia"})), \
        pt.Grid(**grid_kw)
    sb = StressBalance(grid=grid, config=cfg, sia_flow_law=PatersonBudd(
        EC=EnthalpyConverter.from_config(cfg)), compute_3d=False)
    state = ModelState(
        geometry=new_geometry(torch.as_tensor(H),
                              torch.zeros(grid.shape2,
                                          dtype=torch.as_tensor(H).dtype)),
        enthalpy=torch.full(grid.shape3, 9.0e4,
                            dtype=torch.as_tensor(H).dtype),
        age=torch.as_tensor(age))
    return sb, state


def test_e_age_coupling_in_stress_balance():
    """Holocene-deposited ice flows with enhancement_factor_interglacial
    (softer: a larger diffusivity); the port's result against JAX's."""
    sb, state = _coupling("torch")
    sb = StressBalance(grid=sb.grid, config=sb.config,
                       sia_flow_law=sb.sia_flow_law, compute_3d=False)
    state = state.replace(age=torch.full_like(state.age, 100.0 * SPY))
    t = 2000.0 * SPY   # deposited at +1,900 a: Holocene
    d_soft = float(sb.update(state, None, t=t).max_diffusivity)
    t_old = -50.0e3 * SPY  # deposited at -50 ka: glacial, e = e_sia
    d_hard = float(sb.update(state, None, t=t_old).max_diffusivity)
    assert d_soft == pytest.approx(8.0 * d_hard, rel=1e-5)
    jsb, jstate = _coupling("jax")
    jstate = jstate.replace(age=jnp.full(jstate.age.shape, 100.0 * SPY))
    assert d_soft == pytest.approx(float(jsb.update(jstate, t=t)
                                         .max_diffusivity), rel=1e-12)
    assert d_hard == pytest.approx(float(jsb.update(jstate, t=t_old)
                                         .max_diffusivity), rel=1e-12)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_age_enhancement_field_and_flux_match(dtype):
    """The enhancement field (t - age in float64 against the Eemian and
    Holocene bounds) equals JAX's, and the SIA flux from it agrees: 1e-12
    in float64, float32 rounding (1e-5 of max) in float32."""
    sb, state = _coupling("torch", dtype)
    jsb, jstate = _coupling("jax", dtype)
    t = 2000.0 * SPY
    e = sb.age_enhancement(state, t)
    assert e.dtype == state.age.dtype
    assert sorted(np.unique(e.numpy())) == [1.0, 8.0]
    # the JAX package forms the same field inside its update
    depo = jnp.float64(t) - jstate.age
    inter = (((depo >= jsb.eemian_start) & (depo <= jsb.eemian_end))
             | (depo >= jsb.holocene_start))
    want = jnp.where(inter, jsb.e_sia_interglacial, jsb.e_sia).astype(
        jstate.age.dtype)
    np.testing.assert_array_equal(e.numpy(), np.asarray(want))
    got = sb.update(state, None, t=t)
    ref = jsb.update(jstate, t=t)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    for name in ("qe", "qn"):
        assert _rel(getattr(got, name), getattr(ref, name)) <= tol, name


def test_e_age_coupling_requires_age():
    over = {"stress_balance.sia.e_age_coupling": True}
    with pytest.raises(ValueError):
        JSB(grid=JGrid(Mx=5, My=5, Lx=1e4, Ly=1e4), config=JConfig(over),
            model="sia")
    with pytest.raises(ValueError):
        StressBalance(grid=pt.Grid(Mx=5, My=5, Lx=1e4, Ly=1e4),
                      config=pt.Config(dict(over, **{
                          "stress_balance.model": "sia"})),
                      sia_flow_law=None)


def test_field_enhancement_takes_the_plain_path(monkeypatch):
    """Under ``stress_balance.sia.pallas = on`` (pallas=True) a 3D
    enhancement field declines K3's route, as the JAX package declines its
    kernel: the kernel wrapper is never called."""
    def refuse(*a, **k):
        raise AssertionError("the kernel route was taken")

    monkeypatch.setattr(K3, "sia_flux_thermo", refuse)
    grid_kw, H = _dome_sia()
    grid = pt.Grid(**grid_kw)
    cfg = pt.Config({"grid.Mz": 11})
    law = PatersonBudd(EC=EnthalpyConverter.from_config(cfg))
    geom = new_geometry(torch.as_tensor(H), torch.zeros(grid.shape2,
                                                        dtype=torch.float64))
    E3 = torch.full(grid.shape3, 9.0e4, dtype=torch.float64)
    e = torch.full(grid.shape3, 2.0, dtype=torch.float64)
    got = t_sia.diffusivity(law, geom, E3, grid, Shifter(grid),
                            enhancement=e, pallas=True)
    assert float(got.max_D) == pytest.approx(_diffusivity_max(2.0, "torch"),
                                             rel=1e-12)
    with pytest.raises(AssertionError, match="kernel route"):
        t_sia.diffusivity(law, geom, E3, grid, Shifter(grid),
                          enhancement=2.0, pallas=True)
