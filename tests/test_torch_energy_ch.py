"""The energy model's cryo-hydrologic warming (``energy.ch_warming``) and
temperature-dependent conductivity (``energy.temperature_dependent_
conductivity``): ``pism_tpu_torch`` against ``pism_tpu`` on the CPU.

- The JAX package's ``tests/test_energy.py::test_cryo_hydrologic_warming``
  (40 one-year steps of a 5x5x21 column set, with melt, without, and with
  the option off) on the port with its assertions, each run's E and CH
  state held to JAX's within 1e-12 relative.
- One energy step from a random polythermal state with random 3D
  velocities and strain heating, with k(T), with the CH system (the melt
  season from the surface melt, and without a melt field from the
  surface temperature), and with both: E, the basal melt rate and the CH
  state within 1e-12 of their max in float64 and within float32 rounding
  (2e-6) in float32. The CH column takes no drained water, so the JAX
  package's 0.5 weight on the drained water (ROADMAP "Reference quirks")
  enters the basal melt only, as in JAX.
- ``prepare_state`` starts the CH system at the ice's enthalpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu import Config as JConfig, Grid as JGrid  # noqa: E402
from pism_tpu.model.energy import EnergyModel as JEnergy  # noqa: E402
from pism_tpu.model.energy import bootstrap_enthalpy as j_boot  # noqa: E402
from pism_tpu.ops.sia3d import SIA3D as JSIA3D  # noqa: E402
from pism_tpu.physics.enthalpy_converter import (  # noqa: E402
    EnthalpyConverter as JEC)
from pism_tpu.state import ModelState as JState  # noqa: E402
from pism_tpu.state import new_geometry as j_new_geometry  # noqa: E402
import pism_tpu_torch as pt  # noqa: E402
from pism_tpu_torch.model.energy import EnergyModel  # noqa: E402
from pism_tpu_torch.ops.sia3d import SIA3D  # noqa: E402
from pism_tpu_torch.physics.enthalpy_converter import (  # noqa: E402
    EnthalpyConverter)
from pism_tpu_torch.state import ModelState, new_geometry  # noqa: E402

SPY = 3.15569259747e7


def _rel(a, b):
    a = (a.numpy() if torch.is_tensor(a) else np.asarray(a)).astype(float)
    b = np.asarray(b, float)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _models(over, grid_kw):
    jc, tc = JConfig(over), pt.Config(over)
    jg, tg = JGrid(**grid_kw), pt.Grid(**grid_kw)
    return (jg, JEnergy(grid=jg, config=jc, EC=JEC.from_config(jc)),
            tg, EnergyModel(grid=tg, config=tc,
                            EC=EnthalpyConverter.from_config(tc)))


def test_cryo_hydrologic_warming():
    """Where the surface melts the CH columns sit at the pressure-melting
    point and warm the colder ice; without melt they cool toward the ice
    and warm it little; with the option off nothing changes."""
    kw = dict(Mx=5, My=5, Lx=50e3, Ly=50e3, Mz=21, Lz=1500.0,
              vertical_spacing="equal")

    def run(enabled, melting=True, years=40):
        over = {"energy.ch_warming.enabled": bool(enabled),
                "energy.ch_warming.average_channel_spacing": 20.0}
        jg, jem, tg, em = _models(over, kw)
        H = np.full(jg.shape2, 1000.0)
        T_s = np.full(jg.shape2, 263.15)
        E0 = np.asarray(j_boot(jg, jem.EC, jnp.asarray(H), jnp.asarray(T_s)))
        z3 = np.zeros(jg.shape3)
        melt = np.full(jg.shape2, (1.0 if melting else 0.0) / SPY)
        G = np.full(jg.shape2, 0.042)
        jsia3 = JSIA3D(*(jnp.asarray(z3) for _ in range(4)),
                       max_u=jnp.zeros(()), max_v=jnp.zeros(()))
        sia3 = SIA3D(*(torch.as_tensor(z3) for _ in range(4)),
                     max_u=torch.zeros(()), max_v=torch.zeros(()))
        js = JState(geometry=j_new_geometry(jnp.asarray(H),
                                            jnp.zeros(jg.shape2)),
                    enthalpy=jnp.asarray(E0))
        ts = ModelState(geometry=new_geometry(torch.as_tensor(H),
                                              torch.zeros(tg.shape2,
                                                          dtype=torch.float64)),
                        enthalpy=torch.as_tensor(E0.copy()))
        jch = jnp.asarray(E0) if enabled else None
        ch = torch.as_tensor(E0.copy()) if enabled else None
        jstep = jax.jit(lambda E, c: jem.step(
            js.replace(enthalpy=E), jsia3, jnp.asarray(T_s), SPY,
            surface_melt=jnp.asarray(melt), ch_enthalpy=c))
        for _ in range(years):
            jr = jstep(js.enthalpy, jch)
            r = em.step(ts, sia3, torch.as_tensor(T_s), SPY,
                        torch.as_tensor(G), surface_melt=torch.as_tensor(melt),
                        ch_enthalpy=ch)
            js, ts = js.replace(enthalpy=jr.enthalpy), \
                ts.replace(enthalpy=r.enthalpy)
            jch, ch = jr.ch_enthalpy, r.ch_enthalpy
        assert _rel(ts.enthalpy, js.enthalpy) <= 1e-12
        if enabled:
            assert _rel(ch, jch) <= 1e-12
        return ts.enthalpy.numpy(), ch, em.EC

    E_off, ch_off, EC = run(False)
    E_on, ch_on, _ = run(True)
    assert ch_off is None and ch_on is not None
    z = np.asarray(JGrid(**kw).z)
    k_mid = int(np.argmin(np.abs(z - 500.0)))
    E_cts = float(EC.enthalpy_cts(EC.pressure(torch.tensor(500.0,
                                                           dtype=torch.float64))))
    assert float(ch_on[2, 2, k_mid]) >= E_cts - 1.0
    dE = float(E_on[2, 2, k_mid] - E_off[2, 2, k_mid])
    assert dE > 500.0 and float(E_on[2, 2, k_mid]) <= E_cts + 1e3
    E_dry, _, _ = run(True, melting=False)
    assert abs(float(E_dry[2, 2, k_mid] - E_off[2, 2, k_mid])) < 0.2 * dE


def _random_state(dtype, seed=31):
    kw = dict(Mx=19, My=17, Lx=180e3, Ly=160e3, Mz=17, Lz=3000.0)
    jg = JGrid(**kw)
    rng = np.random.default_rng(seed)
    X, Y = np.meshgrid(np.asarray(jg.x), np.asarray(jg.y))
    H = 2500.0 * np.maximum(1.0 - (X / 170e3) ** 2 - (Y / 150e3) ** 2,
                            0.0) ** 0.5
    H = np.where(H > 0, H + rng.uniform(0, 40, H.shape), 0.0)
    bed = np.where(X > 120e3, -700.0, 50.0)
    EC = JEC.from_config(JConfig({}))
    z = np.asarray(jg.z)
    depth = np.maximum(H[..., None] - z, 0.0)
    p = np.asarray(EC.pressure(jnp.asarray(depth)))
    Ects = np.asarray(EC.enthalpy_cts(jnp.asarray(p)))
    E = Ects - rng.uniform(-8e3, 6e4, depth.shape)      # some temperate
    ch = Ects - rng.uniform(-3e3, 3e4, depth.shape)
    u, v = (rng.standard_normal(depth.shape) * 30.0 / SPY for _ in range(2))
    w = rng.standard_normal(depth.shape) * 0.2 / SPY
    heat = rng.uniform(0.0, 1e-4, depth.shape)
    T_s = rng.uniform(255.0, 274.0, H.shape)
    melt = np.where(rng.uniform(size=H.shape) > 0.5,
                    rng.uniform(0.0, 2.0, H.shape) / SPY, 0.0)
    G = rng.uniform(0.04, 0.08, H.shape)
    fric = rng.uniform(0.0, 0.05, H.shape)
    till = rng.uniform(-0.1, 1.0, H.shape)
    return kw, {k: np.asarray(a, dtype) for k, a in dict(
        H=H, bed=bed, E=E, ch=ch, u=u, v=v, w=w, heat=heat, T_s=T_s,
        melt=melt, G=G, fric=fric, till=till).items()}


CASES = [
    ({"energy.temperature_dependent_conductivity": True}, "melt"),
    ({"energy.ch_warming.enabled": True}, "melt"),
    ({"energy.ch_warming.enabled": True}, "temperature"),
    ({"energy.ch_warming.enabled": True,
      "energy.temperature_dependent_conductivity": True,
      "energy.ch_warming.residual_water_fraction": 0.01,
      "energy.ch_warming.average_channel_spacing": 35.0}, "melt"),
]


@pytest.mark.parametrize("over,season", CASES,
                         ids=["kT", "ch", "ch-by-temperature", "ch-kT"])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 2e-6)])
def test_energy_step_matches(over, season, dtype, tol):
    kw, f = _random_state(dtype)
    jg, jem, tg, em = _models(over, kw)
    J, T = jnp.asarray, torch.as_tensor
    js = JState(geometry=j_new_geometry(J(f["H"]), J(f["bed"])),
                enthalpy=J(f["E"]))
    ts = ModelState(geometry=new_geometry(T(f["H"]), T(f["bed"])),
                    enthalpy=T(f["E"]))
    fields = [f[k] for k in ("u", "v", "w", "heat")]
    jsia3 = JSIA3D(*(J(a) for a in fields), max_u=J(0.0), max_v=J(0.0))
    sia3 = SIA3D(*(T(a) for a in fields), max_u=T(0.0), max_v=T(0.0))
    melt = f["melt"] if season == "melt" else None
    dt = float(np.asarray(0.35 * SPY, dtype))
    # op by op: under jit XLA's fusion rounds the basal melt's flux
    # difference otherwise (2.7e-5 in float32, past 1e-12 now and then in
    # float64)
    jr = jem.step(js, jsia3, J(f["T_s"]), J(np.asarray(dt, dtype)),
                  geothermal_flux=J(f["G"]), frictional_heating=J(f["fric"]),
                  tillwat=J(f["till"]), ch_enthalpy=J(f["ch"]),
                  surface_melt=None if melt is None else J(melt))
    r = em.step(ts, sia3, T(f["T_s"]), dt, T(f["G"]),
                frictional_heating=T(f["fric"]), tillwat=T(f["till"]),
                ch_enthalpy=T(f["ch"]),
                surface_melt=None if melt is None else T(melt))
    assert _rel(r.enthalpy, jr.enthalpy) <= tol
    assert _rel(r.basal_melt_rate, jr.basal_melt_rate) <= tol
    if em.ch_enabled:
        assert _rel(r.ch_enthalpy, jr.ch_enthalpy) <= tol
        # the CH system heated the ice: the step differs from one without
        r0 = em.step(ts, sia3, T(f["T_s"]), dt, T(f["G"]),
                     frictional_heating=T(f["fric"]), tillwat=T(f["till"]),
                     surface_melt=None if melt is None else T(melt))
        assert r0.ch_enthalpy is None
        assert float((r.enthalpy.double() - r0.enthalpy.double()).max()) > 0
    else:
        assert r.ch_enthalpy is None


def test_prepare_state_starts_ch_at_the_ice():
    from pism_tpu_torch import setups
    over = {"energy.ch_warming.enabled": True}
    m, s, g = setups.hybrid_greenland_model("float64", km=200.0,
                                            device="cpu", extra_cfg=over)
    s = m.prepare_state(s)
    assert s.ch_enthalpy is not None and torch.equal(s.ch_enthalpy,
                                                     s.enthalpy)
    m0, s0, _ = setups.hybrid_greenland_model("float64", km=200.0,
                                              device="cpu")
    assert m0.prepare_state(s0).ch_enthalpy is None
