"""The rest of the coupler, pism_tpu_torch against pism_tpu on the CPU from
the same numpy inputs: the atmosphere models and modifiers
(``ElevationChange``, ``FracP``, ``PrecipitationScaling``, ``Anomaly``,
``CosineYearlyCycle``, ``WeatherStation``), the surface models and
modifiers (``ElevationDependent``, ``ISMIP6``, ``Anomaly``,
``ElevationChange``, ``Cache``, ``ForceThickness``, over the stateful PDD
too), the ocean (``GivenTH`` in float64 and float32, ``Given``, the
scalar modifiers, the melange back pressure, ``Cache``), ``DeltaSL2D``,
the rest of the PDD (Fausto factors, sigma(T), the sigma field and its
latitude lapse) at 1e-12 relative in float64, and the PDD's Monte-Carlo
methods held to the expectation integral by statistics. Then the JAX
package's own cases of these models (``tests/test_couplers.py``,
``tests/test_forcing_files.py``) on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pism_tpu import Config as JConfig
from pism_tpu import Grid as JGrid
from pism_tpu.coupler import atmosphere as j_atm
from pism_tpu.coupler import ocean as j_ocn
from pism_tpu.coupler import pdd as j_pdd
from pism_tpu.coupler import sealevel as j_sl
from pism_tpu.coupler import surface as j_srf
from pism_tpu.state import new_geometry as j_geom
from pism_tpu.util.forcing import ScalarForcing as JScalar
from pism_tpu_torch import Config, Grid, new_geometry
from pism_tpu_torch.coupler import atmosphere as t_atm
from pism_tpu_torch.coupler import ocean as t_ocn
from pism_tpu_torch.coupler import pdd as t_pdd
from pism_tpu_torch.coupler import sealevel as t_sl
from pism_tpu_torch.coupler import surface as t_srf
from pism_tpu_torch.coupler.surface import SurfaceCarry
from pism_tpu_torch.util.forcing import ScalarForcing

torch.set_num_threads(2)

SPY = 3.15569259747e7
SHAPE = (9, 11)
TIMES = [-1.0 * SPY, 0.3 * SPY, 1.7 * SPY, 4.9 * SPY]
STACK_T = np.array([0.0, 0.5, 1.5, 3.0]) * SPY


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, name, rel=1e-12):
    got = _np(got).astype(np.float64)
    want = np.broadcast_to(_np(want).astype(np.float64), got.shape)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rel * scale, name


def _f32(got, want, name, ulps=8):
    """float32 within a few ulps of the field's magnitude."""
    _close(got, want, name, rel=ulps * 2.0 ** -24)


def _data(seed=5):
    rng = np.random.default_rng(seed)
    nt = STACK_T.size
    H = rng.uniform(0.0, 2500.0, SHAPE)
    H[0] = 0.0
    return dict(
        H=H, bed=rng.uniform(-900.0, 600.0, SHAPE),
        ref=rng.uniform(0.0, 1500.0, SHAPE),
        Ta=rng.uniform(240.0, 268.0, SHAPE), Tj=rng.uniform(262.0, 282.0,
                                                          SHAPE),
        P=rng.uniform(1e-9, 3e-8, SHAPE),
        lat=rng.uniform(58.0, 82.0, SHAPE),
        dT_stack=rng.uniform(-3.0, 3.0, (nt,) + SHAPE),
        dP_stack=rng.uniform(-5e-9, 5e-9, (nt,) + SHAPE),
        smb_stack=rng.uniform(-2e-8, 2e-8, (nt,) + SHAPE),
        smb=rng.uniform(-3e-8, 3e-8, SHAPE),
        T=rng.uniform(240.0, 272.0, SHAPE),
        theta=271.2 + rng.uniform(-1.0, 2.5, (nt,) + SHAPE),
        salt=34.0 + rng.uniform(0.0, 1.0, (nt,) + SHAPE),
        sigma=rng.uniform(1.5, 6.0, SHAPE))


def _pair(a, jdt=jnp.float64, tdt=torch.float64):
    return jnp.asarray(a, jdt), torch.tensor(np.asarray(a), dtype=tdt)


def _geoms(d, jdt=jnp.float64, tdt=torch.float64):
    return (j_geom(jnp.asarray(d["H"], jdt), jnp.asarray(d["bed"], jdt)),
            new_geometry(torch.tensor(d["H"], dtype=tdt),
                         torch.tensor(d["bed"], dtype=tdt)))


def _series(periodic=False):
    t, v = [0.0, 1.0, 2.5, 4.0], [0.0, -2.0, 1.5, 3.0]
    return (JScalar.from_arrays(t, v, periodic),
            ScalarForcing.from_arrays(t, v, periodic))


# ---------------------------------------------------------------- atmosphere

def _atm_base(d, pkg, dt=torch.float64, jdt=jnp.float64):
    if pkg == "jax":
        return j_atm.CosineYearlyCycle(
            temperature_mean_annual=jnp.asarray(d["Ta"], jdt),
            temperature_mean_summer=jnp.asarray(d["Tj"], jdt),
            precipitation=jnp.asarray(d["P"], jdt))
    return t_atm.CosineYearlyCycle(
        temperature_mean_annual=torch.tensor(d["Ta"], dtype=dt),
        temperature_mean_summer=torch.tensor(d["Tj"], dtype=dt),
        precipitation=torch.tensor(d["P"], dtype=dt))


def _atm_models(name, d, pkg):
    m = j_atm if pkg == "jax" else t_atm
    i = 0 if pkg == "jax" else 1
    base = _atm_base(d, pkg)
    sj = _series()[i]
    if name == "elevation_change_scale":
        return m.ElevationChange(inner=base, reference_surface=_pair(
            d["ref"])[i], lapse_rate=7e-3, precip_scale_factor=0.07)
    if name == "elevation_change_shift":
        return m.ElevationChange(inner=base, reference_surface=_pair(
            d["ref"])[i], precip_lapse_rate=1e-11)
    if name == "frac_P":
        return m.FracP(inner=base, fraction=_series(True)[i])
    if name == "precip_scaling":
        return m.PrecipitationScaling(inner=base, delta_T=sj,
                                      exp_factor=0.0704)
    if name == "anomaly_stacked":
        return m.Anomaly(inner=base, temp_anomaly=_pair(d["dT_stack"])[i],
                         precip_anomaly=_pair(d["dP_stack"])[i],
                         times=STACK_T if i else jnp.asarray(STACK_T),
                         period=2.0 * SPY)
    if name == "anomaly_field":
        return m.Anomaly(inner=base, temp_anomaly=_pair(d["dT_stack"][1])[i])
    if name == "yearly_cycle_scaled":
        return m.CosineYearlyCycle(
            temperature_mean_annual=_pair(d["Ta"])[i],
            temperature_mean_summer=_pair(d["Tj"])[i],
            precipitation=_pair(d["P"])[i], scaling=_series(True)[i])
    if name == "one_station":
        T = (JScalar if i == 0 else ScalarForcing).from_arrays(
            [0.0, 2.0], [250.0, 258.0])
        P = (JScalar if i == 0 else ScalarForcing).from_arrays(
            [0.0, 2.0], [1e-8, 2e-8])
        return m.WeatherStation(temperature=T, precipitation=P)
    raise KeyError(name)


ATM = ["elevation_change_scale", "elevation_change_shift", "frac_P",
       "precip_scaling", "anomaly_stacked", "anomaly_field",
       "yearly_cycle_scaled", "one_station"]


@pytest.mark.parametrize("name", ATM)
def test_atmosphere_models_match(name):
    d = _data()
    jg, tg = _geoms(d)
    jm, tm = _atm_models(name, d, "jax"), _atm_models(name, d, "torch")
    for t in TIMES:
        for what, a, b in zip(("T", "T_july", "P"), tm(tg, t), jm(jg, t)):
            _close(a, b, f"{name} {what} at {t / SPY} a")


def test_temperature_at_matches():
    d = _data()
    jg, tg = _geoms(d)
    jm, tm = _atm_base(d, "jax"), _atm_base(d, "torch")
    for yf in (0.1, 0.5, 0.77):
        _close(tm.temperature_at(tg, 0.0, yf), jm.temperature_at(jg, 0.0, yf),
               f"T at {yf}")


# ---------------------------------------------------------------- surface

def _pdd(d, pkg, over=None, **kw):
    cfg = dict(over or {})
    if pkg == "jax":
        return j_pdd.TemperatureIndex(atmosphere=_atm_base(d, "jax"),
                                      config=JConfig(cfg), **kw)
    return t_pdd.TemperatureIndex(atmosphere=_atm_base(d, "torch"),
                                  config=Config(cfg), **kw)


def _surface_models(name, d, pkg):
    m = j_srf if pkg == "jax" else t_srf
    i = 0 if pkg == "jax" else 1
    given = m.Given(smb_field=_pair(d["smb_stack"])[i],
                    temperature_field=_pair(d["theta"] - 10.0)[i],
                    times=STACK_T if i else jnp.asarray(STACK_T))
    if name == "elevation":
        return m.ElevationDependent(z_min=200.0, z_ela=1100.0, z_max=2500.0,
                                    m_min=-4.0 / SPY, m_max=1.0 / SPY)
    if name == "ismip6":
        return m.ISMIP6(
            smb_ref=_pair(d["smb"])[i], temperature_ref=_pair(d["T"])[i],
            surface_ref=_pair(d["ref"])[i],
            anomaly_times=STACK_T if i else jnp.asarray(STACK_T),
            a_smb=_pair(d["smb_stack"])[i], a_temp=_pair(d["dT_stack"])[i],
            dsmb_dz=_pair(d["smb_stack"] * 1e-3)[i],
            dtemp_dz=_pair(d["dT_stack"] * -1e-3)[i])
    if name == "anomaly":
        return m.Anomaly(inner=given, smb_anomaly=_pair(d["smb_stack"])[i],
                         temp_anomaly=_pair(d["dT_stack"])[i],
                         times=STACK_T if i else jnp.asarray(STACK_T),
                         period=1.2 * SPY)
    if name == "elevation_change_shift":
        return m.ElevationChange(inner=given,
                                 reference_surface=_pair(d["ref"])[i],
                                 smb_lapse_rate=2e-12)
    if name == "elevation_change_scale":
        return m.ElevationChange(inner=given,
                                 reference_surface=_pair(d["ref"])[i],
                                 temp_lapse_rate=5e-3, smb_exp_factor=0.05)
    if name == "cache":
        return m.Cache(inner=given, update_interval=0.4 * SPY)
    if name == "force_to_thickness":
        return m.ForceThickness(inner=given,
                                target_thickness=_pair(d["ref"])[i],
                                alpha=4e-9, ice_free_alpha_factor=3.0,
                                start_time=0.5 * SPY)
    raise KeyError(name)


SURF = ["elevation", "ismip6", "anomaly", "elevation_change_shift",
        "elevation_change_scale", "cache", "force_to_thickness"]


@pytest.mark.parametrize("name", SURF)
def test_surface_models_match(name):
    d = _data()
    jg, tg = _geoms(d)
    jm, tm = _surface_models(name, d, "jax"), _surface_models(name, d,
                                                              "torch")
    for t in TIMES:
        a, b = tm(tg, t), jm(jg, t)
        _close(a.smb, b.smb, f"{name} smb at {t / SPY} a")
        _close(a.temperature, b.temperature, f"{name} T at {t / SPY} a")


@pytest.mark.parametrize("mod", ["anomaly", "elevation_change", "cache",
                                 "force_to_thickness"])
def test_modifiers_over_the_stateful_pdd(mod):
    """A modifier over the PDD passes the carry through (``update``)."""
    d = _data()
    jg, tg = _geoms(d)

    def wrap(pkg):
        m = j_srf if pkg == "jax" else t_srf
        i = 0 if pkg == "jax" else 1
        inner = _pdd(d, pkg)
        if mod == "anomaly":
            return m.Anomaly(inner=inner, temp_anomaly=_pair(d["dT_stack"])[i],
                             times=STACK_T if i else jnp.asarray(STACK_T))
        if mod == "elevation_change":
            return m.ElevationChange(inner=inner,
                                     reference_surface=_pair(d["ref"])[i],
                                     smb_exp_factor=0.05)
        if mod == "cache":
            return m.Cache(inner=inner, update_interval=SPY)
        return m.ForceThickness(inner=inner,
                                target_thickness=_pair(d["ref"])[i])

    from pism_tpu.coupler.surface import SurfaceCarry as JCarry
    jm, tm = wrap("jax"), wrap("torch")
    assert tm.stateful and jm.stateful
    z = np.zeros(SHAPE)
    jc = JCarry(jnp.asarray(z), jnp.asarray(z), None)
    tc = SurfaceCarry(torch.tensor(z), torch.tensor(z))
    for t in (0.4 * SPY, 0.8 * SPY):
        b, jc = jm.update(jg, t, jnp.asarray(0.4 * SPY), jc)
        a, tc = tm.update(tg, t, 0.4 * SPY, tc)
        for name in ("smb", "temperature", "melt", "runoff"):
            _close(getattr(a, name), getattr(b, name), f"{mod} {name}")
        _close(tc.snow, jc.snow, "snow")
        _close(tc.firn, jc.firn, "firn")


# ---------------------------------------------------------------- PDD

PDD_OPTIONS = {
    "fausto": ({"surface.pdd.fausto.enabled": True}, False, False),
    "fausto_latitude": ({"surface.pdd.fausto.enabled": True}, False, True),
    "sigma_param": ({"surface.pdd.std_dev.param_enabled": True}, False,
                    False),
    "sigma_field": ({}, True, False),
    "sigma_lat_lapse": ({"surface.pdd.std_dev.lapse_lat_rate": 0.2,
                         "surface.pdd.std_dev.param_enabled": True}, False,
                        True),
}


@pytest.mark.parametrize("name", list(PDD_OPTIONS))
def test_pdd_options_match(name):
    over, field, lat = PDD_OPTIONS[name]
    d = _data()
    jg, tg = _geoms(d)
    jkw, tkw = {}, {}
    if field:
        jkw["sigma_field"], tkw["sigma_field"] = _pair(d["sigma"])
    if lat:
        jkw["latitude"], tkw["latitude"] = _pair(d["lat"])
    jm, tm = _pdd(d, "jax", over, **jkw), _pdd(d, "torch", over, **tkw)
    from pism_tpu.coupler.surface import SurfaceCarry as JCarry
    z = np.zeros(SHAPE)
    jc = JCarry(jnp.asarray(z), jnp.asarray(z), None)
    tc = SurfaceCarry(torch.tensor(z), torch.tensor(z))
    for t in (0.2 * SPY, 0.65 * SPY):
        b, jc = jm.update(jg, t, jnp.asarray(0.45 * SPY), jc)
        a, tc = tm.update(tg, t, 0.45 * SPY, tc)
        for what in ("smb", "melt", "runoff", "accumulation"):
            _close(getattr(a, what), getattr(b, what), f"{name} {what}")
        _close(tc.snow, jc.snow, "snow")
        _close(tc.firn, jc.firn, "firn")
    _close(tm(tg, 0.0).smb, jm(jg, 0.0).smb, "climatology")


def _no_snow_pdd(method, T, dtype=torch.float64, shape=(31, 31)):
    """A PDD on a uniform climate with no precipitation (all the melt is
    ice melt, linear in the degree days)."""
    atm = t_atm.Uniform(temperature=T, temperature_july=T + 9.0,
                        precipitation=0.0)
    return t_pdd.TemperatureIndex(atmosphere=atm, config=Config(
        {"surface.pdd.method": method})), new_geometry(
        torch.full(shape, 1000.0, dtype=dtype),
        torch.zeros(shape, dtype=dtype))


@pytest.mark.parametrize("T", [266.15, 271.15])
def test_pdd_random_mean_melt_within_three_standard_errors(T):
    """Every cell draws its own daily temperatures: over the 961 cells the
    mean melt of a year lies within three standard errors of the
    expectation integral's (no snow: the melt is linear in the draws)."""
    exp, geom = _no_snow_pdd("expectation_integral", T)
    want = float(exp(geom, 0.0).melt[0, 0])
    for method in ("repeatable_random_process", "random_process"):
        m, _ = _no_snow_pdd(method, T)
        melt = m(geom, 0.0).melt.numpy().ravel()
        se = melt.std(ddof=1) / np.sqrt(melt.size)
        assert melt.std() > 0.0
        assert abs(melt.mean() - want) <= 3.0 * se, method


def test_pdd_repeatable_random_process_restarts_bit_equal():
    """A model built anew (as after a restart) draws the same numbers for
    the same model times; the OS-seeded method draws others."""
    d = _data()
    _, tg = _geoms(d)
    outs = []
    for _ in range(2):
        m = _pdd(d, "torch", {"surface.pdd.method":
                              "repeatable_random_process"})
        z = torch.zeros(SHAPE, dtype=torch.float64)
        a, c = m.update(tg, 0.3 * SPY, 0.25 * SPY, SurfaceCarry(z, z))
        outs.append((a.smb, c.snow, c.firn))
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    m = _pdd(d, "torch", {"surface.pdd.method": "random_process"})
    m2 = _pdd(d, "torch", {"surface.pdd.method": "random_process"})
    assert m._seed != m2._seed or m._seed == 0
    with pytest.raises(ValueError):
        _pdd(d, "torch", {"surface.pdd.method": "bogus"})


# ---------------------------------------------------------------- ocean

def _th(d, pkg, over=None, dtype="f64", stacked=True):
    cfg = dict(over or {})
    theta = d["theta"] if stacked else d["theta"][1]
    salt = d["salt"] if stacked else d["salt"][1]
    times = STACK_T if stacked else None
    if pkg == "jax":
        jdt = jnp.float32 if dtype == "f32" else jnp.float64
        return j_ocn.GivenTH(theta_ocean=jnp.asarray(theta, jdt),
                             salinity_ocean=jnp.asarray(salt, jdt),
                             config=JConfig(cfg),
                             times=None if times is None
                             else jnp.asarray(times), period=0.0)
    tdt = torch.float32 if dtype == "f32" else torch.float64
    return t_ocn.GivenTH(theta_ocean=torch.tensor(theta, dtype=tdt),
                         salinity_ocean=torch.tensor(salt, dtype=tdt),
                         config=Config(cfg), times=times)


def _ocean_models(name, d, pkg):
    m = j_ocn if pkg == "jax" else t_ocn
    i = 0 if pkg == "jax" else 1
    cfg = (JConfig if i == 0 else Config)({})
    sj = _series()[i]
    if name.startswith("th"):
        return _th(d, pkg, {"ocean.th.two_equation": name == "th_two_eq",
                            "ocean.th.clip_salinity": name == "th_clip"},
                   stacked=name != "th_field")
    if name == "given":
        return m.Given(melt_rate=_pair(d["smb_stack"] * -3.0)[i],
                       temperature=_pair(d["theta"])[i],
                       times=STACK_T if i else jnp.asarray(STACK_T),
                       period=2.5 * SPY)
    pik = m.PIK(config=cfg)
    if name == "anomaly":
        return m.Anomaly(inner=pik, anomaly=_pair(d["smb_stack"])[i],
                         times=STACK_T if i else jnp.asarray(STACK_T))
    if name == "delta_T_sensitive":
        return m.DeltaT(inner=pik, offset=sj, melt_sensitivity=3e-9)
    if name == "delta_SMB":
        return m.DeltaSMB(inner=pik, offset=(JScalar if i == 0 else
                                             ScalarForcing).from_arrays(
            [0.0, 3.0], [1e-9, -2e-9]))
    if name == "frac_SMB":
        return m.FracSMB(inner=pik, fraction=_series(True)[i])
    if name == "runoff_SMB":
        return m.RunoffSMB(inner=pik, delta_T=sj, temp_to_runoff_a=0.2)
    if name == "cache":
        return m.Cache(inner=_th(d, pkg), update_interval=0.7 * SPY)
    raise KeyError(name)


OCEAN = ["th", "th_two_eq", "th_clip", "th_field", "given", "anomaly",
         "delta_T_sensitive", "delta_SMB", "frac_SMB", "runoff_SMB", "cache"]


@pytest.mark.parametrize("name", OCEAN)
def test_ocean_models_match(name):
    d = _data()
    jg, tg = _geoms(d)
    jm, tm = _ocean_models(name, d, "jax"), _ocean_models(name, d, "torch")
    for t in TIMES:
        a, b = tm.inputs(tg, t), jm.inputs(jg, t)
        _close(a.shelf_base_melt, b.shelf_base_melt, f"{name} melt {t}")
        _close(a.shelf_base_temperature, b.shelf_base_temperature,
               f"{name} T {t}")


def test_giventh_float32():
    """The three-equation melt in float32, near freeze-on too (the product
    form of the quadratic's root cancels least)."""
    d = _data()
    d["theta"][:, :3] = 271.0
    jg, tg = _geoms(d, jnp.float32, torch.float32)
    for over in ({}, {"ocean.th.clip_salinity": True}):
        jm, tm = _th(d, "jax", over, "f32"), _th(d, "torch", over, "f32")
        for t in TIMES:
            a, b = tm.inputs(tg, t), jm.inputs(jg, t)
            assert a.shelf_base_melt.dtype == torch.float32
            _f32(a.shelf_base_melt, b.shelf_base_melt, "melt")
            _f32(a.shelf_base_temperature, b.shelf_base_temperature, "T")


@pytest.mark.parametrize("kind", ["frac_MBP", "delta_MBP"])
def test_melange_back_pressure_matches(kind):
    d = _data()
    jg, tg = _geoms(d)
    if kind == "frac_MBP":
        jm = j_ocn.FracMBP(inner=j_ocn.PIK(config=JConfig({})),
                           fraction=JScalar.from_arrays([0, 4], [0.2, 0.9]))
        tm = t_ocn.FracMBP(inner=t_ocn.PIK(config=Config({})),
                           fraction=ScalarForcing.from_arrays([0, 4],
                                                              [0.2, 0.9]))
    else:
        jm = j_ocn.DeltaMBP(inner=j_ocn.PIK(config=JConfig({})),
                            offset=JScalar.from_arrays([0, 4], [1e4, 5e4]))
        tm = t_ocn.DeltaMBP(inner=t_ocn.PIK(config=Config({})),
                            offset=ScalarForcing.from_arrays([0, 4],
                                                             [1e4, 5e4]))
    for t in TIMES:
        _close(tm.water_column_pressure(tg, t),
               jm.water_column_pressure(jg, t), f"{kind} at {t / SPY} a")
    _close(t_ocn.hydrostatic_water_column_pressure(tg),
           j_ocn.hydrostatic_water_column_pressure(jg), "hydrostatic")


def test_melange_back_pressure_reaches_the_ssa_front():
    """The SSA's calving-front term takes the ocean's water-column
    pressure, as the JAX package's does."""
    from pism_tpu.model.ssa import SSAFD as JSSAFD
    from pism_tpu.physics.rheology import flow_law_from_config as j_law
    from pism_tpu_torch.model.ssa import SSAFD
    from pism_tpu_torch.physics.rheology import flow_law_from_config
    d = _data()
    jg, tg = _geoms(d)
    grid = dict(Mx=SHAPE[1], My=SHAPE[0], Lx=100e3, Ly=80e3)
    jc, tc = JConfig({}), Config({})
    js = JSSAFD(JGrid(**grid), jc, j_law(jc, "ssa"))
    ts = SSAFD(Grid(**grid), tc, flow_law_from_config(tc, "ssa"))
    P = np.random.default_rng(2).uniform(0.0, 4e6, SHAPE)
    _close(ts._front_stress(tg, torch.tensor(P)),
           js._front_stress(jg, jnp.asarray(P)), "front stress")
    _close(ts._front_stress(tg), js._front_stress(jg), "hydrostatic front")


@pytest.mark.parametrize("stacked,period", [(False, 0.0), (True, 0.0),
                                            (True, 2.2 * SPY)])
def test_delta_sl_2d_matches(stacked, period):
    d = _data()
    jg, tg = _geoms(d)
    f = d["dT_stack"] * 10.0
    kw = dict(times=STACK_T, period=period) if stacked else {}
    field = f if stacked else f[0]
    jm = j_sl.DeltaSL2D(inner=j_sl.Constant(2.0),
                        offset_field=jnp.asarray(field),
                        **{k: (jnp.asarray(v) if k == "times" else v)
                           for k, v in kw.items()})
    tm = t_sl.DeltaSL2D(inner=t_sl.Constant(2.0),
                        offset_field=torch.tensor(field), **kw)
    for t in TIMES + [10.0 * SPY]:
        _close(tm(tg, t), jm(jg, t), f"delta_SL_2D at {t / SPY} a")


# ------------------------------------------- the JAX package's own cases

@pytest.fixture
def flat():
    grid = Grid(Mx=5, My=5, Lx=50e3, Ly=50e3)
    return grid, new_geometry(torch.full(grid.shape2, 1000.0,
                                         dtype=torch.float64),
                              torch.zeros(grid.shape2, dtype=torch.float64))


def test_giventh_three_equation():
    grid = Grid(Mx=8, My=8, Lx=100e3, Ly=100e3)
    geom = new_geometry(torch.full(grid.shape2, 500.0, dtype=torch.float64),
                        torch.full(grid.shape2, -2000.0, dtype=torch.float64))
    S = torch.full(grid.shape2, 34.7, dtype=torch.float64)

    def melt(dtheta, two_eq=False):
        oc = t_ocn.GivenTH(theta_ocean=torch.full_like(S, 271.25 + dtheta),
                           salinity_ocean=S, config=Config(
                               {"ocean.th.two_equation": two_eq}))
        o = oc.inputs(geom, 0.0)
        return (float(o.shelf_base_melt[4, 4]) * SPY,
                float(o.shelf_base_temperature[4, 4]))

    m0, Tb0 = melt(0.0)
    m1, _ = melt(0.5)
    m2, _ = melt(2.0)
    assert 0.5 < m0 < 10.0 and m0 < m1 < m2
    assert m1 < melt(0.5, two_eq=True)[0]
    assert melt(-2.5)[0] < 0.0
    oc = t_ocn.GivenTH(theta_ocean=torch.full_like(S, 271.25),
                       salinity_ocean=S, config=Config())
    draft = float(oc._draft(geom)[4, 4])
    S_b = (Tb0 - (t_ocn.GivenTH.LIQ_B - t_ocn.GivenTH.LIQ_C * draft)) \
        / t_ocn.GivenTH.LIQ_A
    assert 0.0 < S_b < 34.7


def test_ismip6_surface_anomaly_forcing():
    grid = Grid(Mx=8, My=8, Lx=100e3, Ly=100e3)
    geom = new_geometry(torch.full(grid.shape2, 1000.0, dtype=torch.float64),
                        torch.zeros(grid.shape2, dtype=torch.float64))

    def full(v):
        return torch.full(grid.shape2, v, dtype=torch.float64)

    sm = t_srf.ISMIP6(
        smb_ref=full(0.3 / SPY), temperature_ref=full(250.0),
        surface_ref=full(900.0), anomaly_times=np.array([0.0, 10, 20]) * SPY,
        a_smb=torch.stack([full(k * -0.1 / SPY) for k in range(3)]),
        a_temp=torch.stack([full(float(k)) for k in range(3)]),
        dsmb_dz=torch.stack([full(-1e-4 / SPY)] * 3),
        dtemp_dz=torch.stack([full(-0.007)] * 3))
    s5 = sm(geom, 5 * SPY)
    assert float(s5.smb[4, 4]) * SPY == pytest.approx(0.29, abs=1e-6)
    assert float(s5.temperature[4, 4]) == pytest.approx(249.3, abs=1e-6)
    assert float(sm(geom, 15 * SPY).smb[4, 4]) * SPY \
        == pytest.approx(0.19, abs=1e-6)
    assert float(sm(geom, 99 * SPY).smb[4, 4]) * SPY \
        == pytest.approx(0.09, abs=1e-6)
    assert float(sm(geom, -5 * SPY).smb[4, 4]) * SPY \
        == pytest.approx(0.29, abs=1e-6)


def test_force_thickness_nudging(flat):
    grid, geom = flat
    ft = t_srf.ForceThickness(inner=t_srf.Uniform(smb=0.0),
                              target_thickness=torch.full(
                                  grid.shape2, 1200.0, dtype=torch.float64))
    assert float(ft(geom, 0.0).smb[2, 2]) * SPY == pytest.approx(20.0,
                                                                 rel=0.01)
    ft2 = t_srf.ForceThickness(inner=t_srf.Uniform(smb=0.0),
                               target_thickness=torch.full(
                                   grid.shape2, 500.0, dtype=torch.float64))
    assert float(ft2(geom, 0.0).smb[2, 2]) < 0.0


def test_pdd_stateful_through_modifier_chain(flat):
    grid, geom = flat
    a = t_atm.Uniform(temperature=253.15, precipitation=0.3 / SPY)
    chain = t_srf.Anomaly(inner=t_pdd.TemperatureIndex(atmosphere=a,
                                                       config=Config()),
                          temp_anomaly=torch.full(grid.shape2, 5.0,
                                                  dtype=torch.float64))
    assert chain.stateful
    z = torch.zeros(grid.shape2, dtype=torch.float64)
    out, carry = chain.update(geom, 0.0, SPY, SurfaceCarry(z, z))
    assert float(carry.snow[2, 2]) >= 0.0
    inner, _ = chain.inner.update(geom, 0.0, SPY, SurfaceCarry(z, z))
    _close(out.temperature, inner.temperature + 5.0, "anomaly")


def test_pdd_sigma_parameterization(flat):
    grid, geom = flat
    a = t_atm.Uniform(temperature=263.15, temperature_july=272.15,
                      precipitation=0.3 / SPY)
    fixed = t_pdd.TemperatureIndex(atmosphere=a, config=Config())
    param = t_pdd.TemperatureIndex(atmosphere=a, config=Config(
        {"surface.pdd.std_dev.param_enabled": True}))
    assert float(param(geom, 0.0).smb[2, 2]) \
        > float(fixed(geom, 0.0).smb[2, 2])


def test_surface_elevation_change_modifier():
    from pism_tpu_torch.coupler.factory import surface_from_config
    grid = Grid(Mx=5, My=5, Lx=50e3, Ly=50e3)
    ref = torch.zeros(grid.shape2, dtype=torch.float64)
    inner = t_srf.Uniform(smb=0.5 / SPY, temperature=265.15)
    hi = new_geometry(torch.full(grid.shape2, 1000.0, dtype=torch.float64),
                      ref)
    out = t_srf.ElevationChange(inner=inner, reference_surface=ref,
                                smb_lapse_rate=0.2 / SPY / 1000.0)(hi, 0.0)
    assert float(out.smb[2, 2]) * SPY == pytest.approx(0.3, rel=1e-6)
    assert float(out.temperature[2, 2]) == pytest.approx(259.15, abs=1e-6)
    out2 = t_srf.ElevationChange(inner=inner, reference_surface=ref,
                                 smb_exp_factor=0.07)(hi, 0.0)
    assert float(out2.smb[2, 2]) * SPY \
        == pytest.approx(0.5 * np.exp(0.07 * -6.0), rel=1e-6)
    chain = surface_from_config(Config({
        "surface.models": "uniform,elevation_change",
        "surface.elevation_change.smb.lapse_rate": 0.2 / SPY / 1e3}),
        inputs={"reference_surface": ref})
    assert isinstance(chain, t_srf.ElevationChange)


def test_atmosphere_elevation_change_precip_shift():
    grid = Grid(Mx=5, My=5, Lx=50e3, Ly=50e3)
    z = torch.zeros(grid.shape2, dtype=torch.float64)
    m = t_atm.ElevationChange(
        inner=t_atm.Uniform(temperature=260.15, precipitation=0.5 / SPY),
        reference_surface=z, precip_lapse_rate=0.3 / SPY / 1000.0)
    hi = new_geometry(torch.full(grid.shape2, 1000.0, dtype=torch.float64), z)
    assert float(m(hi, 0.0).precipitation[2, 2]) * SPY \
        == pytest.approx(0.2, rel=1e-6)
    vhi = new_geometry(torch.full(grid.shape2, 3000.0, dtype=torch.float64),
                       z)
    assert float(m(vhi, 0.0).precipitation[2, 2]) == 0.0


def test_pdd_sigma_field_from_file(flat, tmp_path):
    from pism_tpu_torch.coupler.factory import (inputs_from_files,
                                                surface_from_config)
    from pism_tpu_torch.io.nc4 import File
    grid, geom = flat
    path = str(tmp_path / "sd.nc")
    with File(path, "w", format="netcdf3") as f:
        f.define_dimension("y", grid.My, np.asarray(grid.y))
        f.define_dimension("x", grid.Mx, np.asarray(grid.x))
        f.write("air_temp_sd", np.full(grid.shape2, 2.0), ("y", "x"),
                {"units": "K"})
    cfg = Config({"surface.models": "pdd",
                  "surface.pdd.std_dev.file": path})
    a = t_atm.Uniform(temperature=263.15, temperature_july=272.15,
                      precipitation=0.3 / SPY)
    inputs = inputs_from_files(cfg, grid, "surface", "cpu")
    assert "air_temp_sd" in inputs
    pdd2 = surface_from_config(cfg, inputs=inputs, atmosphere=a)
    pdd5 = t_pdd.TemperatureIndex(atmosphere=a, config=Config())
    assert float(pdd2(geom, 0.0).smb[2, 2]) > float(pdd5(geom, 0.0).smb[2, 2])


def _write(path, grid, names, nt, units, value):
    from pism_tpu_torch.io.nc4 import File
    with File(path, "w", format="netcdf3") as f:
        f.define_dimension("time", None, attrs={"units": "years"})
        f.define_dimension("y", grid.My, np.asarray(grid.y))
        f.define_dimension("x", grid.Mx, np.asarray(grid.x))
        for k in range(nt):
            n = f.append_time(float(10 * k))
            for name, u in zip(names, units):
                f.write(name, np.full(grid.shape2, value(name, k))[None],
                        ("time", "y", "x"), {"units": u}, time_index=n)
    return path


def test_ocean_th_from_file(tmp_path):
    from pism_tpu_torch.coupler import factory as cf
    grid = Grid(Mx=9, My=9, Lx=100e3, Ly=100e3)
    path = _write(str(tmp_path / "th.nc"), grid,
                  ["theta_ocean", "salinity_ocean"], 3, ["K", "g/kg"],
                  lambda n, k: 271.0 + k if n == "theta_ocean" else 34.7)
    cfg = Config({"ocean.models": "th", "ocean.th.file": path})
    ocean = cf.ocean_from_config(
        cfg, inputs=cf.inputs_from_files(cfg, grid, "ocean", "cpu"),
        grid=grid)
    geom = new_geometry(torch.full(grid.shape2, 400.0, dtype=torch.float64),
                        torch.full(grid.shape2, -1500.0, dtype=torch.float64))
    m0 = float(ocean.inputs(geom, 0.0).shelf_base_melt[4, 4])
    m2 = float(ocean.inputs(geom, 20.0 * SPY).shelf_base_melt[4, 4])
    assert m2 > m0 > 0.0


def test_scalar_modifier_files(tmp_path):
    from pism_tpu_torch.coupler import factory as cf
    from pism_tpu_torch.io.nc4 import File
    grid = Grid(Mx=9, My=9, Lx=100e3, Ly=100e3)

    def series(path, name, values):
        with File(path, "w", format="netcdf3") as f:
            f.define_dimension("time", 2, np.array([0.0, 100.0]),
                               attrs={"units": "years"})
            f.write(name, np.asarray(values, float), ("time",))
        return path

    cfg = Config({"atmosphere.models": "uniform,delta_T",
                  "atmosphere.delta_T.file": series(
                      str(tmp_path / "dT.nc"), "delta_T", [0.0, 5.0]),
                  "ocean.models": "constant,frac_MBP",
                  "ocean.frac_MBP.file": series(
                      str(tmp_path / "mbp.nc"), "frac_MBP", [0.0, 1.0])})
    atm = cf.atmosphere_from_config(
        cfg, inputs=cf.inputs_from_files(cfg, grid, "atmosphere", "cpu"))
    geom = new_geometry(torch.full(grid.shape2, 500.0, dtype=torch.float64),
                        torch.zeros(grid.shape2, dtype=torch.float64))
    T0 = float(atm(geom, 0.0).temperature[4, 4])
    assert float(atm(geom, 50.0 * SPY).temperature[4, 4]) \
        == pytest.approx(T0 + 2.5, abs=1e-6)
    ocean = cf.ocean_from_config(
        cfg, inputs=cf.inputs_from_files(cfg, grid, "ocean", "cpu"),
        grid=grid)
    Pw = ocean.water_column_pressure(geom, 50.0 * SPY)
    P_def = t_ocn.hydrostatic_water_column_pressure(geom)
    assert float(P_def[4, 4]) < float(Pw[4, 4]) < 0.5 * 9.81 * 910.0 * 500.0
