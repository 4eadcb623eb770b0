"""dEBM-simple (``coupler/debm.py``), pism_tpu_torch against pism_tpu on
the CPU: the orbital functions, the hour angle and insolation, the melt
components, the albedo feedback and the stateful update from the same
numpy inputs (1e-12 relative in float64, the field's rounding in
float32), the model through the factory and ``IceModel`` (a 2 a SIA run),
the dEBM diagnostics, the paleo-orbit and albedo files, and a run
restarted from its state file equal to the uninterrupted run to the bit.
Each case of the JAX package's ``tests/test_debm.py`` has its twin here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pism_tpu import Config as JConfig
from pism_tpu import Grid as JGrid
from pism_tpu.coupler import atmosphere as j_atm
from pism_tpu.coupler import debm as j_debm
from pism_tpu.coupler.surface import SurfaceCarry as JCarry
from pism_tpu.state import new_geometry as j_geom
from pism_tpu_torch import Config, Grid, new_geometry
from pism_tpu_torch.coupler import atmosphere as t_atm
from pism_tpu_torch.coupler import debm as t_debm
from pism_tpu_torch.coupler.surface import SurfaceCarry

torch.set_num_threads(2)

SPY = 3.15569259747e7
DEG = np.pi / 180.0


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, name, rel=1e-12):
    got, want = _np(got), np.broadcast_to(_np(want), _np(got).shape)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= rel * scale, name


def _f32_close(got, want, name, ulps=64):
    """float32 results within the field's rounding: a few dozen ulps of
    the field's magnitude (the two packages round the orbit's
    trigonometry and sigma's products at different places)."""
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= ulps * 2.0 ** -24 * scale, name


def _fields(shape=(7, 9), seed=3):
    rng = np.random.default_rng(seed)
    return dict(Ta=rng.uniform(255.0, 268.0, shape),
                Tj=rng.uniform(270.0, 284.0, shape),
                P=rng.uniform(1e-9, 3e-8, shape),
                lat=rng.uniform(60.0, 82.0, shape),
                H=rng.uniform(0.0, 2500.0, shape),
                bed=rng.uniform(-200.0, 900.0, shape),
                alb=rng.uniform(0.47, 0.82, shape))


def _models(f, over=None, dtype=torch.float64, jdtype=jnp.float64,
            **kw):
    """The JAX and torch models on a cosine yearly cycle."""
    cfg = dict(over or {})
    ja = j_atm.CosineYearlyCycle(
        temperature_mean_annual=jnp.asarray(f["Ta"], jdtype),
        temperature_mean_summer=jnp.asarray(f["Tj"], jdtype),
        precipitation=jnp.asarray(f["P"], jdtype))
    ta = t_atm.CosineYearlyCycle(
        temperature_mean_annual=torch.tensor(f["Ta"], dtype=dtype),
        temperature_mean_summer=torch.tensor(f["Tj"], dtype=dtype),
        precipitation=torch.tensor(f["P"], dtype=dtype))
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) and v.ndim == 2
               else v) for k, v in kw.items()}
    tkw = {k: (torch.tensor(v) if isinstance(v, np.ndarray) and v.ndim == 2
               else v) for k, v in kw.items()}
    jm = j_debm.DEBMSimple(atmosphere=ja, latitude=jnp.asarray(f["lat"]),
                           config=JConfig(cfg), **jkw)
    tm = t_debm.DEBMSimple(atmosphere=ta, latitude=torch.tensor(f["lat"]),
                           config=Config(cfg), **tkw)
    return jm, tm


def _geoms(f, dtype=torch.float64, jdtype=jnp.float64):
    return (j_geom(jnp.asarray(f["H"], jdtype), jnp.asarray(f["bed"], jdtype)),
            new_geometry(torch.tensor(f["H"], dtype=dtype),
                         torch.tensor(f["bed"], dtype=dtype)))


# ---------------------------------------------------------------- orbit

def test_present_day_declination_and_distance():
    yf = np.linspace(0.0, 1.0, 365)
    _close(t_debm.solar_declination_present_day(yf),
           j_debm.solar_declination_present_day(jnp.asarray(yf)), "decl")
    _close(t_debm.distance_factor_present_day(yf),
           j_debm.distance_factor_present_day(jnp.asarray(yf)), "dist")
    assert float(t_debm.solar_declination_present_day(172.0 / 365.0)) \
        == pytest.approx(23.44 * DEG, abs=0.01)
    assert float(t_debm.solar_declination_present_day(355.0 / 365.0)) \
        == pytest.approx(-23.44 * DEG, abs=0.01)
    df = t_debm.distance_factor_present_day(yf)
    assert df.max() < 1.036 and df.min() > 0.965 and df[2] > 1.03


@pytest.mark.parametrize("e,obl,peri", [(0.0167, 23.44, 102.94719),
                                        (0.05, 22.1, 270.0)])
def test_paleo_orbit_matches_present_day_for_modern_parameters(e, obl, peri):
    yf = np.linspace(0.0, 1.0, 73)
    d = t_debm.solar_declination_paleo(yf, e, obl * DEG, peri * DEG)
    _close(d, j_debm.solar_declination_paleo(jnp.asarray(yf), e, obl * DEG,
                                             peri * DEG), "paleo decl")
    fp = t_debm.distance_factor_paleo(yf, e, peri * DEG)
    _close(fp, j_debm.distance_factor_paleo(jnp.asarray(yf), e, peri * DEG),
           "paleo dist")
    if e < 0.02:
        assert np.max(np.abs(d - t_debm.solar_declination_present_day(yf))) \
            < 3.0 * DEG
        assert np.max(np.abs(fp - t_debm.distance_factor_present_day(yf))) \
            < 0.004


def test_hour_angle_limits():
    phi, decl = 17.5 * DEG, 23.4 * DEG
    lat = np.linspace(-89.0, 89.0, 41) * DEG
    for dcl in (decl, -0.1, 0.0):
        h = t_debm.hour_angle(phi, torch.tensor(lat), dcl)
        _close(h, j_debm.hour_angle(phi, jnp.asarray(lat), dcl), "h")
        _close(t_debm.insolation(1361.0, 1.02, h, torch.tensor(lat), dcl),
               j_debm.insolation(1361.0, 1.02, jnp.asarray(_np(h)),
                                 jnp.asarray(lat), dcl), "S")
    one = torch.tensor([-75.0 * DEG, 85.0 * DEG, 0.0])
    h = t_debm.hour_angle(phi, one, decl)
    assert float(h[0]) == 0.0
    assert float(h[1]) == pytest.approx(np.pi, abs=1e-6)
    h_eq = float(t_debm.hour_angle(phi, torch.tensor([0.0]), 0.0)[0])
    assert 0.3 < h_eq / np.pi < 0.5
    S = t_debm.insolation(1361.0, 1.0, torch.tensor([0.0, h_eq]),
                          torch.tensor([-75.0 * DEG, 0.0]), 0.0)
    assert float(S[0]) == 0.0 and float(S[1]) > 800.0


# ---------------------------------------------------------------- melt

@pytest.mark.parametrize("over", [{}, {
    "surface.debm_simple.std_dev.param_enabled": True,
    "surface.debm_simple.paleo.enabled": True}])
def test_melt_components(over):
    f = _fields()
    jm, tm = _models(f, over)
    T = f["Tj"] - 1.5
    for t in (0.55 * SPY, 0.2 * SPY, 3.71 * SPY):
        a = tm.melt_components(t, torch.tensor(T), torch.tensor(f["H"]),
                               torch.tensor(f["alb"]))
        b = jm.melt_components(t, jnp.asarray(T), jnp.asarray(f["H"]),
                               jnp.asarray(f["alb"]))
        for name, x, y in zip(("insol", "temp", "offset", "total"), a, b):
            _close(x, y, f"{name} at {t / SPY} a")
    # the JAX package's own checks on the port
    grid = Grid(Mx=5, My=5, Lx=50e3, Ly=50e3)
    g = _fields((5, 5))
    g.update(Ta=np.full((5, 5), 263.15), Tj=np.full((5, 5), 276.15),
             lat=np.full((5, 5), 70.0))
    _, m = _models(g)
    T_summer = torch.full(grid.shape2, 276.15, dtype=torch.float64)
    z = torch.zeros(grid.shape2, dtype=torch.float64)
    alb = torch.full(grid.shape2, 0.6, dtype=torch.float64)
    insol, temp, offset, total = m.melt_components(0.55 * SPY, T_summer, z,
                                                   alb)
    assert 0.5 < float(total[2, 2]) * SPY < 20.0
    assert float(insol[2, 2]) > 0.0 and float(temp[2, 2]) > 0.0 \
        and float(offset[2, 2]) < 0.0
    cold = m.melt_components(0.55 * SPY, torch.full_like(z, 260.0), z, alb)
    assert all(float(c.abs().max()) == 0.0 for c in cold)
    high = m.melt_components(0.55 * SPY, T_summer, torch.full_like(z, 2e3),
                             alb)[3]
    assert float(high[2, 2]) > float(total[2, 2])


def test_albedo_feedback():
    f = _fields()
    jm, tm = _models(f)
    melt = np.linspace(0.0, 20.0, 41) / SPY
    _close(tm.albedo_from_melt(torch.tensor(melt)),
           jm.albedo_from_melt(jnp.asarray(melt)), "albedo")
    assert float(tm.albedo_from_melt(torch.tensor(0.0))) \
        == pytest.approx(tm.albedo_max)
    assert float(tm.albedo_from_melt(torch.tensor(20.0 / SPY))) \
        == pytest.approx(tm.albedo_min)
    mid = float(tm.albedo_from_melt(torch.tensor(2.0 / SPY)))
    assert tm.albedo_min < mid < tm.albedo_max


def _updates(jm, tm, jg, tg, dt, steps, dtype, jdtype, close):
    t0 = tm.balance_year_start * SPY - 0.1 * SPY
    jc, tc = JCarry(None, None, None), SurfaceCarry()
    t = t0
    for _ in range(steps):
        b, jc = jm.update(jg, t, jnp.asarray(dt, jdtype), jc)
        a, tc = tm.update(tg, t, float(np.asarray(dt, jdtype)), tc)
        for name in ("smb", "temperature", "melt", "runoff", "accumulation"):
            close(getattr(a, name), getattr(b, name), name)
        close(tc.snow, jc.snow, "snow")
        close(tc.albedo, jc.albedo, "albedo")
        assert tc.firn is None
        t += float(np.asarray(dt, jdtype))
    return tc


@pytest.mark.parametrize("over", [{}, {
    "surface.debm_simple.refreeze_ice_melt": True,
    "surface.debm_simple.std_dev.param_enabled": True,
    "surface.debm_simple.max_evals_per_year": 20}, {
    "surface.debm_simple.interpret_precip_as_snow": True}])
def test_update_carries_snow_and_albedo(over):
    """Three updates of 0.37 a across a balance-year start from the same
    inputs (part of the domain ice-free: the ocean albedo), in float64."""
    f = _fields()
    f["H"][:2] = 0.0
    jm, tm = _models(f, over)
    assert tm.stateful and tm.uses_albedo
    jg, tg = _geoms(f)
    tc = _updates(jm, tm, jg, tg, 0.37 * SPY, 3, torch.float64, jnp.float64,
                  _close)
    a = _np(tc.albedo)
    assert a.min() >= tm.albedo_min and a.max() <= tm.albedo_max
    # a warmer summer melts more
    warm = dict(f, Tj=f["Tj"] + 7.0)
    _, tw = _models(warm, over)
    t0 = tm.balance_year_start * SPY
    cold, _ = tm.update(tg, t0, SPY, SurfaceCarry())
    hot, _ = tw.update(tg, t0, SPY, SurfaceCarry())
    assert float(hot.smb.sum()) < float(cold.smb.sum())


def test_update_float32():
    f = _fields()
    jm, tm = _models(f, dtype=torch.float32, jdtype=jnp.float32)
    jg, tg = _geoms(f, torch.float32, jnp.float32)
    _updates(jm, tm, jg, tg, 0.37 * SPY, 2, torch.float32, jnp.float32,
             _f32_close)


def test_prescribed_albedo_field():
    f = _fields()
    jg, tg = _geoms(f)
    out = {}
    for value in (0.47, 0.82):
        field = np.full(f["H"].shape, value)
        jm, tm = _models(f, albedo_field=field)
        t0 = tm.balance_year_start * SPY
        b, jc = jm.update(jg, t0, SPY, JCarry(None, None, None))
        a, tc = tm.update(tg, t0, SPY, SurfaceCarry())
        _close(a.smb, b.smb, "smb")
        _close(tc.albedo, jc.albedo, "albedo")
        out[value] = float(a.smb.sum())
    assert out[0.47] < out[0.82]


def test_climatology_matches():
    """The stateless annual climatology (``__call__``), whose interval is
    a float64 year in both packages."""
    f = _fields()
    jm, tm = _models(f)
    jg, tg = _geoms(f)
    for t in (0.0, 2.3 * SPY):
        a, b = tm(tg, t), jm(jg, t)
        _close(a.smb, b.smb, "smb")
        _close(a.temperature, b.temperature, "T")


# ------------------------------------------------------- factory, IceModel

def _dome(grid, H_max, R):
    r = np.asarray(grid.radius)
    return np.maximum(H_max * (1.0 - (r / R) ** 2), 0.0)


SIA = {"stress_balance.model": "sia",
       "stress_balance.sia.flow_law": "isothermal_glen",
       "energy.model": "none"}


@pytest.fixture(scope="module")
def end_to_end():
    """The factory's dEBM over a cosine cycle through ``IceModel.run``, 2 a
    on an 11x11 dome, in both packages."""
    from pism_tpu import Time as JTime
    from pism_tpu.coupler.factory import surface_from_config as j_surface
    from pism_tpu.model.icemodel import IceModel as JIceModel
    from pism_tpu.state import ModelState as JState
    from pism_tpu_torch import Time
    from pism_tpu_torch.coupler.factory import surface_from_config
    from pism_tpu_torch.model.icemodel import IceModel
    from pism_tpu_torch.state import ModelState

    grid = Grid(Mx=11, My=11, Lx=200e3, Ly=200e3)
    jgrid = JGrid(Mx=11, My=11, Lx=200e3, Ly=200e3)
    cfg = dict(SIA, **{"surface.models": "debm_simple"})
    H0 = _dome(grid, 2000.0, 150e3)
    shp = grid.shape2
    ja = j_atm.CosineYearlyCycle(
        temperature_mean_annual=jnp.full(shp, 258.15),
        temperature_mean_summer=jnp.full(shp, 274.15),
        precipitation=jnp.full(shp, 0.4 / SPY))
    ta = t_atm.CosineYearlyCycle(
        temperature_mean_annual=torch.full(shp, 258.15, dtype=torch.float64),
        temperature_mean_summer=torch.full(shp, 274.15, dtype=torch.float64),
        precipitation=torch.full(shp, 0.4 / SPY, dtype=torch.float64))
    js = j_surface(JConfig(cfg), inputs={"latitude": jnp.full(shp, 72.0)},
                   atmosphere=ja)
    ts = surface_from_config(Config(cfg), inputs={
        "latitude": torch.full(shp, 72.0, dtype=torch.float64)},
        atmosphere=ta)
    assert isinstance(ts, t_debm.DEBMSimple)
    jst, jstats = JIceModel(grid=jgrid, config=JConfig(cfg), surface=js).run(
        JState(geometry=j_geom(jnp.asarray(H0), jnp.zeros(shp))),
        JTime(0.0, 2.0 * SPY))
    tst, tstats = IceModel(grid=grid, config=Config(cfg), surface=ts,
                           device="cpu").run(
        ModelState(geometry=new_geometry(torch.tensor(H0),
                                         torch.zeros(shp,
                                                     dtype=torch.float64))),
        Time(0.0, 2.0 * SPY))
    return jst, jstats, tst, tstats


def test_factory_and_icemodel_end_to_end(end_to_end):
    jst, jstats, tst, tstats = end_to_end
    assert tstats.nsteps == int(jstats.nsteps)
    assert tst.surface_albedo is not None and tst.snow_depth is not None
    a = _np(tst.surface_albedo)
    assert np.all(np.isfinite(a)) and a.min() >= 0.469 and a.max() <= 0.821
    _close(tst.geometry.ice_thickness, jst.geometry.ice_thickness, "H",
           rel=1e-10)
    _close(tst.surface_albedo, jst.surface_albedo, "albedo", rel=1e-10)
    _close(tst.snow_depth, jst.snow_depth, "snow", rel=1e-10)


DIAGNOSTICS = ("insolation", "surface_albedo",
               "debm_insolation_driven_melt_flux",
               "debm_temperature_driven_melt_flux", "debm_offset_melt_flux")


@pytest.mark.parametrize("name", DIAGNOSTICS)
def test_debm_diagnostics_registry(name):
    from pism_tpu.model.diagnostics import SPATIAL as J_SPATIAL
    from pism_tpu.model.icemodel import IceModel as JIceModel
    from pism_tpu.state import ModelState as JState
    from pism_tpu_torch.model.diagnostics import SPATIAL
    from pism_tpu_torch.model.icemodel import IceModel
    from pism_tpu_torch.state import ModelState

    f = _fields((7, 7))
    jm, tm = _models(f)
    jg, tg = _geoms(f)
    grid = Grid(Mx=7, My=7, Lx=100e3, Ly=100e3)
    jmodel = JIceModel(grid=JGrid(Mx=7, My=7, Lx=100e3, Ly=100e3),
                       config=JConfig(SIA), surface=jm)
    tmodel = IceModel(grid=grid, config=Config(SIA), surface=tm,
                      device="cpu")
    jstate = JState(geometry=jg, surface_albedo=jnp.asarray(f["alb"]))
    tstate = ModelState(geometry=tg, surface_albedo=torch.tensor(f["alb"]))
    t = 0.55 * SPY
    val = SPATIAL[name].func(tstate, tmodel, t)
    _close(val, J_SPATIAL[name].func(jstate, jmodel, t), name)
    assert val.shape == grid.shape2 and bool(torch.isfinite(val).all())
    if name == "insolation":
        assert float(val.max()) > 100.0
    if name == "debm_offset_melt_flux":
        assert float(val.min()) < 0.0


def test_debm_restart_bit_stable(tmp_path):
    """A run stopped after 2 a, saved and restored, continues to 4 a equal
    to the uninterrupted run to the bit (albedo and snow are state)."""
    from pism_tpu_torch.io import checkpoint as ckpt
    from pism_tpu_torch.model.icemodel import IceModel
    from pism_tpu_torch.state import ModelState

    grid = Grid(Mx=11, My=11, Lx=200e3, Ly=200e3)
    f = _fields(grid.shape2)
    f.update(Tj=np.full(grid.shape2, 279.15), lat=np.full(grid.shape2, 70.0))
    _, m = _models(f)
    cfg = Config(SIA)
    model = IceModel(grid=grid, config=cfg, surface=m, device="cpu")
    s0 = model.prepare_state(ModelState(geometry=new_geometry(
        torch.tensor(_dome(grid, 1800.0, 150e3)),
        torch.zeros(grid.shape2, dtype=torch.float64))))
    sA, tA, _ = model.step_once(s0, 0.0, 2 * SPY)
    assert sA.surface_albedo is not None
    path = str(tmp_path / "restart_debm.nc")
    ckpt.save_state(path, sA, grid, tA, config=cfg, format="netcdf3")
    sB, tB = ckpt.load_state(path, device="cpu")
    assert tB == tA
    assert torch.equal(sB.surface_albedo, sA.surface_albedo)
    assert torch.equal(sB.snow_depth, sA.snow_depth)
    d1, _, _ = model.step_once(sA, tA, 4 * SPY - tA)
    d2, _, _ = model.step_once(sB, tB, 4 * SPY - tB)
    assert torch.equal(d1.geometry.ice_thickness, d2.geometry.ice_thickness)
    assert torch.equal(d1.surface_albedo, d2.surface_albedo)


def _orbit_file(path, grid):
    from pism_tpu.io.nc4 import File as JFile
    with JFile(path, "w") as f:
        f.define_dimension("time", None, attrs={"units": "years"})
        for name in ("eccentricity", "obliquity", "perihelion_longitude"):
            f.define_variable(name, ("time",))
        for k, (t, e, o, w) in enumerate([(-10000.0, 0.02, 24.0, 90.0),
                                          (0.0, 0.0167, 23.44, 102.947)]):
            f.append_time(t)
            f.write("eccentricity", np.asarray(e), time_index=k)
            f.write("obliquity", np.asarray(o), time_index=k)
            f.write("perihelion_longitude", np.asarray(w), time_index=k)


def test_paleo_and_albedo_files(tmp_path):
    """surface.debm_simple.paleo.file and albedo_input.file through both
    packages' ``inputs_from_files``: the same time-dependent orbit and
    prescribed albedo, the same update."""
    from pism_tpu.coupler import factory as j_cf
    from pism_tpu.io.nc4 import File as JFile
    from pism_tpu_torch.coupler import factory as t_cf

    grid = Grid(Mx=7, My=7, Lx=100e3, Ly=100e3)
    jgrid = JGrid(Mx=7, My=7, Lx=100e3, Ly=100e3)
    paleo, albf = str(tmp_path / "orbit.nc"), str(tmp_path / "alb.nc")
    _orbit_file(paleo, grid)
    with JFile(albf, "w") as f:
        f.define_dimension("y", grid.My, np.asarray(grid.y))
        f.define_dimension("x", grid.Mx, np.asarray(grid.x))
        f.define_variable("albedo", ("y", "x"), attrs={"units": "1"})
        f.write("albedo", np.full(grid.shape2, 0.55))
    cfg = {"surface.models": "debm_simple",
           "surface.debm_simple.paleo.enabled": True,
           "surface.debm_simple.paleo.file": paleo,
           "surface.debm_simple.albedo_input.file": albf}
    f = _fields(grid.shape2)
    jm0, tm0 = _models(f)
    ji = j_cf.inputs_from_files(JConfig(cfg), jgrid, "surface")
    ti = t_cf.inputs_from_files(Config(cfg), grid, "surface", "cpu")
    ji["latitude"], ti["latitude"] = (jnp.asarray(f["lat"]),
                                      torch.tensor(f["lat"]))
    jm = j_cf.surface_from_config(JConfig(cfg), ji, atmosphere=jm0.atmosphere)
    tm = t_cf.surface_from_config(Config(cfg), ti, atmosphere=tm0.atmosphere)
    assert tm.paleo_series is not None and tm.albedo_field is not None
    for t in (0.45 * SPY, -10000.0 * SPY + 0.45 * SPY, -3777.3 * SPY):
        d, dist = tm._orbit(t)
        jd, jdist = jm._orbit(t)
        assert d == pytest.approx(float(jd), rel=1e-12)
        assert dist == pytest.approx(float(jdist), rel=1e-12)
    assert abs(tm._orbit(0.45 * SPY)[0]
               - tm._orbit(-10000.0 * SPY + 0.45 * SPY)[0]) > 1e-4
    jg, tg = _geoms(f)
    b, jc = jm.update(jg, 0.0, SPY, JCarry(None, None, None))
    a, tc = tm.update(tg, 0.0, SPY, SurfaceCarry())
    _close(a.smb, b.smb, "smb")
    _close(tc.albedo, jc.albedo, "albedo")
    assert bool(torch.isfinite(a.smb).all())
