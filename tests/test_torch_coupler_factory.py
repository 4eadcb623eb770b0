"""The coupler factory and its models, pism_tpu_torch against pism_tpu on
the CPU in float64: every chain the port builds gives the same fields at a
few model times (1e-12 relative), built from the same inputs and from the
same forcing files (``inputs_from_files``), the PIK atmosphere and surface
and the ocean chains (``constant``, ``pik``, PICO with and without basins,
``delta_T``) included, and the names of the rest of the coupler (the
yearly cycle, one station, dEBM, ISMIP6-style ``th``, the modifiers); a
name neither package knows raises ValueError in both. Then the sea-level
update through one ``IceModel`` step, and the wiring of the config keys of
these modules, of every coupler model and modifier and of the PIK chain's
(PICO, calving, Lingle-Clark, the Mohr-Coulomb options): every key the JAX
twins read on these paths is read by the port or refused when set off its
default.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pism_tpu import Config as JConfig
from pism_tpu.coupler import factory as j_cf
from pism_tpu.grid import Grid as JGrid
from pism_tpu.io import bootstrap as j_boot
from pism_tpu.state import new_geometry as j_geom
from pism_tpu.util.forcing import ScalarForcing as JScalar
from pism_tpu_torch import Config, Grid, new_geometry
from pism_tpu_torch.coupler import factory as t_cf
from pism_tpu_torch.coupler.surface import SurfaceCarry
from pism_tpu_torch.io import bootstrap as t_boot
from pism_tpu_torch.io.nc4 import File
from pism_tpu_torch.util.forcing import ScalarForcing

torch.set_num_threads(2)

SPY = 3.15569259747e7
GRID = dict(Mx=9, My=11, Lx=400e3, Ly=500e3)
TIMES = [0.0, 0.3 * SPY, 1.7 * SPY, 5.2 * SPY]


def _fields():
    rng = np.random.default_rng(21)
    shp = (GRID["My"], GRID["Mx"])
    H = rng.uniform(0, 2500, shp)
    H[0] = 0.0
    bed = rng.uniform(-300, 800, shp)
    nt = 4
    return dict(
        H=H, bed=bed, lat=rng.uniform(60, 82, shp),
        lon=rng.uniform(-60, -20, shp),
        precip=rng.uniform(1e-9, 2e-8, shp),
        air_temp=rng.uniform(230, 275, (nt,) + shp),
        air_temp_summer=rng.uniform(260, 285, shp),
        precip_stack=rng.uniform(0, 3e-8, (nt,) + shp),
        smb_stack=rng.uniform(-3e-8, 3e-8, (nt,) + shp),
        tsfc_stack=rng.uniform(240, 273, (nt,) + shp),
        times=np.array([0.0, 0.5, 1.5, 3.0]) * SPY)


def _series():
    t, v = [0.0, 1.0, 2.5, 4.0], [0.0, -2.0, 1.5, 3.0]
    return t, v


def _inputs(f, pkg):
    """The factory inputs for every supported chain, in one package."""
    t, v = _series()
    if pkg == "jax":
        arr, S = jnp.asarray, JScalar
        times = jnp.asarray(f["times"])
    else:
        arr, S = (lambda a: torch.tensor(a)), ScalarForcing
        times = f["times"]
    return {
        "latitude": arr(f["lat"]), "longitude": arr(f["lon"]),
        "precipitation": arr(f["precip"]),
        "air_temp": arr(f["air_temp"]),
        "air_temp_summer": arr(f["air_temp_summer"]),
        "climatic_mass_balance": arr(f["smb_stack"]),
        "ice_surface_temp": arr(f["tsfc_stack"]), "times": times,
        "delta_T": S.from_arrays(t, v, periodic=True),
        "delta_P": S.from_arrays(t, np.asarray(v) * 1e-9),
        "delta_SL": S.from_arrays(t, np.asarray(v) * 10.0),
        "frac_P": S.from_arrays(t, 1.0 + 0.1 * np.asarray(v)),
        "reference_surface": arr(f["bed"] + 300.0),
        "air_temp_mean_annual": arr(f["air_temp"][0]),
        "air_temp_mean_summer": arr(f["air_temp_summer"]),
        "climatic_mass_balance_anomaly": arr(f["smb_stack"]),
        "ice_surface_temp_anomaly": arr(f["tsfc_stack"] - 255.0),
        "anomaly_times": times,
        "delta_SL_2D": arr(f["tsfc_stack"] - 255.0),
        "delta_SL_2D_times": times,
    }


def _chain_inputs(chain, f, pkg):
    """The inputs of one atmosphere chain: ``given`` takes a precipitation
    stack, ``one_station`` scalar series."""
    out = _given_precip_stack(_inputs(f, pkg), f, pkg)
    if chain.startswith("one_station"):
        S = JScalar if pkg == "jax" else ScalarForcing
        out["air_temp"] = S.from_arrays([0.0, 3.0], [245.0, 262.0])
        out["precipitation"] = S.from_arrays([0.0, 3.0], [1e-8, 2.5e-8])
    return out


def _given_precip_stack(inputs, f, pkg):
    out = dict(inputs)
    out["precipitation"] = jnp.asarray(f["precip_stack"]) if pkg == "jax" \
        else torch.tensor(f["precip_stack"])
    return out


def _geoms(f):
    return (j_geom(jnp.asarray(f["H"]), jnp.asarray(f["bed"])),
            new_geometry(torch.tensor(f["H"]), torch.tensor(f["bed"])))


def _np(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, want, name):
    got, want = _np(got), np.broadcast_to(_np(want), _np(got).shape)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(got - want).max() <= 1e-12 * scale, name


BASE = {"runtime.float_dtype": "float64",
        "atmosphere.uniform.precipitation": 350.0,
        "atmosphere.uniform.temperature": 250.0,
        "atmosphere.given.periodic": True}

ATMOSPHERE = ["uniform", "given", "searise_greenland",
              "searise_greenland,delta_T", "given,delta_T,delta_P",
              "uniform,delta_P", "pik", "pik,delta_T,delta_P",
              "yearly_cycle", "one_station", "uniform,elevation_change",
              "uniform,frac_P"]
SURFACE = [("simple", "searise_greenland"), ("uniform", "uniform"),
           ("given", "uniform"), ("given,delta_T", "uniform"),
           ("simple,delta_T", "given,delta_P"), ("pik", "uniform"),
           ("pik,delta_T", "pik"), ("elevation", "uniform"),
           ("debm_simple", "searise_greenland"),
           ("pdd,cache", "searise_greenland"), ("simple,anomaly", "uniform")]


@pytest.mark.parametrize("chain", ATMOSPHERE)
def test_atmosphere_chains_match(chain):
    f = _fields()
    jg, tg = _geoms(f)
    cfg = dict(BASE, **{"atmosphere.models": chain})
    jm = j_cf.atmosphere_from_config(JConfig(cfg),
                                     _chain_inputs(chain, f, "jax"))
    tm = t_cf.atmosphere_from_config(Config(cfg),
                                     _chain_inputs(chain, f, "torch"))
    for t in TIMES:
        for name, a, b in zip(("T", "T_july", "P"), tm(tg, t), jm(jg, t)):
            _close(a, b, f"{chain} {name} at {t / SPY} a")


def test_atmosphere_pik_summer_parameterization_matches():
    f = _fields()
    jg, tg = _geoms(f)
    cfg = dict(BASE, **{"atmosphere.models": "pik",
                        "atmosphere.pik.parameterization":
                        "martin_huybrechts_dewolde"})
    jm = j_cf.atmosphere_from_config(JConfig(cfg), _inputs(f, "jax"))
    tm = t_cf.atmosphere_from_config(Config(cfg), _inputs(f, "torch"))
    a, b = tm(tg, 0.0), jm(jg, 0.0)
    for name, x, y in zip(("T", "T_july", "P"), a, b):
        _close(x, y, name)
    assert not torch.equal(a.temperature, a.temperature_july)


@pytest.mark.parametrize("chain,atm", SURFACE)
def test_surface_chains_match(chain, atm):
    f = _fields()
    jg, tg = _geoms(f)
    cfg = dict(BASE, **{"atmosphere.models": atm, "surface.models": chain})
    ji, ti = _inputs(f, "jax"), _inputs(f, "torch")
    ja = j_cf.atmosphere_from_config(JConfig(cfg), ji)
    ta = t_cf.atmosphere_from_config(Config(cfg), ti)
    jm = j_cf.surface_from_config(JConfig(cfg), ji, atmosphere=ja)
    tm = t_cf.surface_from_config(Config(cfg), ti, atmosphere=ta)
    for t in TIMES:
        a, b = tm(tg, t), jm(jg, t)
        _close(a.smb, b.smb, f"{chain} smb at {t / SPY} a")
        _close(a.temperature, b.temperature, f"{chain} T at {t / SPY} a")


@pytest.mark.parametrize("chain", ["pdd", "pdd,delta_T"])
def test_pdd_chains_match(chain):
    """The stateful PDD (and a modifier over it): a 0.3 a update from the
    same carry, then a second one from the first's carry."""
    f = _fields()
    jg, tg = _geoms(f)
    cfg = dict(BASE, **{"atmosphere.models": "searise_greenland",
                        "surface.models": chain})
    ji, ti = _inputs(f, "jax"), _inputs(f, "torch")
    jm = j_cf.surface_from_config(
        JConfig(cfg), ji, atmosphere=j_cf.atmosphere_from_config(
            JConfig(cfg), ji))
    tm = t_cf.surface_from_config(
        Config(cfg), ti, atmosphere=t_cf.atmosphere_from_config(
            Config(cfg), ti))
    assert tm.stateful and jm.stateful
    from pism_tpu.coupler.surface import SurfaceCarry as JCarry
    z = np.zeros(f["H"].shape)
    jc, tc = JCarry(snow=jnp.asarray(z), firn=jnp.asarray(z)), \
        SurfaceCarry(snow=torch.tensor(z), firn=torch.tensor(z))
    for t in (0.4 * SPY, 0.7 * SPY):
        b, jc = jm.update(jg, t, jnp.asarray(0.3 * SPY), jc)
        a, tc = tm.update(tg, t, 0.3 * SPY, tc)
        for name in ("smb", "temperature", "melt", "runoff", "accumulation"):
            _close(getattr(a, name), getattr(b, name), f"{chain} {name}")
        _close(tc.snow, jc.snow, "snow")
        _close(tc.firn, jc.firn, "firn")


@pytest.mark.parametrize("chain", ["constant", "constant,delta_sl",
                                   "constant,delta_sl_2d"])
def test_sea_level_and_ocean_match(chain):
    f = _fields()
    jg, tg = _geoms(f)
    cfg = dict(BASE, **{"sea_level.models": chain,
                        "sea_level.constant.value": 3.0,
                        "sea_level.constant.delta_SL": 1.5})
    jm = j_cf.sea_level_from_config(JConfig(cfg), _inputs(f, "jax"))
    tm = t_cf.sea_level_from_config(Config(cfg), _inputs(f, "torch"))
    for t in TIMES:
        _close(tm(tg, t), jm(jg, t), f"{chain} at {t / SPY} a")
    jo = j_cf.ocean_from_config(JConfig(BASE))
    to = t_cf.ocean_from_config(Config(BASE))
    _close(to(tg, 0.0), jo(jg, 0.0), "ocean constant")


def _ocean_inputs(f, pkg, basins=True):
    rng = np.random.default_rng(8)
    shp = f["H"].shape
    theta = 272.8 + rng.uniform(0.0, 0.4, shp)
    salt = 34.6 + rng.uniform(0.0, 0.2, shp)
    b = np.where(np.arange(shp[1])[None, :] < shp[1] // 2, 1, 2) \
        * np.ones(shp, int)
    t, v = _series()
    if pkg == "jax":
        out = {"theta_ocean": jnp.asarray(theta),
               "salinity_ocean": jnp.asarray(salt),
               "delta_T": JScalar.from_arrays(t, v),
               "delta_SMB": JScalar.from_arrays(t, np.asarray(v) * 1e-9)}
        if basins:
            out["basins"] = jnp.asarray(b)
    else:
        out = {"theta_ocean": torch.tensor(theta),
               "salinity_ocean": torch.tensor(salt),
               "delta_T": ScalarForcing.from_arrays(t, v),
               "delta_SMB": ScalarForcing.from_arrays(t, np.asarray(v) * 1e-9)}
        if basins:
            out["basins"] = torch.tensor(b)
    return out


@pytest.mark.parametrize("chain,basins", [
    ("constant", True), ("constant,delta_T", True), ("pik", True),
    ("pik,delta_T", True), ("pico", True), ("pico", False),
    ("pico,delta_T", True), ("th", True), ("pik,delta_SMB", True)])
def test_ocean_chains_match(chain, basins):
    """Melt and shelf-base temperature of every ocean chain (``inputs``),
    and the melt the step takes (``__call__``)."""
    f = _fields()
    jg, tg = _geoms(f)
    cfg = dict(BASE, **{"ocean.models": chain})
    jm = j_cf.ocean_from_config(JConfig(cfg), _ocean_inputs(f, "jax", basins),
                                grid=JGrid(**GRID))
    tm = t_cf.ocean_from_config(Config(cfg),
                                _ocean_inputs(f, "torch", basins),
                                grid=Grid(**GRID))
    for t in TIMES:
        a, b = tm.inputs(tg, t), jm.inputs(jg, t)
        _close(a.shelf_base_melt, b.shelf_base_melt, f"{chain} melt")
        _close(a.shelf_base_temperature, b.shelf_base_temperature,
               f"{chain} T")
        _close(tm(tg, t), jm(jg, t), f"{chain} call")
    assert tm.water_column_pressure(tg, 0.0) is None \
        and jm.water_column_pressure(jg, 0.0) is None


def _write_forcing(d, f, nan=False):
    """The forcing files of ``inputs_from_files``; returns the config."""
    x, y = np.linspace(-420e3, 420e3, 12), np.linspace(-520e3, 520e3, 14)
    rng = np.random.default_rng(5)

    def stack(path, names, units, nt=None):
        with File(path, "w") as fh:
            if nt:
                fh.define_dimension("time", None, attrs={
                    "units": "years since 1-1-1"})
            fh.define_dimension("y", y.size, y)
            fh.define_dimension("x", x.size, x)
            for k in range(nt or 1):
                if nt:
                    n = fh.append_time(0.5 * k)
                for name, u in zip(names, units):
                    lo, hi = {"K": (240, 270), "kg m-2 year-1": (0, 800),
                              "degree_north": (60, 80),
                              "degree_east": (-60, -20)}[u]
                    a = rng.uniform(lo, hi, (y.size, x.size))
                    if nan and name == "precipitation":
                        a[:3, :3] = np.nan
                    if nt:
                        fh.write(name, a[None], ("time", "y", "x"),
                                 {"units": u}, time_index=n)
                    else:
                        fh.write(name, a, ("y", "x"), {"units": u})

    def series(path, name):
        t, v = _series()
        with File(path, "w") as fh:
            fh.define_dimension("time", len(t), np.asarray(t), attrs={
                "units": "years since 1-1-1"})
            fh.write(name, np.asarray(v), ("time",))

    p = {k: str(d / f"{k}.nc") for k in ("agiven", "searise", "dT", "dP",
                                        "sgiven", "sdT", "dsl")}
    stack(p["agiven"], ["air_temp", "precipitation"],
          ["K", "kg m-2 year-1"], nt=3)
    stack(p["searise"], ["lat", "lon", "precipitation"],
          ["degree_north", "degree_east", "kg m-2 year-1"])
    stack(p["sgiven"], ["ice_surface_temp"], ["K"], nt=3)
    with File(p["sgiven"], "a") as fh:
        fh.write("climatic_mass_balance",
                 rng.uniform(-500, 500, (3, y.size, x.size)),
                 ("time", "y", "x"), {"units": "kg m-2 year-1"})
    for k, name in (("dT", "delta_T"), ("dP", "delta_P"), ("sdT", "delta_T"),
                    ("dsl", "delta_SL")):
        series(p[k], name)
    return {"atmosphere.given.file": p["agiven"],
            "atmosphere.searise_greenland.file": p["searise"],
            "atmosphere.delta_T.file": p["dT"],
            "atmosphere.delta_P.file": p["dP"],
            "atmosphere.delta_P.periodic": True,
            "surface.given.file": p["sgiven"],
            "surface.delta_T.file": p["sdT"],
            "sea_level.delta_sl.file": p["dsl"]}


@pytest.mark.parametrize("atm,surf,sl", [
    ("given,delta_T,delta_P", "simple", "constant,delta_sl"),
    ("searise_greenland,delta_T", "given,delta_T", "constant"),
])
def test_chains_from_files_match(tmp_path, atm, surf, sl):
    f = _fields()
    jg, tg = _geoms(f)
    cfg = dict(BASE, **_write_forcing(tmp_path, f),
               **{"atmosphere.models": atm, "surface.models": surf,
                  "sea_level.models": sl})
    jc, tc = JConfig(cfg), Config(cfg)
    jgrid, tgrid = JGrid(**GRID), Grid(**GRID)
    ja = j_cf.atmosphere_from_config(
        jc, j_cf.inputs_from_files(jc, jgrid, "atmosphere"))
    ta = t_cf.atmosphere_from_config(
        tc, t_cf.inputs_from_files(tc, tgrid, "atmosphere", "cpu"))
    js = j_cf.surface_from_config(
        jc, j_cf.inputs_from_files(jc, jgrid, "surface"), atmosphere=ja)
    ts = t_cf.surface_from_config(
        tc, t_cf.inputs_from_files(tc, tgrid, "surface", "cpu"), atmosphere=ta)
    jl = j_cf.sea_level_from_config(
        jc, j_cf.inputs_from_files(jc, jgrid, "sea_level"))
    tl = t_cf.sea_level_from_config(
        tc, t_cf.inputs_from_files(tc, tgrid, "sea_level", "cpu"))
    for t in TIMES:
        a, b = ts(tg, t), js(jg, t)
        _close(a.smb, b.smb, f"smb at {t / SPY}")
        _close(a.temperature, b.temperature, f"T at {t / SPY}")
        _close(tl(tg, t), jl(jg, t), f"sea level at {t / SPY}")


def test_ocean_from_files_matches(tmp_path):
    """PICO from ``ocean.pico.file`` (theta_ocean, salinity_ocean) and
    ``ocean.pico.basins_file``, with ``ocean.delta_T.file``."""
    f = _fields()
    jg, tg = _geoms(f)
    g = Grid(**GRID)
    rng = np.random.default_rng(9)
    pico, bas, dT = (str(tmp_path / n) for n in ("pico.nc", "basins.nc",
                                                 "dT.nc"))
    with File(pico, "w") as fh:
        fh.define_dimension("y", g.My, g.y)
        fh.define_dimension("x", g.Mx, g.x)
        fh.write("theta_ocean", 272.8 + rng.uniform(0, 0.4, g.shape2),
                 ("y", "x"), {"units": "K"})
        fh.write("salinity_ocean", 34.6 + rng.uniform(0, 0.2, g.shape2),
                 ("y", "x"), {"units": "g/kg"})
    with File(bas, "w") as fh:
        fh.define_dimension("y", g.My, g.y)
        fh.define_dimension("x", g.Mx, g.x)
        fh.write("basins", np.where(g.x[None, :] < 0, 1.0, 2.0)
                 * np.ones(g.shape2), ("y", "x"))
    t, v = _series()
    with File(dT, "w") as fh:
        fh.define_dimension("time", len(t), np.asarray(t), attrs={
            "units": "years since 1-1-1"})
        fh.write("delta_T", np.asarray(v), ("time",))
    cfg = dict(BASE, **{"ocean.models": "pico,delta_T",
                        "ocean.pico.file": pico,
                        "ocean.pico.basins_file": bas,
                        "ocean.delta_T.file": dT})
    jc, tc = JConfig(cfg), Config(cfg)
    ji = j_cf.inputs_from_files(jc, JGrid(**GRID), "ocean")
    ti = t_cf.inputs_from_files(tc, Grid(**GRID), "ocean", "cpu")
    assert sorted(ti) == sorted(ji) == ["basins", "delta_T", "salinity_ocean",
                                        "theta_ocean"]
    jm = j_cf.ocean_from_config(jc, ji, grid=JGrid(**GRID))
    tm = t_cf.ocean_from_config(tc, ti, grid=Grid(**GRID))
    for t in TIMES:
        a, b = tm.inputs(tg, t), jm.inputs(jg, t)
        _close(a.shelf_base_melt, b.shelf_base_melt, "melt")
        _close(a.shelf_base_temperature, b.shelf_base_temperature, "T")


def test_forcing_that_does_not_cover_the_grid_raises(tmp_path):
    f = _fields()
    cfg = dict(BASE, **_write_forcing(tmp_path, f, nan=True))
    with pytest.raises(ValueError, match="does not cover"):
        j_cf.inputs_from_files(JConfig(cfg), JGrid(**GRID), "atmosphere")
    with pytest.raises(ValueError, match="does not cover"):
        t_cf.inputs_from_files(Config(cfg), Grid(**GRID), "atmosphere", "cpu")


@pytest.mark.parametrize("key,chain,exc", [
    ("atmosphere.models", "no_such_model", ValueError),
    ("surface.models", "simple,no_such_modifier", ValueError),
    ("sea_level.models", "tides", ValueError),
])
def test_unported_names_raise(key, chain, exc):
    """A name neither package knows: ValueError in both."""
    for cf, C in ((j_cf, JConfig), (t_cf, Config)):
        cfg = C(dict(BASE, **{key: chain}))
        build = {"atmosphere.models": cf.atmosphere_from_config,
                 "ocean.models": cf.ocean_from_config,
                 "sea_level.models": cf.sea_level_from_config}.get(key)
        with pytest.raises(exc, match="unknown"):
            if build is None:
                cf.surface_from_config(cfg, {}, atmosphere=cf.
                                       atmosphere_from_config(C(BASE)))
            else:
                build(cfg, {})


@pytest.mark.parametrize("key", ["atmosphere.given.period",
                                 "atmosphere.given.periodic"])
def test_stack_period_matches(key):
    times = np.array([0.0, 1.0, 2.0, 3.0]) * SPY / 12
    over = {key: True if key.endswith("periodic") else 2.0}
    assert t_cf.stack_period(Config(over), "atmosphere.given", times) == \
        j_cf.stack_period(JConfig(over), "atmosphere.given", times)


# -- sea level through one IceModel step ---------------------------------

SIA = {"runtime.float_dtype": "float64", "stress_balance.model": "sia",
       "stress_balance.sia.flow_law": "isothermal_glen",
       "energy.model": "none", "sea_level.models": "constant,delta_sl"}


def _marine(grid_kw):
    x = np.linspace(-1, 1, grid_kw["Mx"])
    X, Y = np.meshgrid(x, np.linspace(-1, 1, grid_kw["My"]))
    r2 = X ** 2 + Y ** 2
    H = 1500.0 * np.maximum(1 - r2, 0.0) ** 0.5
    bed = -50.0 + 400.0 * (0.6 - r2)
    return H, bed


@pytest.fixture(scope="module")
def sea_level_step():
    from pism_tpu.coupler.surface import Uniform as JUniform
    from pism_tpu.model.icemodel import IceModel as JIceModel
    from pism_tpu.state import ModelState as JModelState
    from pism_tpu_torch.coupler.surface import Uniform
    from pism_tpu_torch.model.icemodel import IceModel
    from pism_tpu_torch.state import ModelState

    kw = dict(Mx=15, My=15, Lx=300e3, Ly=300e3)
    H, bed = _marine(kw)
    t, v = [0.0, 10.0], [200.0, 300.0]
    jsl = j_cf.sea_level_from_config(JConfig(SIA), {
        "delta_SL": JScalar.from_arrays(t, v)})
    tsl = t_cf.sea_level_from_config(Config(SIA), {
        "delta_SL": ScalarForcing.from_arrays(t, v)})
    jm = JIceModel(grid=JGrid(**kw), config=JConfig(SIA),
                   surface=JUniform(smb=1e-9), sea_level=jsl)
    out = {}
    for name, sl in (("torch", tsl), ("none", None)):
        tm = IceModel(grid=Grid(**kw), config=Config(SIA),
                      surface=Uniform(smb=1e-9), sea_level=sl, device="cpu")
        s0 = ModelState(geometry=new_geometry(torch.tensor(H),
                                              torch.tensor(bed)))
        out[name] = tm.step_once(s0, 0.5 * SPY, 2.0 * SPY)
    js, jt, jst = jm.step_once(
        JModelState(geometry=j_geom(jnp.asarray(H), jnp.asarray(bed))),
        0.5 * SPY, 2.0 * SPY)
    out["jax"] = (js, float(jt), jst)
    return out


def test_sea_level_step_matches(sea_level_step):
    (ts, tt, st), (js, jt, jst) = sea_level_step["torch"], \
        sea_level_step["jax"]
    assert st.nsteps == int(jst.nsteps) and tt == pytest.approx(jt)
    g, jg = ts.geometry, js.geometry
    np.testing.assert_array_equal(g.cell_type.numpy(), np.asarray(jg.cell_type))
    for name in ("sea_level", "ice_thickness", "ice_surface_elevation"):
        _close(getattr(g, name), getattr(jg, name), name)
    # the offset moved the sea level, and it changed the mask
    assert float(g.sea_level.min()) > 200.0
    none = sea_level_step["none"][0].geometry
    assert not torch.equal(none.cell_type, g.cell_type)


def test_constant_zero_sea_level_is_bit_equal():
    """A constant sea level at the state's own value changes nothing."""
    from pism_tpu_torch.coupler.sealevel import Constant
    from pism_tpu_torch.coupler.surface import Uniform
    from pism_tpu_torch.model.icemodel import IceModel
    from pism_tpu_torch.state import ModelState

    kw = dict(Mx=11, My=11, Lx=300e3, Ly=300e3)
    H, bed = _marine(kw)
    res = []
    for sl in (None, Constant(0.0)):
        tm = IceModel(grid=Grid(**kw), config=Config(SIA),
                      surface=Uniform(smb=1e-9), sea_level=sl, device="cpu")
        s0 = ModelState(geometry=new_geometry(torch.tensor(H),
                                              torch.tensor(bed)))
        res.append(tm.step_once(s0, 0.0, 3.0 * SPY)[0].geometry)
    for f_ in dataclasses.fields(res[0]):
        assert torch.equal(getattr(res[0], f_.name), getattr(res[1], f_.name))


# -- parameter wiring of this slice's modules ----------------------------

def _off_default(value):
    if isinstance(value, bool):
        return not value
    if isinstance(value, (int, float)):
        return value * 2 + 1
    return "x.nc" if not value else value + "_x"


def _jax_reads(run):
    cfg = JConfig(dict(BASE))
    run(cfg)
    return set(cfg.used_parameters())


def _port_reads(run, over=None):
    cfg = Config(dict(BASE, **(over or {})))
    run(cfg)
    return set(cfg.used_parameters())


def _wiring_paths(tmp_path):
    """(name, jax run, port run) of each path of modules 3-11 the port
    supports and of the PIK chain's modules, each a function of a
    config."""
    f = _fields()
    boot = str(tmp_path / "boot.nc")
    from pism_tpu_torch.examples.std_greenland_workflow import (
        synthesize_bootstrap_file)
    synthesize_bootstrap_file(boot, 100.0)
    files = _write_forcing(tmp_path, f)
    grid3 = dict(Mx=16, My=29, Mz=11, Lx=750e3, Ly=1400e3, Lz=4000.0)
    ji, ti = _inputs(f, "jax"), _inputs(f, "torch")

    def chains(cf, inputs, grid, dev):
        def run(cfg):
            cfg.update(files)
            cfg.update({"atmosphere.models": "searise_greenland,delta_T",
                        "surface.models": "pdd,delta_T",
                        "sea_level.models": "constant,delta_sl"})
            extra = () if dev is None else (dev,)
            a = cf.atmosphere_from_config(
                cfg, dict(inputs, **cf.inputs_from_files(
                    cfg, grid, "atmosphere", *extra)))
            cf.surface_from_config(cfg, dict(inputs, **cf.inputs_from_files(
                cfg, grid, "surface", *extra)), atmosphere=a)
            cf.ocean_from_config(cfg, cf.inputs_from_files(
                cfg, grid, "ocean", *extra))
            cf.sea_level_from_config(cfg, dict(inputs, **cf.inputs_from_files(
                cfg, grid, "sea_level", *extra)))
            cfg.update({"atmosphere.models": "given,delta_P",
                        "surface.models": "given"})
            cf.atmosphere_from_config(cfg, inputs)
            cf.surface_from_config(cfg, inputs)
            cfg.update({"atmosphere.models": "uniform"})
            cf.atmosphere_from_config(cfg, inputs)
        return run

    return [
        ("bootstrap",
         lambda cfg: j_boot.bootstrap(boot, JGrid(**grid3), cfg),
         lambda cfg: t_boot.bootstrap(boot, Grid(**grid3), cfg,
                                      device="cpu")),
        ("factory", chains(j_cf, ji, JGrid(**GRID), None),
         chains(t_cf, ti, Grid(**GRID), "cpu")),
        ("pik", _pik_path("jax", f), _pik_path("torch", f)),
        ("coupler", _coupler_path("jax", f, tmp_path),
         _coupler_path("torch", f, tmp_path)),
    ]


#: every model and modifier of the coupler's four factories
COUPLER_CHAINS = {
    "atmosphere.models": [
        "uniform,elevation_change,delta_T,delta_P,frac_P,precip_scaling,"
        "anomaly,orographic_precipitation", "given", "searise_greenland",
        "yearly_cycle", "pik", "one_station"],
    "surface.models": [
        "simple,anomaly,delta_T,cache,elevation_change,force_to_thickness",
        "uniform", "given", "elevation", "pdd", "debm_simple", "pik",
        "ismip6"],
    "ocean.models": [
        "constant,anomaly,delta_T,delta_SMB,frac_SMB,runoff_SMB,frac_MBP,"
        "delta_MBP,cache", "pik", "th", "given", "pico"],
    "sea_level.models": ["constant,delta_sl,delta_sl_2d"],
}


def _ismip6_files(d):
    """The ISMIP6 reference and forcing files on the factory test's grid."""
    g = Grid(**GRID)
    ref, frc = str(d / "ismip6_ref.nc"), str(d / "ismip6.nc")
    with File(ref, "w", format="netcdf3") as fh:
        fh.define_dimension("y", g.My, g.y)
        fh.define_dimension("x", g.Mx, g.x)
        for name, v in (("climatic_mass_balance", 100.0),
                        ("ice_surface_temp", 250.0), ("usurf", 900.0)):
            fh.write(name, np.full(g.shape2, v), ("y", "x"))
    with File(frc, "w", format="netcdf3") as fh:
        fh.define_dimension("time", None, attrs={"units": "years"})
        fh.define_dimension("y", g.My, g.y)
        fh.define_dimension("x", g.Mx, g.x)
        for k in range(2):
            n = fh.append_time(float(k))
            for name in ("climatic_mass_balance_anomaly",
                         "ice_surface_temp_anomaly",
                         "climatic_mass_balance_gradient",
                         "ice_surface_temp_gradient"):
                fh.write(name, np.full((1,) + g.shape2, 0.1 * k),
                         ("time", "y", "x"), time_index=n)
    return {"surface.ismip6.reference_file": ref, "surface.ismip6.file": frc}


def _coupler_path(pkg, f, d):
    """Every coupler model and modifier built, with the PDD's and dEBM's
    options on, through both packages' factories."""
    files = _ismip6_files(d)
    if pkg == "jax":
        cf, grid, geoms, arr = j_cf, JGrid(**GRID), _geoms(f)[0], jnp.asarray
        S = JScalar
    else:
        cf, grid, geoms = t_cf, Grid(**GRID), _geoms(f)[1]
        arr, S = torch.tensor, ScalarForcing
    t, v = _series()
    one = S.from_arrays(t, np.ones(len(t)))
    inputs = dict(_inputs(f, pkg), **_ocean_inputs(f, pkg))
    inputs.update({
        "scaling": one, "frac_SMB": one, "frac_MBP": one,
        "delta_MBP": one, "target_thickness": arr(f["H"]),
        "melt_anomaly": arr(f["smb_stack"]),
        "shelf_base_mass_flux": arr(f["smb_stack"]), "_grid": grid,
        "_device": "cpu"})

    def run(cfg):
        cfg.update(files)
        cfg.update({"surface.pdd.fausto.enabled": True,
                    "surface.pdd.std_dev.param_enabled": True,
                    "surface.pdd.std_dev.lapse_lat_rate": 0.1,
                    "ocean.melange_back_pressure_fraction": 0.5})
        atm = None
        for key, chains in COUPLER_CHAINS.items():
            for chain in chains:
                cfg.update({key: chain})
                if key == "atmosphere.models":
                    ins = _chain_inputs(chain, f, pkg) if chain.startswith(
                        ("given", "one_station")) else inputs
                    m = cf.atmosphere_from_config(cfg, ins, grid=grid)
                    if atm is None:
                        atm = m
                elif key == "surface.models":
                    m = cf.surface_from_config(cfg, inputs, atmosphere=atm)
                elif key == "ocean.models":
                    m = cf.ocean_from_config(cfg, inputs, grid=grid)
                    m.inputs(geoms, 0.0)
                    m.water_column_pressure(geoms, 0.0)
                else:
                    m = cf.sea_level_from_config(cfg, inputs)
    return run


def _pik_path(pkg, f):
    """The PIK chain's modules: the pik couplers, PICO with basins and the
    ocean delta_T, every calving law, Lingle-Clark and the Mohr-Coulomb
    options of this slice."""
    if pkg == "jax":
        from pism_tpu.model import beddef, calving
        from pism_tpu.physics import basal
        cf, grid, geoms = j_cf, JGrid(**GRID), _geoms(f)[0]
        state = __import__("pism_tpu.state", fromlist=["x"]).ModelState(
            geometry=geoms)
    else:
        from pism_tpu_torch.model import beddef, calving
        from pism_tpu_torch.physics import basal
        from pism_tpu_torch.state import ModelState
        cf, grid, geoms = t_cf, Grid(**GRID), _geoms(f)[1]
        state = ModelState(geometry=geoms)
    inputs = dict(_inputs(f, pkg), **_ocean_inputs(f, pkg))

    def run(cfg):
        cfg.update({"atmosphere.models": "pik", "surface.models": "pik",
                    "ocean.models": "pico,delta_T",
                    "calving.methods": "eigen_calving,vonmises_calving,"
                    "hayhurst_calving,thickness_calving,float_kill",
                    "bed_deformation.model": "lc",
                    "basal_yield_stress.mohr_coulomb.topg_to_phi.enabled":
                    True,
                    "basal_yield_stress.slippery_grounding_lines": True})
        a = cf.atmosphere_from_config(cfg, inputs)
        cf.surface_from_config(cfg, inputs, atmosphere=a)
        cf.ocean_from_config(cfg, inputs, grid=grid).inputs(geoms, 0.0)
        cfg.update({"ocean.models": "pik"})
        cf.ocean_from_config(cfg, inputs, grid=grid)
        calving.CalvingModel(grid=grid, config=cfg)
        beddef.LingleClark(grid=grid, config=cfg).initialize(state)
        y = basal.MohrCoulombYieldStress(cfg)
        y.compute(state.replace(till_phi=y.topg_to_phi(
            geoms.bed_elevation)))
    return run


#: keys the JAX twins read whose value matters only through another key
#: (the gate), which the port refuses off its default: the gate is tested
_OPT = "basal_yield_stress.mohr_coulomb.tillphi_opt."
GATED_PIK = {
    **{_OPT + k: _OPT + "enabled"
       for k in ("dh_min", "dphi_max", "dphi_scale", "dt", "phi_max",
                 "phi_min")},
}
GATED = dict(GATED_PIK)
#: read by the JAX PDD and never used there (pism_tpu/coupler/pdd.py:83)
UNUSED = {"constants.fresh_water.density"}


def test_parameter_wiring(tmp_path):
    """Every key the JAX twins read on the supported paths of bootstrapping
    and the coupler factory, and with every coupler model and modifier
    built, is read by the port on the same path, or the port raises
    NotImplementedError when it (or the key that gates its use) is set off
    its default."""
    from pism_tpu_torch.config.parameters import PARAMETERS
    unread = {}
    for name, jrun, trun in _wiring_paths(tmp_path):
        missing = _jax_reads(jrun) - _port_reads(trun) - UNUSED
        for key in sorted(missing):
            key = GATED.get(key, key)
            with pytest.raises(NotImplementedError):
                _port_reads(trun, {key: _off_default(PARAMETERS[key][0])})
        unread[name] = missing
    # (a refusal reads its key too: what is left are the gated keys)
    assert unread == {"bootstrap": set(), "factory": set(),
                      "pik": set(GATED_PIK), "coupler": set()}


def test_cli_sections_name_their_keys():
    """The config keys that the JAX CLI's bootstrap, regrid, projection,
    coupler and Dirichlet sections read are all named by the port's CLI
    (``pism_tpu/cli.py:479-547, :675-768, :827-846``)."""
    import pathlib
    import re
    root = pathlib.Path(__file__).resolve().parents[1]
    lines = (root / "pism_tpu" / "cli.py").read_text().splitlines()
    sections = [lines[a - 1:b] for a, b in ((479, 547), (675, 768),
                                            (827, 846))]
    keys = set(re.findall(r'"([a-z_]+(?:\.[A-Za-z_0-9]+)+)"',
                          "\n".join("\n".join(s) for s in sections)))
    keys = {k for k in keys if "." in k and not k.endswith((".nc", ".json"))}
    port = (root / "pism_tpu_torch" / "cli.py").read_text()
    assert keys and all(f'"{k}"' in port for k in keys), \
        sorted(k for k in keys if f'"{k}"' not in port)
