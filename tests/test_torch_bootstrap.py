"""Bootstrapping, pism_tpu_torch against pism_tpu on the CPU in float64:
``io.bootstrap.bootstrap`` on the same data file gives the same state,
every field within 1e-12 (relative to its max): with and without a
``bheatflx`` map, under the ``smb`` heuristic (the Robin profile, with a
``climatic_mass_balance`` field) and ``quartic_guess``, on a model grid
that is coarser than the file's and wider than its extent. Also
``read_forcing_fields`` on a time stack with unit conversions and a dated
time axis, ``bootstrap_enthalpy`` itself, and the inputs the port refuses.
"""

import numpy as np
import pytest
import torch

from pism_tpu import Config as JConfig
from pism_tpu.grid import Grid as JGrid
from pism_tpu.io import bootstrap as j_boot
from pism_tpu.model.energy import bootstrap_enthalpy as j_bootstrap_enthalpy
from pism_tpu.physics.enthalpy_converter import EnthalpyConverter as JEC
from pism_tpu_torch import Config, Grid
from pism_tpu_torch.convert import state_to_numpy
from pism_tpu_torch.io import bootstrap as t_boot
from pism_tpu_torch.io.nc4 import File
from pism_tpu_torch.model.energy import bootstrap_enthalpy
from pism_tpu_torch.physics.enthalpy_converter import EnthalpyConverter

torch.set_num_threads(2)

SPY = 3.15569259747e7
GRID = dict(Mx=13, My=17, Mz=11, Lx=620e3, Ly=820e3, Lz=4000.0)


def _data_file(path, fmt="netcdf4", bheatflx=True, cmb=True, extra=()):
    """A 21x27 data file over 1200 x 1600 km (the model grid above spans
    1240 x 1640 km, so its edges lie outside it)."""
    rng = np.random.default_rng(1)
    x, y = np.linspace(-600e3, 600e3, 21), np.linspace(-800e3, 800e3, 27)
    X, Y = np.meshgrid(x, y)
    r2 = (X / 450e3) ** 2 + (Y / 650e3) ** 2
    thk = 3000.0 * np.maximum(1 - r2, 0.0) ** 0.5
    thk[3, 4] = np.nan                      # missing data: the default
    bed = 300.0 - 700.0 * r2 + 50.0 * rng.normal(size=X.shape)
    tsfc = 273.15 - 25.0 + 10.0 * rng.random(X.shape) + 3.0
    with File(str(path), "w", format=fmt) as f:
        f.define_dimension("y", y.size, y, attrs={"units": "m"})
        f.define_dimension("x", x.size, x, attrs={"units": "m"})
        f.write("thk", thk, ("y", "x"), {"units": "m"})
        f.write("topg", bed, ("y", "x"), {"units": "m"})
        f.write("ice_surface_temp", tsfc, ("y", "x"), {"units": "K"})
        f.write("tillwat", rng.uniform(0, 2, X.shape), ("y", "x"),
                {"units": "m"})
        f.write("bmelt", rng.uniform(0, 1e-9, X.shape), ("y", "x"),
                {"units": "m s-1"})
        if bheatflx:
            f.write("bheatflx", rng.uniform(0.04, 0.09, X.shape), ("y", "x"),
                    {"units": "W m-2"})
        if cmb:
            f.write("climatic_mass_balance",
                    rng.uniform(50, 600, X.shape), ("y", "x"),
                    {"units": "kg m-2 year-1"})
        for name in extra:
            f.write(name, rng.uniform(0, 1, X.shape), ("y", "x"), {})
    return str(path)


def _jax_state(st):
    import dataclasses
    d = {f.name: np.asarray(getattr(st.geometry, f.name))
         for f in dataclasses.fields(st.geometry)}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if f.name != "geometry" and v is not None:
            d[f.name] = np.asarray(v)
    return d


def _both(path, over):
    over = dict({"runtime.float_dtype": "float64"}, **over)
    js = j_boot.bootstrap(path, JGrid(**GRID), JConfig(over))
    ts = t_boot.bootstrap(path, Grid(**GRID), Config(over), device="cpu")
    return _jax_state(js), state_to_numpy(ts)


@pytest.mark.parametrize("case,over,kw", [
    ("smb_robin", {}, dict(bheatflx=False)),
    ("smb_robin_bheatflx", {}, {}),
    ("smb_no_cmb", {}, dict(cmb=False)),
    ("quartic_guess", {"bootstrapping.temperature_heuristic":
                       "quartic_guess"}, {}),
    ("classic_extrapolation", {"grid.allow_extrapolation": True},
     dict(fmt="netcdf3")),
])
def test_bootstrap_matches(tmp_path, case, over, kw):
    path = _data_file(tmp_path / "boot.nc", **kw)
    j, t = _both(path, over)
    assert sorted(t) == sorted(j), case
    for name in j:
        if j[name].dtype.kind in "iub":
            np.testing.assert_array_equal(t[name], j[name], err_msg=name)
            continue
        assert t[name].dtype == np.float64, name
        scale = max(np.abs(j[name]).max(), 1e-300)
        assert np.abs(t[name] - j[name]).max() <= 1e-12 * scale, name
    assert np.isfinite(t["enthalpy"]).all()


def test_robin_profile_differs_from_conduction(tmp_path):
    """The default heuristic reaches the Robin profile (the file's SMB
    changes E), and the conduction profile is what prepare_state uses."""
    path = _data_file(tmp_path / "boot.nc")
    _, robin = _both(path, {})
    _, cond = _both(path, {"bootstrapping.temperature_heuristic":
                           "quartic_guess"})
    assert np.abs(robin["enthalpy"] - cond["enthalpy"]).max() > 1.0


@pytest.mark.parametrize("g2d", [False, True])
@pytest.mark.parametrize("heuristic", ["smb", "quartic_guess"])
def test_bootstrap_enthalpy_matches(g2d, heuristic):
    rng = np.random.default_rng(4)
    grid = Grid(Mx=6, My=5, Mz=21, Lx=1e5, Ly=1e5, Lz=4000.0)
    H = rng.uniform(0, 3500, (5, 6))
    H[0, 0] = 0.0
    H[0, 1] = 0.5
    Ts = rng.uniform(240, 273, H.shape)
    smb = rng.uniform(-1e-9, 2e-8, H.shape)
    G = rng.uniform(0.03, 0.1, H.shape) if g2d else 0.05
    jcfg = JConfig()
    got = bootstrap_enthalpy(grid, EnthalpyConverter.from_config(Config()),
                             torch.tensor(H), torch.tensor(Ts),
                             smb=torch.tensor(smb),
                             geothermal=torch.tensor(G) if g2d else G,
                             k_i=2.1, heuristic=heuristic, rho=910.0,
                             c_i=2009.0)
    want = j_bootstrap_enthalpy(JGrid(Mx=6, My=5, Mz=21, Lx=1e5, Ly=1e5,
                                      Lz=4000.0), JEC.from_config(jcfg),
                                H, Ts, smb=smb, geothermal=G, k_i=2.1,
                                heuristic=heuristic, rho=910.0, c_i=2009.0)
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()


def test_read_forcing_fields_matches(tmp_path):
    """A (time, y, x) stack with a dated time axis under a calendar, and
    unit conversions: Celsius to K, kg m-2 year-1 and m year-1 to m s-1."""
    rng = np.random.default_rng(9)
    path = str(tmp_path / "forcing.nc")
    x, y = np.linspace(-600e3, 600e3, 21), np.linspace(-800e3, 800e3, 27)
    with File(path, "w") as f:
        f.define_dimension("time", None, attrs={
            "units": "days since 1980-1-1", "calendar": "365_day"})
        f.define_dimension("y", y.size, y, attrs={"units": "m"})
        f.define_dimension("x", x.size, x, attrs={"units": "m"})
        for k in range(4):
            n = f.append_time(15.0 + 30.0 * k)
            f.write("air_temp", rng.normal(-10, 5, (1, 27, 21)),
                    ("time", "y", "x"), {"units": "degC"}, time_index=n)
            f.write("precipitation", rng.uniform(0, 900, (1, 27, 21)),
                    ("time", "y", "x"), {"units": "kg m-2 year-1"},
                    time_index=n)
        f.write("climatic_mass_balance", rng.uniform(-2, 2, (27, 21)),
                ("y", "x"), {"units": "m year-1"})
    names = ["air_temp", "precipitation", "climatic_mass_balance", "absent"]
    kw = dict(calendar="365_day", reference_date="1970-1-1")
    jf, jt = j_boot.read_forcing_fields(path, JGrid(**GRID), names, **kw)
    tf, tt = t_boot.read_forcing_fields(path, Grid(**GRID), names, **kw)
    np.testing.assert_allclose(tt, jt, rtol=1e-12, atol=0)
    assert tt[0] == pytest.approx((10 * 365 + 15) * 86400.0, rel=1e-15)
    assert sorted(tf) == sorted(jf) == sorted(names[:3])
    for k in jf:
        assert tf[k].shape == jf[k].shape, k
        assert np.abs(tf[k] - jf[k]).max() <= 1e-12 * np.abs(jf[k]).max(), k
    assert tf["air_temp"].min() > 200.0
    assert np.abs(tf["precipitation"]).max() < 1e-6


@pytest.mark.parametrize("extra,over", [
    (("bwat",), {}),
    ((), {"bootstrapping.defaults.bwat": 0.5}),
])
def test_unported_bootstrap_inputs_raise(tmp_path, extra, over):
    path = _data_file(tmp_path / "boot.nc", extra=extra)
    cfg = Config(dict({"runtime.float_dtype": "float64"}, **over))
    with pytest.raises(NotImplementedError, match="item 6"):
        t_boot.bootstrap(path, Grid(**GRID), cfg, device="cpu")


@pytest.mark.parametrize("default", [0.0, 0.3])
def test_fracture_density_bootstraps_as_jax(tmp_path, default):
    """A file's fracture_density is regridded as in JAX, missing values
    taking bootstrapping.defaults.fracture_density."""
    path = _data_file(tmp_path / "boot.nc", extra=("fracture_density",))
    with File(path, "a") as f:
        phi = np.asarray(f.read("fracture_density"))
        phi[5, 6] = np.nan
        f.write("fracture_density", phi, ("y", "x"), {})
    a, b = _both(path, {"bootstrapping.defaults.fracture_density": default})
    assert "fracture_density" in a and "fracture_density" in b
    assert np.isfinite(b["fracture_density"]).all()
    np.testing.assert_allclose(b["fracture_density"], a["fracture_density"],
                               rtol=0, atol=1e-12)


def test_float32_fields_and_lonlat(tmp_path):
    """Under runtime.float_dtype = float32 every field is float32, the
    regridded ones equal to the float64 fields rounded; the file's
    projection gives lat/lon."""
    path = _data_file(tmp_path / "boot.nc")
    with File(path, "a") as f:
        f.set_global_attr("proj", "+proj=stere +lat_0=90 +lat_ts=71 "
                          "+lon_0=-39")
    s32 = t_boot.bootstrap(path, Grid(**GRID),
                           Config({"runtime.float_dtype": "float32"}),
                           device="cpu")
    s64 = t_boot.bootstrap(path, Grid(**GRID),
                           Config({"runtime.float_dtype": "float64"}),
                           device="cpu")
    assert s32.enthalpy.dtype == torch.float32
    assert torch.equal(s32.geometry.ice_thickness,
                       s64.geometry.ice_thickness.float())
    lon, lat = t_boot.lonlat_from_projection(path, Grid(**GRID))
    jlon, jlat = j_boot.lonlat_from_projection(path, JGrid(**GRID))
    np.testing.assert_allclose(lat, jlat, rtol=1e-12)
    np.testing.assert_allclose(lon, jlon, rtol=1e-12)
    np.testing.assert_array_equal(
        t_boot.latitude_from_projection(path, Grid(**GRID)), lat)
    assert t_boot.projection_of(_data_file(tmp_path / "b2.nc")) is None
