"""Host-side I/O helpers of the port against the JAX package on the CPU:
the bilinear regridder (``util/regrid.py``) against both routes of
``pism_tpu.native.regrid_bilinear`` (the C++ library and its numpy
fallback), the projections (``util/projection.py``), the projection in
output files (``proj``, ``lat``/``lon``, ``lat_bnds``/``lon_bnds``) in both
formats, and ``util/nccmp.py``. Tolerance 1e-12 throughout (float64 host
arithmetic of the same formulas).
"""

import numpy as np
import pytest
import torch

from pism_tpu import native
from pism_tpu import Config as JConfig
from pism_tpu.grid import Grid as JGrid
from pism_tpu.io import checkpoint as j_ckpt
from pism_tpu.state import ModelState as JModelState, new_geometry as j_geom
from pism_tpu.util import nccmp as j_nccmp
from pism_tpu.util import projection as j_prj
from pism_tpu_torch import Config, Grid, ModelState, new_geometry
from pism_tpu_torch.io import checkpoint as t_ckpt
from pism_tpu_torch.io.nc4 import File
from pism_tpu_torch.util import nccmp as t_nccmp
from pism_tpu_torch.util import projection as t_prj
from pism_tpu_torch.util.regrid import regrid_bilinear

torch.set_num_threads(2)

PROJ = "+proj=stere +lat_0=90 +lat_ts=71 +lon_0=-39 +k=1 +x_0=0 +y_0=0"


def _source(rng, holes=True):
    xs = np.sort(rng.uniform(-500e3, 500e3, 23))
    ys = np.sort(rng.uniform(-800e3, 800e3, 31))
    src = rng.normal(size=(31, 23)) * 100.0
    if holes:
        src[rng.random(src.shape) < 0.15] = np.nan
        src[rng.random(src.shape) < 0.05] = -9999.0
    return src, xs, ys


def _jax_routes(src, xs, ys, xt, yt, fill, monkeypatch):
    assert native.available(), "the C++ route needs g++"
    out = {"native": native.regrid_bilinear(src, xs, ys, xt, yt, fill=fill)}
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        out["numpy"] = native.regrid_bilinear(src, xs, ys, xt, yt, fill=fill)
    return out


def _close(a, b, tol=1e-12):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    ok = ~np.isnan(b)
    scale = max(np.abs(b[ok]).max(), 1.0) if ok.any() else 1.0
    assert np.abs(a[ok] - b[ok]).max() <= tol * scale


@pytest.mark.parametrize("fill", [np.nan, -9999.0])
@pytest.mark.parametrize("target", ["inside", "wider", "points"])
def test_regrid_matches_both_jax_routes(monkeypatch, fill, target):
    """Renormalized weights around NaN and fill values, and clamping at
    the edges, on targets inside, past every edge, and on the source's own
    coordinates."""
    rng = np.random.default_rng(7)
    src, xs, ys = _source(rng)
    if target == "inside":
        xt, yt = np.linspace(-450e3, 450e3, 40), np.linspace(-700e3, 700e3, 53)
    elif target == "wider":
        xt, yt = np.linspace(-900e3, 900e3, 41), np.linspace(-1.2e6, 1.2e6, 29)
    else:
        xt, yt = xs.copy(), ys.copy()
    got = regrid_bilinear(src, xs, ys, xt, yt, fill=fill)
    for route, ref in _jax_routes(src, xs, ys, xt, yt, fill,
                                  monkeypatch).items():
        _close(got, ref)


def test_regrid_clamps_outside_the_extent():
    """Quirk the port holds to: a target outside the file's extent takes
    the nearest edge value (no NaN), so ``grid.allow_extrapolation``
    changes nothing for data without NaN."""
    rng = np.random.default_rng(3)
    src, xs, ys = _source(rng, holes=False)
    xt = np.array([xs[0] - 1e6, xs[0], xs[-1], xs[-1] + 1e6])
    yt = np.array([ys[0] - 1e6, ys[-1] + 1e6])
    out = regrid_bilinear(src, xs, ys, xt, yt)
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[0], [src[0, 0], src[0, 0],
                                           src[0, -1], src[0, -1]])
    np.testing.assert_array_equal(out[1], [src[-1, 0], src[-1, 0],
                                           src[-1, -1], src[-1, -1]])
    clipped = regrid_bilinear(src, xs, ys, np.clip(xt, xs[0], xs[-1]),
                              np.clip(yt, ys[0], ys[-1]))
    np.testing.assert_array_equal(out, clipped)


def test_regrid_exact_on_linear_field():
    xs, ys = np.linspace(0, 10, 21), np.linspace(0, 5, 11)
    X, Y = np.meshgrid(xs, ys)
    xt, yt = np.linspace(0.5, 9.5, 37), np.linspace(0.2, 4.8, 17)
    XT, YT = np.meshgrid(xt, yt)
    out = regrid_bilinear(2.0 * X - 3.0 * Y + 1.0, xs, ys, xt, yt)
    np.testing.assert_allclose(out, 2.0 * XT - 3.0 * YT + 1.0, rtol=1e-12)


# -- projections ---------------------------------------------------------

PROJ_STRINGS = [
    PROJ,
    "+proj=stere +lat_0=90 +lat_ts=70 +lon_0=-45 +x_0=1000 +y_0=-2000",
    "+proj=stere +lat_0=-90 +lat_ts=-71 +lon_0=0",
    "+proj=sterea +lat_0=90 +lat_ts=75 +lon_0=10",
    "+proj=tmerc +lat_0=10 +lon_0=9 +k=0.9996 +x_0=500000 +y_0=0",
    "+proj=utm +zone=33",
    "+proj=utm +zone=22 +south",
]


@pytest.mark.parametrize("proj", PROJ_STRINGS)
def test_projection_functions_match(proj):
    pj, pt = j_prj.from_proj_string(proj), t_prj.from_proj_string(proj)
    assert type(pt).__name__ == type(pj).__name__
    assert {k: getattr(pt, k) for k in pj.__dataclass_fields__} == \
        {k: getattr(pj, k) for k in pj.__dataclass_fields__}
    rng = np.random.default_rng(11)
    south = isinstance(pj, j_prj.PolarStereographic) and pj._south
    lat = rng.uniform(-85, -60, 50) if south else (
        rng.uniform(60, 85, 50) if isinstance(pj, j_prj.PolarStereographic)
        else rng.uniform(-40, 60, 50))
    lon = pj.central_meridian + rng.uniform(-8, 8, 50)
    for a, b in zip(pt.forward(lat, lon), pj.forward(lat, lon)):
        _close(np.asarray(a), np.asarray(b))
    x, y = pj.forward(lat, lon)
    for a, b in zip(pt.inverse(x, y), pj.inverse(x, y)):
        _close(np.asarray(a), np.asarray(b))
    jg = JGrid(Mx=9, My=13, Lx=300e3, Ly=450e3, x0=float(x[0]),
               y0=float(y[0]))
    tg = Grid(Mx=9, My=13, Lx=300e3, Ly=450e3, x0=float(x[0]), y0=float(y[0]))
    for a, b in zip(t_prj.lonlat_for_grid(tg, pt),
                    j_prj.lonlat_for_grid(jg, pj)):
        _close(a, b)
    for a, b in zip(t_prj.lonlat_bounds_for_grid(tg, pt),
                    j_prj.lonlat_bounds_for_grid(jg, pj)):
        _close(a, b)


@pytest.mark.parametrize("attrs", [
    {"grid_mapping_name": "polar_stereographic",
     "straight_vertical_longitude_from_pole": -45.0,
     "latitude_of_projection_origin": 90.0, "standard_parallel": 70.0},
    {"grid_mapping_name": b"polar_stereographic",
     "longitude_of_projection_origin": np.array([0.0]),
     "latitude_of_projection_origin": -90.0, "standard_parallel": 71.0,
     "false_easting": 10.0},
    {"grid_mapping_name": "transverse_mercator",
     "longitude_of_central_meridian": 15.0,
     "scale_factor_at_central_meridian": 0.9996,
     "false_easting": 500000.0},
])
def test_cf_mapping_matches(attrs):
    pj, pt = j_prj.from_cf_mapping(attrs), t_prj.from_cf_mapping(attrs)
    assert repr(pt).split("(")[1] == repr(pj).split("(")[1]
    if hasattr(pj, "proj_string"):
        assert pt.proj_string() == pj.proj_string()
        assert pt.cf_mapping() == pj.cf_mapping()


@pytest.mark.parametrize("bad", ["+proj=lcc +lat_1=33", "+proj=stere +lat_0=45",
                                 "+proj=utm +zone=61"])
def test_unsupported_projections_raise(bad):
    with pytest.raises(ValueError):
        j_prj.from_proj_string(bad)
    with pytest.raises(ValueError):
        t_prj.from_proj_string(bad)
    with pytest.raises(ValueError):
        t_prj.from_cf_mapping({"grid_mapping_name": "lambert_conformal_conic"})


# -- the projection in output files -------------------------------------

def _states(grid_kw):
    rng = np.random.default_rng(5)
    H = rng.uniform(0, 2000, (grid_kw["My"], grid_kw["Mx"]))
    b = rng.uniform(-500, 500, H.shape)
    js = JModelState(geometry=j_geom(H, b))
    ts = ModelState(geometry=new_geometry(torch.tensor(H), torch.tensor(b)))
    return js, ts


@pytest.mark.parametrize("fmt", ["netcdf4", "netcdf3"])
def test_outputs_carry_the_projection(tmp_path, fmt):
    """``save_state`` with ``grid.projection`` writes ``proj``, lat/lon and
    their cell bounds as the JAX package's NetCDF-4 file does, in either
    format. (The JAX ``save_state`` tests ``"nv4" not in f.h5``, which only
    its h5py file has, so its classic projected file fails.)"""
    kw = dict(Mx=7, My=9, Lx=300e3, Ly=400e3)
    js, ts = _states(kw)
    jcfg, tcfg = JConfig({"grid.projection": PROJ}), Config(
        {"grid.projection": PROJ})
    j_ckpt.save_state(str(tmp_path / "j.nc"), js, JGrid(**kw), 0.0,
                      config=jcfg)
    t_ckpt.save_state(str(tmp_path / "t.nc"), ts, Grid(**kw), 0.0,
                      config=tcfg, format=fmt)
    names = ["lat", "lon", "lat_bnds", "lon_bnds", "thk"]
    assert t_nccmp.compare(str(tmp_path / "t.nc"), str(tmp_path / "j.nc"),
                           names, atol=1e-12) == []
    with File(str(tmp_path / "t.nc"), "r") as f:
        assert f.get_global_attr("proj") == PROJ
        assert f.read("lat_bnds").shape == (9, 7, 4)
        assert f.read_attrs("lat")["bounds"] == "lat_bnds"
    with pytest.raises(AttributeError):
        j_ckpt.save_state(str(tmp_path / "j3.nc"), js, JGrid(**kw), 0.0,
                          config=jcfg, format="netcdf3")


def test_extra_file_carries_the_projection(tmp_path):
    from pism_tpu_torch.model.output import OutputManager
    grid = Grid(Mx=7, My=9, Lx=300e3, Ly=400e3)
    out = OutputManager(grid=grid, config=Config({"grid.projection": PROJ}),
                        extra_times=[1.0], extra_file=str(tmp_path / "ex.nc"),
                        format="netcdf3", async_io=False)
    out.close()
    with File(str(tmp_path / "ex.nc"), "r") as f:
        assert f.get_global_attr("proj") == PROJ
        lon, lat = t_prj.lonlat_for_grid(grid, t_prj.from_proj_string(PROJ))
        np.testing.assert_array_equal(f.read("lat"), lat)
        assert f.read("lon_bnds").shape == (9, 7, 4)


# -- nccmp ----------------------------------------------------------------

@pytest.mark.parametrize("atol,rtol", [(0.0, 0.0), (1e-3, 0.0), (0.0, 1e-6)])
def test_nccmp_matches(tmp_path, atol, rtol):
    """The same mismatches as the JAX ``nccmp`` on files that differ by a
    variable, a shape, NaN patterns and values, in both formats."""
    rng = np.random.default_rng(2)
    a = rng.normal(size=(5, 6))
    b = a + rng.normal(size=a.shape) * 1e-4
    for path, fmt, data in ((tmp_path / "a.nc", "netcdf4", a),
                            (tmp_path / "b.nc", "netcdf3", b)):
        with File(str(path), "w", format=fmt) as f:
            f.define_dimension("y", 5, np.arange(5.0))
            f.define_dimension("x", 6, np.arange(6.0))
            f.write("v", data, ("y", "x"))
            f.write("same", a, ("y", "x"))
            nanned = a.copy()
            if fmt == "netcdf3":
                nanned[0, 0] = np.nan
            f.write("nanv", nanned, ("y", "x"))
            f.write("only_" + fmt, a, ("y", "x"))
    pa, pb = str(tmp_path / "a.nc"), str(tmp_path / "b.nc")
    got = [str(m) for m in t_nccmp.compare(pa, pb, atol=atol, rtol=rtol)]
    want = [str(m) for m in j_nccmp.compare(pa, pb, atol=atol, rtol=rtol)]
    assert got == want and got
    assert t_nccmp.main([pa, pb, "-v", "same"]) == 0
    assert t_nccmp.main([pa, pb, "-v", "v", "-t", str(atol)]) == \
        j_nccmp.main([pa, pb, "-v", "v", "-t", str(atol)])
