"""``IceModel.run``, the output channels and the diagnostics of the port
against the JAX package's on the CPU, in float64.

Both packages run the same initial state (made by numpy) through
``IceModel.run`` with an ``OutputManager`` of the same times: Halfar test
C on 31x31 for 100 a (the CLI's Halfar config, whose accumulation
``5 H / t`` feeds the budget) and EISMINT II A on 21x21x11 for 50 a. The
step counts and dt-limit hits are equal; H agrees within 1e-10 of max H
(Halfar) and H and E within 1e-8 of max (EISMINT II, as
``tests/test_torch_eismint2.py``). The scalar series (the default three,
``ice_volume`` and every rate) and the spatial series (the default four
and every spatial rate, from the per-cell budget ``CellBudget``) agree
over their two reporting windows within 1e-10 relative on the Halfar run;
the per-cell budget itself too. Every ported diagnostic agrees with its
twin on one EISMINT II state within 1e-10 of max. The health checks and
the diffusivity stop raise the same errors. The writer thread writes
every record equal to the state at its output time, and its exceptions
reach the caller.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu import Config as JConfig, Grid as JGrid, Time as JTime  # noqa: E402
from pism_tpu.coupler.surface import FunctionSurface as JFunctionSurface  # noqa: E402
from pism_tpu.model import diagnostics as j_diag  # noqa: E402
from pism_tpu.model.icemodel import IceModel as JIceModel  # noqa: E402
from pism_tpu.model.output import OutputManager as JOutputManager  # noqa: E402
from pism_tpu.state import ModelState as JModelState  # noqa: E402
from pism_tpu.state import new_geometry as j_new_geometry  # noqa: E402
from pism_tpu.verification import eismint2 as j_e2  # noqa: E402
from pism_tpu.verification import halfar as j_halfar  # noqa: E402
from pism_tpu_torch import Config, Grid, Time  # noqa: E402
from pism_tpu_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402
from pism_tpu_torch.coupler.surface import FunctionSurface  # noqa: E402
from pism_tpu_torch.io.nc4 import File  # noqa: E402
from pism_tpu_torch.model import diagnostics as t_diag  # noqa: E402
from pism_tpu_torch.model.icemodel import IceModel  # noqa: E402
from pism_tpu_torch.model.output import OutputManager  # noqa: E402
from pism_tpu_torch.verification import eismint2 as t_e2  # noqa: E402

SPY = 3.15569259747e7
TS_VARS = ("ice_volume_glacierized", "ice_area_glacierized", "max_velocity",
           "ice_volume") + tuple(t_diag.RATE)
EXTRA_VARS = ("thk", "usurf", "velbar_mag", "mask") \
    + tuple(t_diag.SPATIAL_RATE)


def jax_to_numpy(st):
    d = {f.name: np.asarray(getattr(st.geometry, f.name))
         for f in dataclasses.fields(st.geometry)}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if f.name != "geometry" and v is not None:
            d[f.name] = np.asarray(v)
    return d


def _halfar_cfg():
    return {"stress_balance.model": "sia",
            "stress_balance.sia.flow_law": "isothermal_glen",
            "flow_law.isothermal_Glen.ice_softness": j_halfar.A_SOFTNESS,
            "energy.model": "none"}


def _halfar_models():
    sol = j_halfar.test_C()
    kw = dict(Mx=31, My=31, Lx=900e3, Ly=900e3)
    lam = sol.lam
    jm = JIceModel(grid=JGrid(**kw), config=JConfig(_halfar_cfg()),
                   surface=JFunctionSurface(lambda g, t: (
                       lam / t * g.ice_thickness,
                       jnp.full(g.ice_thickness.shape, 263.15))))
    tm = IceModel(grid=Grid(**kw), config=Config(_halfar_cfg()),
                  surface=FunctionSurface(lambda g, t: (
                      lam / t * g.ice_thickness,
                      torch.full_like(g.ice_thickness, 263.15))),
                  device="cpu")
    H0 = sol.thickness(sol.t0, Grid(**kw).radius)
    js = JModelState(geometry=j_new_geometry(jnp.asarray(H0),
                                             jnp.zeros(H0.shape)))
    return jm, tm, js, sol.t0, 100.0


def _eismint_models():
    es = j_e2.setup("A", Mx=21, Mz=11, Lz=5000.0)
    ts = t_e2.setup("A", Mx=21, Mz=11, Lz=5000.0, device="cpu")
    jm = JIceModel(grid=es.grid, config=es.config, surface=es.surface)
    tm = IceModel(grid=ts.grid, config=ts.config, surface=ts.surface,
                  device="cpu")
    return jm, tm, es.state, 0.0, 50.0


def _outputs(d, t0, years, cls, grid, config, fmt):
    y = t0 / SPY
    return cls(grid=grid, config=config,
               ts_times=[(y + f * years) * SPY for f in (0.4, 1.0)],
               ts_vars=TS_VARS, ts_file=str(d / "ts.nc"),
               extra_times=[(y + f * years) * SPY for f in (0.5, 1.0)],
               extra_vars=EXTRA_VARS, extra_file=str(d / "ex.nc"),
               **({"format": fmt} if fmt else {}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name, make in (("halfar", _halfar_models), ("eismint", _eismint_models)):
        jm, tm, js, t0, years = make()
        d0 = jax_to_numpy(js)
        time = (t0, t0 + years * SPY)
        dj = tmp_path_factory.mktemp(f"{name}_jax")
        dt = tmp_path_factory.mktemp(f"{name}_torch")
        jo = _outputs(dj, t0, years, JOutputManager, jm.grid, jm.config, None)
        to = _outputs(dt, t0, years, OutputManager, tm.grid, tm.config,
                      "netcdf3")
        jsf, jst = jm.run(js, JTime(*time), output=jo)
        jo.close()
        seen = {}

        def keep(state, t, stats):
            seen[t] = state.geometry.ice_thickness.clone()

        tsf, tst = tm.run(state_from_numpy(d0, device="cpu"), Time(*time),
                          output=to, callback=keep)
        to.close()
        out[name] = dict(jax=(jax_to_numpy(jsf), jst, dj),
                         torch=(state_to_numpy(tsf), tst, dt),
                         seen=seen, models=(jm, tm))
    return out


@pytest.mark.parametrize("name", ["halfar", "eismint"])
def test_steps_and_limit_hits_equal(runs, name):
    (_, sj, _), (_, st, _) = runs[name]["jax"], runs[name]["torch"]
    assert st.nsteps == int(sj.nsteps) > 0
    assert st.limit_hits_dict() == sj.limit_hits_dict()


@pytest.mark.parametrize("name,tol", [("halfar", 1e-10), ("eismint", 1e-8)])
def test_end_state(runs, name, tol):
    (a, _, _), (b, _, _) = runs[name]["jax"], runs[name]["torch"]
    for field in ("ice_thickness", "enthalpy"):
        if field in a:
            scale = np.abs(a[field]).max()
            assert scale > 0
            assert np.abs(b[field] - a[field]).max() <= tol * scale, field


def _read(path):
    with File(str(path), "r") as f:
        return {v: f.read(v) for v in f.variables()}, f.read("time"), \
            {v: f.read_attrs(v) for v in f.variables()}


@pytest.mark.parametrize("name,tol", [("halfar", 1e-10), ("eismint", 1e-8)])
@pytest.mark.parametrize("series", ["ts.nc", "ex.nc"])
def test_series_match(runs, name, tol, series):
    """The two reporting windows of every series variable, the rates among
    them; units, long names and cell methods as the JAX package's."""
    (va, ta, aa), (vb, tb, ab) = (_read(runs[name][p][2] / series)
                                  for p in ("jax", "torch"))
    assert sorted(va) == sorted(vb)
    assert len(ta) == len(tb) == 2
    np.testing.assert_allclose(tb, ta, rtol=1e-12)
    # a budget term is held to the largest term of its units: the flow
    # (zero in sum over a closed domain) and the H >= 0 clip of a smooth
    # dome are zero up to rounding
    top = {}
    for v, x in va.items():
        u = aa[v].get("units")
        top[u] = max(top.get(u, 0.0), float(np.abs(x).max()))
    for v, x in va.items():
        y = vb[v]
        assert x.shape == y.shape, v
        for key in ("units", "long_name", "cell_methods"):
            assert aa[v].get(key) == ab[v].get(key), (v, key)
        scale = max(np.abs(x).max(), 1e-300)
        if v.startswith("tendency_"):
            scale = max(scale, top[aa[v].get("units")])
        assert np.abs(y - x).max() <= tol * scale, v


def test_cell_budget_matches(runs):
    """StepStats.cell of the run, per field, within 1e-10 relative."""
    (_, sj, _), (_, st, _) = runs["halfar"]["jax"], runs["halfar"]["torch"]
    assert st.cell is not None
    scale = max(float(np.abs(np.asarray(a)).max()) for a in sj.cell)
    assert np.abs(np.asarray(sj.cell.smb)).max() > 0
    for name, a, b in zip(sj.cell._fields, sj.cell, st.cell):
        assert np.abs(b.numpy() - np.asarray(a)).max() <= 1e-10 * scale, name


def test_budget_only_when_asked(runs):
    """Without a spatial rate diagnostic the run fills no per-cell budget."""
    _, tm = runs["halfar"]["models"]
    out = OutputManager(grid=tm.grid, config=tm.config, format="netcdf3")
    assert not out.needs_cell_budget
    sol = j_halfar.test_C()
    H0 = torch.as_tensor(sol.thickness(sol.t0, tm.grid.radius))
    from pism_tpu_torch.state import ModelState, new_geometry
    _, stats = tm.run(ModelState(geometry=new_geometry(H0, 0 * H0)),
                      Time(sol.t0, sol.t0 + 5 * SPY), output=out)
    out.close()
    assert stats.cell is None and stats.nsteps > 0


def test_records_equal_the_state_at_their_time(runs):
    """Every record of the spatial series equals the thickness the run
    held at the record's time (the writer thread reads host copies)."""
    v, t, _ = _read(runs["eismint"]["torch"][2] / "ex.nc")
    seen = runs["eismint"]["seen"]
    for k, tk in enumerate(t):
        np.testing.assert_array_equal(v["thk"][k], seen[tk].numpy())


def _diag_state():
    """One EISMINT II state with sliding velocities, till water and basal
    melt made by numpy, in both packages."""
    rng = np.random.default_rng(7)
    jm, tm, js, _, _ = _eismint_models()
    jend, _, _ = jm.step_once(js, 0.0, 200 * SPY)
    d = jax_to_numpy(jend)
    for k in ("u_ssa", "v_ssa", "tillwat", "basal_melt_rate"):
        d[k] = rng.normal(size=d["ice_thickness"].shape) * 1e-6
    jstate = JModelState(geometry=j_new_geometry(
        jnp.asarray(d["ice_thickness"]), jnp.asarray(d["bed_elevation"])),
        **{k: jnp.asarray(d[k]) for k in ("enthalpy", "u_ssa", "v_ssa",
                                           "tillwat", "basal_melt_rate")})
    return jm, tm, jstate, state_from_numpy(jax_to_numpy(jstate),
                                            device="cpu")


@pytest.fixture(scope="module")
def diag_state():
    return _diag_state()


@pytest.mark.parametrize("name", sorted(t_diag.SPATIAL) + sorted(t_diag.SCALAR))
def test_diagnostic_matches(diag_state, name):
    jm, tm, js, ts = diag_state
    table_j = j_diag.SPATIAL if name in t_diag.SPATIAL else j_diag.SCALAR
    table_t = t_diag.SPATIAL if name in t_diag.SPATIAL else t_diag.SCALAR
    dj, dt = table_j[name], table_t[name]
    assert (dt.units, dt.long_name, dt.standard_name) \
        == (dj.units, dj.long_name, dj.standard_name)
    t = 200 * SPY
    a = np.asarray(dj.func(js, jm, t))
    b = dt.func(ts, tm, t).numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    scale = max(np.abs(a).max(), 1e-300)
    assert np.abs(b - a).max() <= 1e-10 * scale


def test_rate_tables_match():
    """Names, units, long names and values of every rate on one window."""
    w = dict(dt=3.0e9, d_volume=1.5e12, d_smb=2.0e12, d_bmb=-3.0e10,
             d_flow=4.0e11, d_nonneg=1.0e6, d_discharge=-5.0e10, rho_i=910.0,
             d_nsteps=17.0, d_calving=-4.0e10, d_frontal_melt=-1.0e10,
             d_forced_retreat=-2.0e9, d_volume_glacierized=1.4e12)
    assert sorted(t_diag.RATE) == sorted(
        n for n in j_diag.RATE if n in t_diag.RATE)
    for name, d in t_diag.RATE.items():
        j = j_diag.RATE[name]
        assert (d.units, d.long_name) == (j.units, j.long_name), name
        assert d.func(t_diag.Window(**w)) == pytest.approx(
            j.func(j_diag.Window(**w)), rel=1e-15), name
    rng = np.random.default_rng(3)
    f = {k: rng.normal(size=(4, 5)) for k in (
        "d_thickness", "d_flow", "d_smb", "d_bmb", "d_nonneg", "d_discharge",
        "d_calving", "d_frontal_melt", "d_forced_retreat", "d_topg",
        "d_water")}
    for name, d in t_diag.SPATIAL_RATE.items():
        j = j_diag.SPATIAL_RATE[name]
        assert (d.units, d.long_name, d.standard_name) \
            == (j.units, j.long_name, j.standard_name), name
        for extra in ({}, {"d_topg": None, "d_water": None}):
            kw = dict(dt=2.0e9, rho_i=910.0, cell_area=4e8, **{**f, **extra})
            np.testing.assert_array_equal(
                np.asarray(d.func(t_diag.Window2D(**kw))),
                np.asarray(j.func(j_diag.Window2D(**kw))), name)


def _raises_same(jfn, tfn):
    with pytest.raises(RuntimeError) as ej:
        jfn()
    with pytest.raises(RuntimeError) as et:
        tfn()
    assert str(et.value) == str(ej.value)


def _check_both(jm, tm, jstate, t):
    ts = state_from_numpy(jax_to_numpy(jstate), device="cpu")

    def j():
        jm._check_thickness(jstate)
        jm._check_health(jstate, t)

    _raises_same(j, lambda: tm._check_state(ts, t))


@pytest.mark.parametrize("fault", ["lz", "cap", "nan", "cold"])
def test_health_checks_raise_the_same(tmp_path, monkeypatch, fault):
    monkeypatch.chdir(tmp_path)
    jm, tm, js, _, _ = _eismint_models()
    js = jm.prepare_state(js)
    H = np.full(jm.grid.shape2, 1000.0)
    E = np.asarray(js.enthalpy)
    if fault == "lz":
        H[3, 4] = 6000.0
    elif fault == "cap":
        for m in (jm, tm):
            m.config.update({"geometry.ice_thickness.max": 900.0})
    elif fault == "nan":
        H[2, 2] = np.nan
    else:
        E = np.full(E.shape, -1.0e5)     # 173 K
    js = js.replace(geometry=j_new_geometry(jnp.asarray(H),
                                            js.geometry.bed_elevation),
                    enthalpy=jnp.asarray(E))
    _check_both(jm, tm, js, 12.5 * SPY)
    if fault == "nan":
        with File(str(tmp_path / "SSAFD_failed.nc"), "r") as f:
            assert np.isnan(f.read("thk")[-1][2, 2])


def test_diffusivity_stop_raises_the_same():
    over = {**_halfar_cfg(), "stress_balance.sia.max_diffusivity": 1.0}
    sol = j_halfar.test_B()
    kw = dict(Mx=11, My=11, Lx=900e3, Ly=900e3)
    H0 = sol.thickness(sol.t0, Grid(**kw).radius)
    jm = JIceModel(grid=JGrid(**kw), config=JConfig(over),
                   surface=JFunctionSurface(lambda g, t: (
                       0.0 * g.ice_thickness,
                       jnp.full(g.ice_thickness.shape, 263.15))))
    tm = IceModel(grid=Grid(**kw), config=Config(over),
                  surface=FunctionSurface(lambda g, t: (
                      0.0 * g.ice_thickness,
                      torch.full_like(g.ice_thickness, 263.15))),
                  device="cpu")
    js = JModelState(geometry=j_new_geometry(jnp.asarray(H0),
                                             jnp.zeros(H0.shape)))
    ts = state_from_numpy(jax_to_numpy(js), device="cpu")
    _raises_same(lambda: jm.run(js, JTime(sol.t0, sol.t0 + SPY)),
                 lambda: tm.run(ts, Time(sol.t0, sol.t0 + SPY)))


def test_writer_exceptions_reach_the_caller(tmp_path, monkeypatch):
    """A failed write on the writer thread raises on the next flush (once)
    or close, and close still closes the files."""
    from pism_tpu_torch.io import checkpoint as ckpt
    from pism_tpu_torch.state import ModelState, new_geometry

    grid = Grid(Mx=5, My=5, Lx=1e5, Ly=1e5)
    out = OutputManager(grid=grid, config=Config(), format="netcdf3",
                        ts_times=[1.0], ts_file=str(tmp_path / "ts.nc"))
    assert out._writer is not None

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "save_state", boom)
    z = torch.zeros(grid.shape2, dtype=torch.float64)
    state = ModelState(geometry=new_geometry(z, z))
    out.write_backup(state, 0.0)
    with pytest.raises(OSError, match="disk full"):
        out.flush()
    out.flush()
    out.write_backup(state, 0.0)
    with pytest.raises(OSError, match="disk full"):
        out.close()
    assert out._ts_f is None and out._writer is None
