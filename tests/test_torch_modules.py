"""Each module of the pism_tpu_torch hybrid chain against its pism_tpu
counterpart on identical float64 inputs (made with numpy from a seed, on
the 100 km synthetic-Greenland geometry): 1e-10 relative unless stated."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu import Config as JConfig, Grid as JGrid  # noqa: E402
from pism_tpu import state as JS  # noqa: E402
from pism_tpu.coupler import atmosphere as j_atm, pdd as j_pdd  # noqa: E402
from pism_tpu.coupler.surface import SurfaceCarry as JCarry  # noqa: E402
from pism_tpu.model import calving as j_calv, energy as j_energy  # noqa: E402
from pism_tpu.model import geometry_evolution as j_ge  # noqa: E402
from pism_tpu.model.stressbalance import StressBalance as JSB  # noqa: E402
from pism_tpu.ops import sia as j_sia, sia3d as j_sia3d, ssa as j_ssa  # noqa: E402
from pism_tpu.ops.stencils import Shifter as JShifter  # noqa: E402
from pism_tpu.physics import basal as j_basal, hydrology as j_hyd  # noqa: E402
from pism_tpu.physics.enthalpy_converter import EnthalpyConverter as JEC  # noqa: E402
from pism_tpu.physics.rheology import flow_law_from_config as j_flow_law  # noqa: E402
from pism_tpu_torch import Config as TConfig, Grid as TGrid  # noqa: E402
from pism_tpu_torch import state as TS  # noqa: E402
from pism_tpu_torch.coupler import atmosphere as t_atm, pdd as t_pdd  # noqa: E402
from pism_tpu_torch.coupler.surface import SurfaceCarry as TCarry  # noqa: E402
from pism_tpu_torch.model import calving as t_calv, energy as t_energy  # noqa: E402
from pism_tpu_torch.model import geometry_evolution as t_ge  # noqa: E402
from pism_tpu_torch.model.stressbalance import StressBalance as TSB  # noqa: E402
from pism_tpu_torch.ops import sia3d as t_sia3d, ssa as t_ssa  # noqa: E402
from pism_tpu_torch.ops.stencils import Shifter as TShifter  # noqa: E402
from pism_tpu_torch.physics import basal as t_basal, hydrology as t_hyd  # noqa: E402
from pism_tpu_torch.physics.enthalpy_converter import EnthalpyConverter as TEC  # noqa: E402
from pism_tpu_torch.physics.rheology import flow_law_from_config as t_flow_law  # noqa: E402

SPY = 3.15569259747e7
RTOL = 1e-10
CFG = {"stress_balance.model": "ssa+sia", "energy.model": "enthalpy",
       "basal_resistance.pseudo_plastic.enabled": True,
       "basal_resistance.pseudo_plastic.q": 0.25,
       "calving.methods": "thickness_calving",
       "geometry.remove_icebergs": True, "geometry.part_grid.enabled": True}


def check(got, ref, rtol=RTOL, name=""):
    """max |got - ref| <= rtol * max |ref| (exact match for all-zero ref)."""
    g = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    r = np.asarray(ref)
    assert g.shape == r.shape, name
    scale = np.abs(r.astype(np.float64)).max()
    err = np.abs(g.astype(np.float64) - r.astype(np.float64)).max()
    assert err <= rtol * scale, f"{name}: {err:.3e} > {rtol:.0e} * {scale:.3e}"


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    """Both packages' components and one numpy state (100 km grid)."""
    kw = dict(Mx=16, My=29, Lx=750e3, Ly=1400e3, Mz=41, Lz=4000.0)
    jg, tg = JGrid(**kw), TGrid(**kw)
    jc, tc = JConfig(dict(CFG)), TConfig(dict(CFG))
    X, Y = np.meshgrid(jg.x, jg.y)
    Lx, Ly = kw["Lx"], kw["Ly"]
    r2 = (X / (0.55 * Lx)) ** 2 + (Y / (0.8 * Ly)) ** 2
    bed = 400.0 - 900.0 * r2 + 150.0 * np.sin(X / 120e3) * np.cos(Y / 160e3)
    H = 2800.0 * np.maximum(1.0 - r2, 0.0) ** 1.5 * (bed > -600)
    lat = 60.0 + (Y + Ly) / (2 * Ly) * 23.0
    lon = -42.0 + X / Lx * 10.0
    precip = np.clip(0.6 - 0.25 * (lat - 60.0) / 23.0, 0.05, None) / SPY
    jgeom = JS.new_geometry(jnp.asarray(H), jnp.asarray(bed), subgl=True)
    E = np.asarray(j_energy.bootstrap_enthalpy(
        jg, JEC.from_config(jc), jgeom.ice_thickness,
        jnp.full(H.shape, 255.0)))
    rng = np.random.default_rng(42)
    # perturb the enthalpy (and with it the temperate/cold decisions) away
    # from the bootstrap's exact pressure-melting values
    E = E - rng.uniform(1.0, 2000.0, size=E.shape)
    geom = {f.name: np.asarray(getattr(jgeom, f.name))
            for f in dataclasses.fields(JS.Geometry)}
    return dict(jg=jg, tg=tg, jc=jc, tc=tc, geom=geom, E=E, lat=lat, lon=lon,
                precip=precip, rng=rng,
                u=rng.normal(size=H.shape) * 3e-6,
                v=rng.normal(size=H.shape) * 3e-6)


def jgeometry(geom):
    return JS.Geometry(**{k: jnp.asarray(v) for k, v in geom.items()})


def tgeometry(geom):
    return TS.Geometry(**{k: T(v) for k, v in geom.items()})


@pytest.mark.parametrize("subgl", [True, False])
def test_ensure_consistency(setup, subgl):
    rng = np.random.default_rng(1)
    g = dict(setup["geom"])
    g["sea_level"] = rng.uniform(-50.0, 300.0, size=g["sea_level"].shape)
    g["ice_thickness"] = g["ice_thickness"] * rng.uniform(0.0, 1.2, size=g["sea_level"].shape)
    j = JS.ensure_consistency(jgeometry(g), 910.0, 1028.0, 0.01, subgl)
    t = TS.ensure_consistency(tgeometry(g), 910.0, 1028.0, 0.01, subgl)
    for f in dataclasses.fields(JS.Geometry):
        check(getattr(t, f.name), getattr(j, f.name), 1e-14, f.name)
    assert t.cell_type.dtype == torch.int32
    assert int((t.cell_type == JS.MASK_FLOATING).sum()) > 0


def test_compute_nuH_and_its_linearization(setup):
    jg, rng = setup["jg"], setup["rng"]
    H = setup["geom"]["ice_thickness"]
    B = rng.uniform(1e8, 3e8, size=H.shape)
    ext = H < 500.0
    kw = dict(n_glen=3.0, eps_reg2=(1.0 / SPY / 1e6) ** 2,
              extension_nuH=4.9e16)
    u, v = setup["u"], setup["v"]
    du, dv = rng.normal(size=H.shape) * 1e-6, rng.normal(size=H.shape) * 1e-6
    jsh, tsh = JShifter(jg), TShifter(setup["tg"])

    def jf(uu, vv):
        return tuple(j_ssa.compute_nuH(uu, vv, jnp.asarray(B), jnp.asarray(H),
                                       jg.dx, jg.dy, jsh,
                                       extension_mask=jnp.asarray(ext), **kw))

    jn, jt = jax.jvp(jf, (jnp.asarray(u), jnp.asarray(v)),
                     (jnp.asarray(du), jnp.asarray(dv)))
    targs = (T(B), T(H), jg.dx, jg.dy, tsh)
    tn = t_ssa.compute_nuH(T(u), T(v), *targs, extension_mask=T(ext), **kw)
    ln, tangent = t_ssa.linearize_nuH(T(u), T(v), *targs,
                                      extension_mask=T(ext), **kw)
    _, ft = torch.func.jvp(
        lambda a, b: tuple(t_ssa.compute_nuH(a, b, *targs,
                                             extension_mask=T(ext), **kw)),
        (T(u), T(v)), (T(du), T(dv)))
    lt = tangent(T(du), T(dv))
    for k in range(2):
        check(tn[k], jn[k], name="nuH")
        check(ln[k], jn[k], name="linearized nuH")
        check(ft[k], jt[k], name="torch.func.jvp")
        check(lt[k], jt[k], 1e-12, name="hand linearization")


def _frozen_system(setup):
    jg, rng = setup["jg"], setup["rng"]
    icy = JS.icy(jnp.asarray(setup["geom"]["cell_type"]))
    nuHe = rng.uniform(1e14, 1e17, size=icy.shape) * np.asarray(icy)
    nuHn = rng.uniform(1e14, 1e17, size=icy.shape) * np.asarray(icy)
    beta = rng.uniform(1e6, 1e10, size=icy.shape)
    return np.asarray(~icy), nuHe, nuHn, beta


def test_line_preconditioner(setup):
    jg = setup["jg"]
    bc, nuHe, nuHn, beta = _frozen_system(setup)
    rng = np.random.default_rng(3)
    r = (rng.normal(size=bc.shape), rng.normal(size=bc.shape))
    jp = j_ssa.make_line_preconditioner(
        j_ssa.NuH(jnp.asarray(nuHe), jnp.asarray(nuHn)), jnp.asarray(beta),
        jnp.asarray(bc), jg.dx, jg.dy, JShifter(jg))
    tp = t_ssa.make_line_preconditioner(
        t_ssa.NuH(T(nuHe), T(nuHn)), T(beta), T(bc), jg.dx, jg.dy,
        TShifter(setup["tg"]))
    for got, ref in zip(tp((T(r[0]), T(r[1]))),
                        jp((jnp.asarray(r[0]), jnp.asarray(r[1])))):
        check(got, ref, 1e-12)
        assert got.is_contiguous()


@pytest.mark.parametrize("rtol", [1e-2, 1e-6])
def test_bicgstab_equal_iterations(setup, rtol):
    """The frozen-coefficient Picard system (operator + line
    preconditioner): same iteration count, solutions to 1e-10."""
    jg = setup["jg"]
    bc, nuHe, nuHn, beta = _frozen_system(setup)
    rng = np.random.default_rng(4)
    b = [rng.normal(size=bc.shape) * 1e5 * (~bc) for _ in range(2)]
    jsh, tsh = JShifter(jg), TShifter(setup["tg"])
    jnu = j_ssa.NuH(jnp.asarray(nuHe), jnp.asarray(nuHn))
    tnu = t_ssa.NuH(T(nuHe), T(nuHn))
    jbc, tbc = jnp.asarray(bc), T(bc)

    def jmv(x):
        xu, xv = (jnp.where(jbc, 0.0, a) for a in x)
        Au, Av = j_ssa.apply_operator(xu, xv, jnu, jnp.asarray(beta),
                                      jg.dx, jg.dy, jsh)
        return (jnp.where(jbc, x[0], Au), jnp.where(jbc, x[1], Av))

    def tmv(x):
        xu, xv = (torch.where(tbc, 0.0, a) for a in x)
        Au, Av = t_ssa.apply_operator(xu, xv, tnu, T(beta), jg.dx, jg.dy)
        return (torch.where(tbc, x[0], Au), torch.where(tbc, x[1], Av))

    jpc = j_ssa.make_line_preconditioner(jnu, jnp.asarray(beta), jbc,
                                         jg.dx, jg.dy, jsh)
    tpc = t_ssa.make_line_preconditioner(tnu, T(beta), tbc, jg.dx, jg.dy, tsh)
    zeros = np.zeros(bc.shape)
    jx, jit, jr = j_ssa.bicgstab_solve(
        jmv, tuple(jnp.asarray(a) for a in b),
        (jnp.asarray(zeros), jnp.asarray(zeros)), jpc, rtol=rtol, max_iter=300)
    tx, tit, tr = t_ssa.bicgstab_solve(
        tmv, tuple(T(a) for a in b), (T(zeros), T(zeros)), tpc,
        rtol=rtol, max_iter=300)
    assert tit == int(jit) and tit > 0
    for got, ref in zip(tx, jx):
        check(got, ref)
    check(tr, jr, 1e-6, "residual norm")


@pytest.mark.parametrize("method", ["haseloff", "mahaffy"])
def test_sia_with_bed_smoother(setup, method):
    jg, tg = setup["jg"], setup["tg"]
    jc = JConfig({**CFG, "stress_balance.sia.surface_gradient_method": method})
    tc = TConfig({**CFG, "stress_balance.sia.surface_gradient_method": method})
    jlaw = j_flow_law(jc, "sia")
    jsb = JSB(grid=jg, config=jc, sia_flow_law=jlaw, model="ssa+sia")
    tsb = TSB(grid=tg, config=tc, sia_flow_law=t_flow_law(tc, "sia"), ssa=None)
    jgm, jte, jtn = jsb._apply_bed_smoother(jgeometry(setup["geom"]))
    tgm, tte, ttn = tsb._apply_bed_smoother(tgeometry(setup["geom"]))
    check(tgm.ice_thickness, jgm.ice_thickness, name="H_sia")
    check(tte, jte, name="theta_e")
    check(ttn, jtn, name="theta_n")
    jf = j_sia.diffusivity(jlaw, jgm, jnp.asarray(setup["E"]), jg, jsb.sh,
                           gradient_method=method, theta_e=jte, theta_n=jtn)
    tf = tsb.sia_flux(tgm, T(setup["E"]), tte, ttn)
    for name in ("De", "Dn", "qe", "qn", "max_D"):
        check(getattr(tf, name), getattr(jf, name), name=name)


def test_sia_3d(setup):
    jg, tg = setup["jg"], setup["tg"]
    jlaw, tlaw = j_flow_law(setup["jc"], "sia"), t_flow_law(setup["tc"], "sia")
    bmr = setup["rng"].uniform(0.0, 1e-9, size=setup["u"].shape)
    kw = dict(icy_threshold=10.0)
    j3 = j_sia3d.sia_3d(jlaw, jgeometry(setup["geom"]), jnp.asarray(setup["E"]),
                        jg, JShifter(jg), u_base=jnp.asarray(setup["u"]),
                        v_base=jnp.asarray(setup["v"]),
                        basal_melt_rate=jnp.asarray(bmr), **kw)
    t3 = t_sia3d.sia_3d(tlaw, tgeometry(setup["geom"]), T(setup["E"]), tg,
                        TShifter(tg), u_base=T(setup["u"]), v_base=T(setup["v"]),
                        basal_melt_rate=T(bmr), **kw)
    for name in j_sia3d.SIA3D._fields:
        check(getattr(t3, name), getattr(j3, name), name=name)


@pytest.mark.parametrize("t0,dt", [(0.0, 0.37 * SPY), (0.6 * SPY, 0.5 * SPY)])
def test_pdd_update(setup, t0, dt):
    """One PDD update; the second interval crosses a balance-year start."""
    jsurf = j_pdd.TemperatureIndex(atmosphere=j_atm.SeariseGreenland(
        latitude=jnp.asarray(setup["lat"]), longitude=jnp.asarray(setup["lon"]),
        precipitation=jnp.asarray(setup["precip"])), config=setup["jc"])
    tsurf = t_pdd.TemperatureIndex(atmosphere=t_atm.SeariseGreenland(
        latitude=T(setup["lat"]), longitude=T(setup["lon"]),
        precipitation=T(setup["precip"])), config=setup["tc"])
    rng = np.random.default_rng(5)
    snow = rng.uniform(0.0, 0.5, size=setup["u"].shape)
    firn = rng.uniform(0.0, 0.5, size=setup["u"].shape)
    js, jcar = jsurf.update(jgeometry(setup["geom"]), t0, dt,
                            JCarry(jnp.asarray(snow), jnp.asarray(firn), None))
    ts, tcar = tsurf.update(tgeometry(setup["geom"]), t0, dt,
                            TCarry(T(snow), T(firn)))
    for name in ("smb", "temperature", "melt", "runoff", "accumulation"):
        check(getattr(ts, name), getattr(js, name), name=name)
    check(tcar.snow, jcar.snow, name="snow")
    check(tcar.firn, jcar.firn, name="firn")
    check(tsurf(tgeometry(setup["geom"]), t0).smb,
          jsurf(jgeometry(setup["geom"]), t0).smb, name="climatology")


def _pdd_count(dt, f, evals=52.0):
    return math.ceil(f(dt) * f(evals) / f(SPY))


def test_pdd_trip_count_in_the_field_dtype(setup):
    """A float32 dt at which ceil(dt evals / SPY) is one less in float32
    than in float64 (26 intervals a year): the port's float32 update takes
    JAX's count and interval length. Both packages evaluate the same
    float32 expressions, so they agree to float32 rounding (1e-5 of the
    largest value); a count off by one moves the SMB by ~1e-3 of it."""
    dt = np.float32(0.25 * SPY)
    while _pdd_count(dt, np.float32) == _pdd_count(dt, np.float64):
        dt = np.nextafter(dt, np.float32(np.inf))
    assert abs(float(dt) - 0.25 * SPY) < 1.0
    g32 = {k: (v.astype(np.float32) if v.dtype == np.float64 else v)
           for k, v in setup["geom"].items()}
    jsurf = j_pdd.TemperatureIndex(atmosphere=j_atm.SeariseGreenland(
        latitude=jnp.asarray(setup["lat"]), longitude=jnp.asarray(setup["lon"]),
        precipitation=jnp.asarray(setup["precip"], jnp.float32)),
        config=setup["jc"])
    tsurf = t_pdd.TemperatureIndex(atmosphere=t_atm.SeariseGreenland(
        latitude=T(setup["lat"]), longitude=T(setup["lon"]),
        precipitation=T(setup["precip"].astype(np.float32))),
        config=setup["tc"])
    rng = np.random.default_rng(6)
    snow = rng.uniform(0.0, 0.5, size=setup["u"].shape).astype(np.float32)
    firn = rng.uniform(0.0, 0.5, size=setup["u"].shape).astype(np.float32)
    t0 = 0.3 * SPY
    # the JAX step hands the PDD a float64 clock and a field-dtype dt
    js, jcar = jsurf.update(jgeometry(g32), jnp.asarray(t0, jnp.float64),
                            jnp.asarray(dt),
                            JCarry(jnp.asarray(snow), jnp.asarray(firn), None))
    ts, tcar = tsurf.update(tgeometry(g32), t0, float(dt),
                            TCarry(T(snow), T(firn)))
    for name in ("smb", "melt", "runoff", "accumulation"):
        assert getattr(ts, name).dtype == torch.float32
        check(getattr(ts, name), getattr(js, name), 1e-5, name)
    check(tcar.snow, jcar.snow, 1e-5, "snow")
    check(tcar.firn, jcar.firn, 1e-5, "firn")


def test_energy_step(setup):
    jg, tg = setup["jg"], setup["tg"]
    jlaw, tlaw = j_flow_law(setup["jc"], "sia"), t_flow_law(setup["tc"], "sia")
    rng = np.random.default_rng(6)
    j3 = j_sia3d.sia_3d(jlaw, jgeometry(setup["geom"]), jnp.asarray(setup["E"]),
                        jg, JShifter(jg), u_base=jnp.asarray(setup["u"]),
                        v_base=jnp.asarray(setup["v"]), icy_threshold=10.0)
    t3 = t_sia3d.SIA3D(*(T(getattr(j3, k)) for k in j_sia3d.SIA3D._fields))
    Ts = rng.uniform(240.0, 275.0, size=setup["u"].shape)
    G = np.full(Ts.shape, 0.042)
    fric = rng.uniform(0.0, 0.05, size=Ts.shape)
    tillwat = rng.uniform(0.0, 1.0, size=Ts.shape) * (rng.random(Ts.shape) > 0.5)
    # a temperate base (1 kJ/kg above the pressure-melting enthalpy) in
    # half of the columns, so the melt budget is exercised
    p_b = 101325.0 + 910.0 * 9.81 * setup["geom"]["ice_thickness"]
    Es_b = 2009.0 * (273.15 - 7.9e-8 * p_b - 223.15)
    E = setup["E"].copy()
    E[..., 0] = np.where(rng.random(Ts.shape) > 0.5, Es_b + 1000.0, E[..., 0])
    jstate = JS.ModelState(geometry=jgeometry(setup["geom"]),
                           enthalpy=jnp.asarray(E))
    tstate = TS.ModelState(geometry=tgeometry(setup["geom"]), enthalpy=T(E))
    dt = 0.4 * SPY
    je = j_energy.EnergyModel(grid=jg, config=setup["jc"],
                              EC=JEC.from_config(setup["jc"])).step(
        jstate, j3, jnp.asarray(Ts), dt, geothermal_flux=jnp.asarray(G),
        frictional_heating=jnp.asarray(fric), tillwat=jnp.asarray(tillwat))
    te = t_energy.EnergyModel(grid=tg, config=setup["tc"],
                              EC=TEC.from_config(setup["tc"])).step(
        tstate, t3, T(Ts), dt, geothermal_flux=T(G), frictional_heating=T(fric),
        tillwat=T(tillwat))
    check(te.enthalpy, je.enthalpy, name="enthalpy")
    check(te.basal_melt_rate, je.basal_melt_rate, name="basal melt rate")
    assert float(te.basal_melt_rate.abs().max()) > 0.0


def _front_geometry():
    """A grounded island with a floating tongue, a floating berg and a thin
    floating front (20x24 cells)."""
    H = np.zeros((20, 24))
    bed = np.full(H.shape, -800.0)
    bed[4:16, 3:10] = 200.0
    H[4:16, 3:10] = 900.0          # grounded
    H[6:14, 10:15] = 300.0         # floating tongue
    H[8:12, 15] = 30.0             # thin floating front (calves)
    H[2:4, 18:21] = 200.0          # detached floating berg
    return H, bed


def test_flow_step_part_grid():
    kw = dict(Mx=24, My=20, Lx=115e3, Ly=95e3)
    jg, tg = JGrid(**kw), TGrid(**kw)
    H, bed = _front_geometry()
    rng = np.random.default_rng(7)
    jgeom = JS.new_geometry(jnp.asarray(H), jnp.asarray(bed), subgl=True)
    geom = {f.name: np.asarray(getattr(jgeom, f.name))
            for f in dataclasses.fields(JS.Geometry)}
    geom["ice_area_specific_volume"] = rng.uniform(0.0, 50.0, size=H.shape) \
        * (np.asarray(jgeom.cell_type) == JS.MASK_ICE_FREE_OCEAN)
    Qe = rng.normal(size=H.shape) * 2e-3 * (H > 0)
    Qn = rng.normal(size=H.shape) * 2e-3 * (H > 0)
    u_e = rng.normal(size=H.shape) * 1e-5
    v_n = rng.normal(size=H.shape) * 1e-5
    dt = 3.0e6
    jsh, tsh = JShifter(jg), TShifter(tg)
    jqa = j_ge.advective_flux(jnp.asarray(u_e), jnp.asarray(v_n),
                              jnp.asarray(H), jsh)
    tqa = t_ge.advective_flux(T(u_e), T(v_n), T(H), tsh)
    for got, ref in zip(tqa, jqa):
        check(got, ref)
    jr = j_ge.flow_step(jgeometry(geom), dt, jnp.asarray(Qe) + jqa[0],
                        jnp.asarray(Qn) + jqa[1], jg, jsh, part_grid=True,
                        part_grid_iterations=3)
    tr = t_ge.flow_step(tgeometry(geom), dt, T(Qe) + tqa[0], T(Qn) + tqa[1],
                        tg, tsh, part_grid=True, part_grid_iterations=3)
    for name in ("thickness", "flux_divergence", "nonneg_flux", "Href"):
        check(getattr(tr, name), getattr(jr, name), name=name)
    smb = rng.normal(size=H.shape) * 1e-8
    bmb = rng.uniform(0.0, 1e-8, size=H.shape)
    js = j_ge.source_term_step(jr.thickness, dt, jnp.asarray(smb),
                               jnp.asarray(bmb), jg.dx, jg.dy)
    ts = t_ge.source_term_step(tr.thickness, dt, T(smb), T(bmb), tg.dx, tg.dy)
    for got, ref in zip(ts, (js[0], js[1], js[2])):
        check(got, ref)


def test_calving_and_iceberg_removal():
    kw = dict(Mx=24, My=20, Lx=115e3, Ly=95e3)
    jg, tg = JGrid(**kw), TGrid(**kw)
    H, bed = _front_geometry()
    jgeom = JS.new_geometry(jnp.asarray(H), jnp.asarray(bed), subgl=True)
    geom = {f.name: np.asarray(getattr(jgeom, f.name))
            for f in dataclasses.fields(JS.Geometry)}
    jc, tc = JConfig(dict(CFG)), TConfig(dict(CFG))
    jout, jparts = j_calv.CalvingModel(grid=jg, config=jc).step(
        jgeometry(geom), None, 1.0, with_parts=True)
    tout, tparts = t_calv.CalvingModel(grid=tg, config=tc).step(
        tgeometry(geom), None, 1.0, with_parts=True)
    check(tout.ice_thickness, jout.ice_thickness, 0.0, "H")
    check(tout.ice_area_specific_volume, jout.ice_area_specific_volume, 0.0,
          "Href")
    check(tparts["calving"], jparts["calving"], 0.0, "calving part")
    assert float(tout.ice_thickness[2:4, 18:21].abs().max()) == 0.0   # berg
    assert float(tout.ice_thickness[8:12, 15].abs().max()) == 0.0     # front


def test_yield_stress_and_null_hydrology(setup):
    rng = np.random.default_rng(8)
    tillwat = rng.uniform(0.0, 2.0, size=setup["u"].shape)
    bmr = rng.uniform(0.0, 1e-9, size=tillwat.shape)
    jstate = JS.ModelState(geometry=jgeometry(setup["geom"]),
                           tillwat=jnp.asarray(tillwat),
                           basal_melt_rate=jnp.asarray(bmr))
    tstate = TS.ModelState(geometry=tgeometry(setup["geom"]),
                           tillwat=T(tillwat), basal_melt_rate=T(bmr))
    check(t_basal.MohrCoulombYieldStress(setup["tc"]).compute(tstate),
          j_basal.MohrCoulombYieldStress(setup["jc"]).compute(jstate), name="tau_c")
    jw = j_hyd.NullTransport(grid=setup["jg"], config=setup["jc"]).step(
        jstate, 0.3 * SPY).tillwat
    tw = t_hyd.NullTransport(grid=setup["tg"], config=setup["tc"]).step(
        tstate, 0.3 * SPY).tillwat
    check(tw, jw, name="tillwat")
    jl = j_basal.SlidingLaw.from_config(setup["jc"])
    tl = t_basal.SlidingLaw.from_config(setup["tc"])
    tau = rng.uniform(0.0, 2e5, size=tillwat.shape)
    for reg in (None, 1e-5):
        check(tl.beta(T(tau), T(setup["u"]), T(setup["v"]), reg=reg),
              jl.beta(jnp.asarray(tau), jnp.asarray(setup["u"]),
                      jnp.asarray(setup["v"]), reg=reg), name="beta")


def test_averaged_hardness_and_bootstrap(setup):
    jg, tg = setup["jg"], setup["tg"]
    H = setup["geom"]["ice_thickness"]
    jlaw, tlaw = j_flow_law(setup["jc"], "ssa"), t_flow_law(setup["tc"], "ssa")
    check(tlaw.averaged_hardness(T(H), T(setup["E"]), T(jg.z)),
          jlaw.averaged_hardness(jnp.asarray(H), jnp.asarray(setup["E"]),
                                 jnp.asarray(jg.z)), name="hardness")
    Ts = np.random.default_rng(9).uniform(240.0, 270.0, size=H.shape)
    check(t_energy.bootstrap_enthalpy(tg, TEC.from_config(setup["tc"]), T(H),
                                      T(Ts)),
          j_energy.bootstrap_enthalpy(jg, JEC.from_config(setup["jc"]),
                                      jnp.asarray(H), jnp.asarray(Ts)),
          1e-14, "bootstrap enthalpy")
