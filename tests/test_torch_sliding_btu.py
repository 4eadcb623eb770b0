"""The Weertman and prescribed-sliding branches of the stress balance, the
full bedrock thermal unit and the manufactured thermo-coupled solutions,
pism_tpu_torch against pism_tpu on the CPU in float64.

Tolerances. The Weertman velocity (EISMINT II G, H with mixed temperate and
cold bases, and E's per-cell coefficient), ``BTUFull.step`` and
``init_temperature`` are the same elementwise operations and column
solves in both packages: 1e-12 relative. The manufactured SMB of tests F
and G is automatic differentiation of the same closed forms (``torch.func``
against ``jax.grad``): 1e-10 relative. An EISMINT II A model with an
11-level bedrock layer for 300 a through both packages: equal steps and
dt-limit hits, thickness within 1e-10 of max H, enthalpy and bedrock
temperature within 1e-10 relative. A restart from ``litho_temp`` continues
to the bit, in both output formats.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu import Config as JConfig, Grid as JGrid  # noqa: E402
from pism_tpu.model import btu as j_btu  # noqa: E402
from pism_tpu.model import diagnostics as j_diag  # noqa: E402
from pism_tpu.model.icemodel import IceModel as JIceModel  # noqa: E402
from pism_tpu.model.stressbalance import StressBalance as JStressBalance  # noqa: E402
from pism_tpu.physics.enthalpy_converter import EnthalpyConverter as JEC  # noqa: E402
from pism_tpu.physics.rheology import flow_law_from_config as j_flow_law  # noqa: E402
from pism_tpu.state import ModelState as JModelState, new_geometry as j_new_geometry  # noqa: E402
from pism_tpu.verification import eismint2 as j_e2  # noqa: E402
from pism_tpu.verification import manufactured as j_man  # noqa: E402
from pism_tpu_torch import Config, Grid  # noqa: E402
from pism_tpu_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402
from pism_tpu_torch.io import checkpoint as ckpt  # noqa: E402
from pism_tpu_torch.model import btu as t_btu  # noqa: E402
from pism_tpu_torch.model import diagnostics as t_diag  # noqa: E402
from pism_tpu_torch.model.icemodel import IceModel  # noqa: E402
from pism_tpu_torch.model.stressbalance import StressBalance  # noqa: E402
from pism_tpu_torch.physics.enthalpy_converter import EnthalpyConverter  # noqa: E402
from pism_tpu_torch.physics.rheology import flow_law_from_config  # noqa: E402
from pism_tpu_torch.state import ModelState, new_geometry  # noqa: E402
from pism_tpu_torch.verification import eismint2 as t_e2  # noqa: E402
from pism_tpu_torch.verification import manufactured as t_man  # noqa: E402

SPY = 3.15569259747e7
MX, MZ, MBZ = 21, 11, 11


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _jax_fields(st):
    d = {f.name: np.asarray(getattr(st.geometry, f.name))
         for f in dataclasses.fields(st.geometry)}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if f.name != "geometry" and v is not None:
            d[f.name] = np.asarray(v)
    return d


def _dome(grid, rng, R=600e3, H0=3000.0):
    """A seeded dome with an ice-free margin and surface noise on the ice."""
    r = np.asarray(grid.radius)
    H = np.maximum(H0 * (1.0 - (r / R) ** 2), 0.0)
    return H + rng.uniform(0.0, 20.0, H.shape) * (H > 0)


def _mixed_enthalpy(grid, H, rng, EC):
    """Enthalpy columns whose bases are temperate or cold at random (never
    at E_s exactly), warming downward."""
    z = np.asarray(grid.z)
    p = EC.p_air + EC.rho_i * EC.g * np.maximum(H[..., None] - z, 0.0)
    Es = EC.c_i * (EC.T_melting - EC.beta * p - EC.T_ref)
    E = Es - rng.uniform(2e3, 4e4, Es.shape)
    base = rng.uniform(-3e4, 3e4, H.shape)
    E[..., 0] = Es[..., 0] + np.where(np.abs(base) < 1.0, 1e3, base)
    return E


# ------------------------------------------------------------- Weertman

@pytest.mark.parametrize("experiment", ["G", "H", "E"])
def test_weertman_matches(experiment):
    rng = np.random.default_rng(18)
    je = j_e2.setup(experiment, Mx=MX, Mz=MZ)
    te = t_e2.setup(experiment, Mx=MX, Mz=MZ, device="cpu")
    H = _dome(je.grid, rng)
    E = _mixed_enthalpy(je.grid, H, rng, EnthalpyConverter())
    bed = rng.uniform(-10.0, 10.0, H.shape)
    jlaw = j_flow_law(je.config, "sia", JEC.from_config(je.config))
    jsb = JStressBalance(grid=je.grid, config=je.config, sia_flow_law=jlaw,
                         model=je.config.get_string("stress_balance.model"),
                         sliding_mu=je.sliding_mu)
    js = JModelState(geometry=j_new_geometry(jnp.asarray(H), jnp.asarray(bed)),
                     enthalpy=jnp.asarray(E))
    ju, jv = (np.asarray(x) for x in jsb._weertman(js))

    tsb = StressBalance(grid=te.grid, config=te.config,
                        sia_flow_law=flow_law_from_config(
                            te.config, "sia", EnthalpyConverter.from_config(
                                te.config)),
                        sliding_mu=te.sliding_mu)
    ts = ModelState(geometry=new_geometry(torch.from_numpy(H),
                                          torch.from_numpy(bed)),
                    enthalpy=torch.from_numpy(E))
    tu, tv = (x.numpy() for x in tsb._weertman(ts))
    assert _rel(tu, ju) <= 1e-12 and _rel(tv, jv) <= 1e-12
    speed = np.hypot(ju, jv)
    assert speed.max() > 0.0 and (speed[H == 0] == 0).all()
    if experiment == "H":
        # the melt_only gate holds some icy cells still: the cold bases
        Es0 = EnthalpyConverter().enthalpy_cts(
            EnthalpyConverter().pressure(torch.from_numpy(H))).numpy()
        cold = (E[..., 0] < Es0) & (H > 0)
        assert cold.any() and (~cold & (H > 0)).any()
        assert (speed[cold] == 0).all() and (speed[~cold & (H > 0)] > 0).any()


def test_weertman_exponent_one_at_zero_stress():
    """With m = 1, (|tau_d| / N) ** 0 is 1 where tau_d = 0, in both
    packages; a flat surface gives zero velocity everywhere."""
    je = j_e2.setup("G", Mx=MX, Mz=MZ)
    te = t_e2.setup("G", Mx=MX, Mz=MZ, device="cpu")
    H = np.full(je.grid.shape2, 1000.0)
    jsb = JStressBalance(grid=je.grid, config=je.config,
                         model="weertman_sliding+sia")
    tsb = StressBalance(grid=te.grid, config=te.config, sia_flow_law=None)
    ju, _ = jsb._weertman(JModelState(geometry=j_new_geometry(
        jnp.asarray(H), jnp.zeros_like(jnp.asarray(H)))))
    tu, _ = tsb._weertman(ModelState(geometry=new_geometry(
        torch.from_numpy(H), torch.zeros(H.shape, dtype=torch.float64))))
    assert np.isfinite(tu.numpy()).all()
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))


def _prescribed_model(pkg, tmp_path, u, v, grid):
    cfg = {"stress_balance.model": "prescribed_sliding+sia",
           "stress_balance.sia.flow_law": "isothermal_glen",
           "energy.model": "none",
           "stress_balance.prescribed_sliding.file": str(tmp_path / "u.nc")}
    if pkg == "jax":
        from pism_tpu.coupler.surface import Uniform as JUniform
        return JIceModel(grid=grid, config=JConfig(cfg), surface=JUniform())
    from pism_tpu_torch.coupler.surface import Uniform
    return IceModel(grid=grid, config=Config(cfg), surface=Uniform(),
                    device="cpu")


def test_prescribed_sliding_file_and_steps(tmp_path):
    """``stress_balance.prescribed_sliding.file`` read through the
    bootstrap regridder (u_ssa/v_ssa, m s-1) by both packages, and a few
    steps of the prescribed_sliding+sia chain: equal steps and hits, H
    within 1e-10 of max H, the sliding velocity carried in the state."""
    rng = np.random.default_rng(5)
    tg = Grid(Mx=MX, My=MX, Lx=750e3, Ly=750e3)
    jg = JGrid(Mx=MX, My=MX, Lx=750e3, Ly=750e3)
    H = _dome(tg, rng)
    u = rng.uniform(-30.0, 30.0, H.shape) / SPY
    v = rng.uniform(-30.0, 30.0, H.shape) / SPY
    st = ModelState(geometry=new_geometry(torch.from_numpy(H),
                                          torch.zeros_like(torch.from_numpy(H))),
                    u_ssa=torch.from_numpy(u), v_ssa=torch.from_numpy(v))
    ckpt.save_state(str(tmp_path / "u.nc"), st, tg, 0.0, format="netcdf3")
    jm = _prescribed_model("jax", tmp_path, u, v, jg)
    tm = _prescribed_model("torch", tmp_path, u, v, tg)
    np.testing.assert_array_equal(tm.prescribed_u, np.asarray(jm.prescribed_u))
    np.testing.assert_array_equal(tm.prescribed_v, np.asarray(jm.prescribed_v))
    assert _rel(tm.prescribed_u, u) <= 1e-12
    js, _, jst = jm.step_once(JModelState(geometry=j_new_geometry(
        jnp.asarray(H), jnp.zeros_like(jnp.asarray(H)))), 0.0, 20.0 * SPY)
    ts, _, tst = tm.step_once(ModelState(geometry=new_geometry(
        torch.from_numpy(H), torch.zeros(H.shape, dtype=torch.float64))),
        0.0, 20.0 * SPY)
    assert tst.nsteps == int(jst.nsteps) > 1
    assert tst.limit_hits_dict() == {k: int(c) for k, c in
                                     jst.limit_hits_dict().items() if int(c)}
    Hj, Ht = np.asarray(js.geometry.ice_thickness), ts.geometry.ice_thickness
    assert np.abs(Ht.numpy() - Hj).max() <= 1e-10 * Hj.max()
    np.testing.assert_array_equal(ts.u_ssa.numpy(), np.asarray(js.u_ssa))


# ------------------------------------------------------------------ BTU

def _btu_grids():
    kw = dict(Mx=5, My=4, Lx=10e3, Ly=8e3, Mz=MZ, Lz=1150.0, Mbz=MBZ,
              Lbz=1000.0)
    return JGrid(**kw), Grid(**kw)


def test_btu_from_config_picks_the_unit():
    jg, tg = _btu_grids()
    assert isinstance(t_btu.btu_from_config(tg, Config({})), t_btu.BTUFull)
    assert isinstance(t_btu.btu_from_config(
        dataclasses.replace(tg, Mbz=1), Config({})), t_btu.BTUMinimal)
    assert isinstance(t_btu.btu_from_config(
        dataclasses.replace(tg, Lbz=0.0), Config({})), t_btu.BTUMinimal)
    assert t_btu.BTUMinimal(tg, Config({})).init_temperature(None, 0.0) is None


def test_btu_full_matches():
    """init_temperature and ten steps of BTUFull.step on seeded columns
    (non-default bedrock constants), 1e-12 relative."""
    rng = np.random.default_rng(7)
    over = {"energy.bedrock_thermal.conductivity": 2.5,
            "energy.bedrock_thermal.density": 2900.0,
            "energy.bedrock_thermal.specific_heat_capacity": 850.0}
    jg, tg = _btu_grids()
    jb = j_btu.btu_from_config(jg, JConfig(over))
    tb = t_btu.btu_from_config(tg, Config(over))
    assert isinstance(jb, j_btu.BTUFull) and isinstance(tb, t_btu.BTUFull)
    T_base = rng.uniform(240.0, 273.0, tg.shape2)
    G = rng.uniform(0.03, 0.09, tg.shape2)
    jT = np.asarray(jb.init_temperature(jnp.asarray(T_base), jnp.asarray(G)))
    tT = tb.init_temperature(torch.from_numpy(T_base), torch.from_numpy(G))
    assert tT.shape == tg.shape2 + (MBZ,)
    assert _rel(tT.numpy(), jT) <= 1e-12
    # a float geothermal flux, as prepare_state passes the config's
    tT0 = tb.init_temperature(torch.from_numpy(T_base), 0.05)
    assert _rel(tT0.numpy(), np.asarray(jb.init_temperature(
        jnp.asarray(T_base), jnp.asarray(0.05)))) <= 1e-12
    bed = rng.uniform(250.0, 280.0, tg.shape2 + (MBZ,))
    jbed, tbed = jnp.asarray(bed), torch.from_numpy(bed)
    for k in range(10):
        Tb = rng.uniform(240.0, 273.0, tg.shape2)
        dt = (10.0 + 90.0 * k) * SPY
        jbed, jflux = jb.step(jbed, jnp.asarray(Tb), jnp.asarray(G), dt)
        tbed, tflux = tb.step(tbed, torch.from_numpy(Tb),
                              torch.from_numpy(G), dt)
        assert _rel(tbed.numpy(), np.asarray(jbed)) <= 1e-12
        assert _rel(tflux.numpy(), np.asarray(jflux)) <= 1e-12
        np.testing.assert_array_equal(tbed[..., -1].numpy(), Tb)


# --------------------------------------------------- manufactured F, G

@pytest.mark.parametrize("kind", ["F", "G"])
def test_manufactured_smb_matches(kind):
    """The compensatory SMB and surface temperature of tests F and G (G at
    three times), the initial enthalpy to the bit."""
    cfgd = {"stress_balance.model": "sia", "stress_balance.sia.flow_law": "pb",
            "energy.model": "none"}
    kw = dict(Mx=MX, My=MX, Lx=750e3, Ly=750e3, Mz=MZ, Lz=3500.0)
    J, T = {"F": (j_man.ManufacturedThermoSIA, t_man.ManufacturedThermoSIA),
            "G": (j_man.ManufacturedThermoSIAPeriodic,
                  t_man.ManufacturedThermoSIAPeriodic)}[kind]
    js, jsurf = J().setup(JGrid(**kw), JConfig(cfgd))
    ts, tsurf = T().setup(Grid(**kw), Config(cfgd), device="cpu")
    np.testing.assert_array_equal(ts.enthalpy.numpy(), np.asarray(js.enthalpy))
    np.testing.assert_array_equal(ts.geometry.ice_thickness.numpy(),
                                  np.asarray(js.geometry.ice_thickness))
    for t in (0.0, 123.0 * SPY, 610.0 * SPY):
        a, b = jsurf(js.geometry, t), tsurf(ts.geometry, t)
        assert b.smb.dtype == torch.float64
        assert _rel(b.smb.numpy(), np.asarray(a.smb)) <= 1e-10
        np.testing.assert_array_equal(b.temperature.numpy(),
                                      np.asarray(a.temperature))


# ------------------------------------- an IceModel with a bedrock layer

def _bedrock_setup(pkg):
    """EISMINT II A at 21x21x11 with an 11-level, 1 km bedrock layer."""
    e2 = j_e2 if pkg == "jax" else t_e2
    kw = {} if pkg == "jax" else {"device": "cpu"}
    es = e2.setup("A", Mx=MX, Mz=MZ, **kw)
    es.config.update({"grid.Mbz": MBZ, "grid.Lbz": 1000.0,
                      "stress_balance.sia.bed_smoother.range": 0.0,
                      "runtime.float_dtype": "float64"})
    grid = dataclasses.replace(es.grid, Mbz=MBZ, Lbz=1000.0)
    Model = JIceModel if pkg == "jax" else IceModel
    return Model(grid=grid, config=es.config, surface=es.surface, **kw), grid


@pytest.fixture(scope="module")
def bedrock_runs():
    """A seeded dome with a bootstrapped enthalpy (ties at E_s moved 1 J/kg
    below it), the bedrock column initialized by each package, 300 a."""
    rng = np.random.default_rng(3)
    tm, grid = _bedrock_setup("torch")
    H = _dome(grid, rng, R=500e3, H0=2500.0)
    s0 = tm.prepare_state(ModelState(geometry=new_geometry(
        torch.from_numpy(H), torch.zeros(H.shape, dtype=torch.float64))))
    d = state_to_numpy(s0.replace(bedrock_temperature=None))
    EC = tm.EC
    p = EC.pressure(torch.clamp(torch.from_numpy(H)[..., None]
                                - torch.as_tensor(grid.z), min=0.0))
    Es = EC.enthalpy_cts(p).numpy()
    tie = np.abs(d["enthalpy"] - Es) <= 1e-9 * np.abs(Es)
    d["enthalpy"] = np.where(tie, d["enthalpy"] - 1.0, d["enthalpy"])
    jm, jgrid = _bedrock_setup("jax")
    js0 = jm.prepare_state(JModelState(
        geometry=j_new_geometry(jnp.asarray(H), jnp.zeros(H.shape)),
        enthalpy=jnp.asarray(d["enthalpy"]),
        basal_melt_rate=jnp.zeros(H.shape)))
    ts0 = tm.prepare_state(state_from_numpy(d, device="cpu"))
    js, tj, sj = jm.step_once(js0, 0.0, 300.0 * SPY)
    ts, tt, st = tm.step_once(ts0, 0.0, 300.0 * SPY)
    return {"jax0": _jax_fields(js0), "torch0": state_to_numpy(ts0),
            "jax": (_jax_fields(js), tj, sj, jm, js),
            "torch": (ts, tt, st, tm), "d0": d, "n_ties": int(tie.sum())}


def test_bedrock_initial_column_matches(bedrock_runs):
    a, b = bedrock_runs["jax0"]["bedrock_temperature"], \
        bedrock_runs["torch0"]["bedrock_temperature"]
    assert b.shape == (MX, MX, MBZ)
    assert _rel(b, a) <= 1e-12


def test_bedrock_chain_matches(bedrock_runs):
    (a, tj, sj, _, _), (ts, tt, st, _) = bedrock_runs["jax"], \
        bedrock_runs["torch"]
    b = state_to_numpy(ts)
    assert st.nsteps == int(sj.nsteps) > 2
    assert st.limit_hits_dict() == {k: int(c) for k, c in
                                    sj.limit_hits_dict().items() if int(c)}
    assert abs(tt - float(tj)) <= 1e-6
    Ha = a["ice_thickness"]
    assert np.abs(b["ice_thickness"] - Ha).max() <= 1e-10 * Ha.max()
    assert _rel(b["enthalpy"], a["enthalpy"]) <= 1e-10
    assert _rel(b["bedrock_temperature"], a["bedrock_temperature"]) <= 1e-10
    # the column moved from its initial profile
    assert np.abs(b["bedrock_temperature"]
                  - bedrock_runs["torch0"]["bedrock_temperature"]).max() > 1e-6


@pytest.mark.parametrize("name", ["bedtoptemp", "heat_flux_from_bedrock",
                                  "litho_temp"])
def test_bedrock_diagnostics_match(bedrock_runs, name):
    (_, _, _, jm, js), (ts, _, _, tm) = bedrock_runs["jax"], \
        bedrock_runs["torch"]
    a = np.asarray(j_diag.SPATIAL[name].func(js, jm, 0.0))
    b = t_diag.SPATIAL[name].func(ts, tm, 0.0).numpy()
    assert b.shape == a.shape
    assert _rel(b, a) <= 1e-10
    # without a bedrock layer: the JAX package's stand-ins
    a0 = np.asarray(j_diag.SPATIAL[name].func(
        js.replace(bedrock_temperature=None), jm, 0.0))
    b0 = t_diag.SPATIAL[name].func(ts.replace(bedrock_temperature=None), tm,
                                   0.0).numpy()
    np.testing.assert_array_equal(b0, a0)


@pytest.mark.parametrize("fmt", ["netcdf3", "netcdf4"])
def test_bedrock_restart_to_the_bit(bedrock_runs, tmp_path, fmt):
    """100 a, litho_temp written and read back, 100 a more: the same bits
    as the second 100 a from the state in memory;
    ``energy.bedrock_thermal.file`` reads the same column in both
    packages."""
    tm = bedrock_runs["torch"][3]
    s0 = tm.prepare_state(state_from_numpy(bedrock_runs["d0"], device="cpu"))
    mid, t1, _ = tm.step_once(s0, 0.0, 100.0 * SPY)
    ref, _, _ = tm.step_once(mid, t1, 100.0 * SPY)
    path = str(tmp_path / f"r.{fmt}.nc")
    ckpt.save_state(path, mid, tm.grid, t1, config=tm.config, format=fmt)
    back, t_back = ckpt.load_state(path, config=tm.config, device="cpu")
    assert t_back == t1
    np.testing.assert_array_equal(back.bedrock_temperature.numpy(),
                                  mid.bedrock_temperature.numpy())
    out, _, _ = tm.step_once(back, t_back, 100.0 * SPY)
    for k in ("ice_thickness", "enthalpy", "bedrock_temperature"):
        a, b = state_to_numpy(ref)[k], state_to_numpy(out)[k]
        np.testing.assert_array_equal(b, a, err_msg=k)
    # the litho_temp file as the initial column of a new run
    m2, _ = _bedrock_setup("torch")
    m2.config.update({"energy.bedrock_thermal.file": path})
    got = m2.prepare_state(state_from_numpy(
        bedrock_runs["d0"], device="cpu")).bedrock_temperature
    np.testing.assert_array_equal(got.numpy(), mid.bedrock_temperature.numpy())
    jm2, _ = _bedrock_setup("jax")
    jm2.config.update({"energy.bedrock_thermal.file": path})
    d0 = bedrock_runs["d0"]
    jgot = jm2.prepare_state(JModelState(
        geometry=j_new_geometry(jnp.asarray(d0["ice_thickness"]),
                                jnp.zeros_like(jnp.asarray(
                                    d0["ice_thickness"]))),
        enthalpy=jnp.asarray(d0["enthalpy"]))).bedrock_temperature
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))


# -------------------------------------------------------------- refusals

def test_new_branches_refuse_the_member_axis_and_a_mesh():
    """The Weertman and prescribed-sliding branches and the bedrock layer
    have no ensemble or mesh form yet (ROADMAP Queue 1 items 3 and 10)."""
    from pism_tpu_torch.parallel import make_mesh

    te = t_e2.setup("G", Mx=MX, Mz=MZ, device="cpu")
    law = flow_law_from_config(te.config, "sia")
    with pytest.raises(NotImplementedError, match="item 3"):
        StressBalance(grid=te.grid, config=te.config, sia_flow_law=law,
                      lead=1)
    with pytest.raises(NotImplementedError, match="item 10"):
        StressBalance(grid=te.grid, config=te.config, sia_flow_law=law,
                      mesh=make_mesh(["cpu"] * 4, (2, 2)))
    with pytest.raises(NotImplementedError, match="item 3"):
        IceModel(grid=te.grid, config=te.config, surface=te.surface,
                 device="cpu", member_axis=True)
    tm, grid = _bedrock_setup("torch")
    tm.config.update({"stress_balance.model": "sia"})
    with pytest.raises(NotImplementedError, match="item 3"):
        IceModel(grid=grid, config=tm.config, surface=tm.surface,
                 device="cpu", member_axis=True)
    with pytest.raises(NotImplementedError, match="item 10"):
        IceModel(grid=grid, config=tm.config, surface=tm.surface,
                 device="cpu", mesh=make_mesh(["cpu"] * 4, (2, 2)))
    # none and ssa refuse the member axis, blatter it and a mesh; blatter
    # needs its solver, prescribed sliding its fields
    for model in ("none", "ssa", "blatter"):
        with pytest.raises(NotImplementedError, match="item 3"):
            StressBalance(grid=te.grid, config=Config(
                {"stress_balance.model": model}), sia_flow_law=law, lead=1)
    with pytest.raises(NotImplementedError, match="item 10"):
        StressBalance(grid=te.grid, config=Config(
            {"stress_balance.model": "blatter"}), sia_flow_law=law,
            mesh=make_mesh(["cpu"] * 4, (2, 2)))
    with pytest.raises(ValueError):
        StressBalance(grid=te.grid, config=Config(
            {"stress_balance.model": "blatter"}), sia_flow_law=law)
    with pytest.raises(ValueError):
        StressBalance(grid=te.grid, config=Config(
            {"stress_balance.model": "prescribed_sliding+sia"}),
            sia_flow_law=law)
