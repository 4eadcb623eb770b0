"""NetCDF I/O of the port (``pism_tpu_torch/io``) against the JAX
package's: a saved state reads back to the bit in both formats (absent
fields stay absent); a file written by either package is read by the
other with equal arrays, time, grid and non-default config, in both
formats (the hydrology's ``bwat``, ``bwp`` and ``bwatflux`` among the
fields); a run restarted through a file is bit-identical to the
uninterrupted one (``tests/test_io.py``'s Halfar B and hybrid-chain-with-
PDD cases, and the latter with routing and distributed hydrology); and NetCDF-4 without h5py raises, naming ``-o_format
netcdf3``. Inputs are made by numpy from a seed.
"""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu import Config as JConfig, Grid as JGrid  # noqa: E402
from pism_tpu.io import checkpoint as j_ckpt  # noqa: E402
from pism_tpu.state import ModelState as JModelState  # noqa: E402
from pism_tpu.state import new_geometry as j_new_geometry  # noqa: E402
from pism_tpu_torch import Config, Grid  # noqa: E402
from pism_tpu_torch.io import checkpoint as ckpt  # noqa: E402
from pism_tpu_torch.io.nc4 import File  # noqa: E402
from pism_tpu_torch.state import ModelState, new_geometry  # noqa: E402

SPY = 3.15569259747e7
GRID = dict(Mx=11, My=9, Lx=100e3, Ly=80e3, Mz=5, Lz=3000.0, Mbz=3,
            Lbz=500.0)
CFG = {"grid.Mx": 11, "stress_balance.sia.enhancement_factor": 3.0,
       "time.calendar": "360_day", "run_info.title": "io test"}
FIELDS2 = ("basal_melt_rate", "u_ssa", "v_ssa", "tillwat", "snow_depth",
           "hydro_W", "hydro_P", "hydro_Q")


def _arrays(seed):
    rng = np.random.default_rng(seed)
    g = Grid(**GRID)
    a = {"H": rng.uniform(0.0, 2000.0, g.shape2),
         "bed": rng.uniform(-500.0, 500.0, g.shape2),
         "enthalpy": rng.uniform(1e5, 3e5, g.shape3),
         "bedrock_temperature": rng.uniform(250.0, 270.0,
                                            g.shape2 + (g.Mbz,))}
    for name in FIELDS2:
        a[name] = rng.normal(size=g.shape2)
    a["H"][0, :3] = 0.0
    return a


def _torch_state(a, dtype=torch.float64):
    def T(x):
        return torch.as_tensor(x, dtype=dtype)
    return ModelState(geometry=new_geometry(T(a["H"]), T(a["bed"])),
                      enthalpy=T(a["enthalpy"]),
                      bedrock_temperature=T(a["bedrock_temperature"]),
                      **{n: T(a[n]) for n in FIELDS2})


def _jax_state(a):
    return JModelState(geometry=j_new_geometry(jnp.asarray(a["H"]),
                                               jnp.asarray(a["bed"])),
                       enthalpy=jnp.asarray(a["enthalpy"]),
                       bedrock_temperature=jnp.asarray(
                           a["bedrock_temperature"]),
                       **{n: jnp.asarray(a[n]) for n in FIELDS2})


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _assert_states_equal(s, ref):
    for name in ("ice_thickness", "bed_elevation", "sea_level",
                 "ice_area_specific_volume", "ice_surface_elevation",
                 "cell_type"):
        np.testing.assert_array_equal(_np(getattr(s.geometry, name)),
                                      _np(getattr(ref.geometry, name)), name)
    for name in ("enthalpy", "bedrock_temperature") + FIELDS2:
        np.testing.assert_array_equal(_np(getattr(s, name)),
                                      _np(getattr(ref, name)), name)


@pytest.mark.parametrize("fmt", ["netcdf4", "netcdf3"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_roundtrip_to_the_bit(tmp_path, fmt, dtype):
    grid = Grid(**GRID)
    cfg = Config({**CFG, "runtime.float_dtype": dtype})
    state = _torch_state(_arrays(1), getattr(torch, dtype))
    path = str(tmp_path / "s.nc")
    ckpt.save_state(path, state, grid, 123.0 * SPY, config=cfg, format=fmt)
    with open(path, "rb") as fh:
        assert (fh.read(3) == b"CDF") == (fmt == "netcdf3")
    assert ckpt.load_grid(path) == grid
    assert ckpt.load_config(path).non_default() == cfg.non_default()
    back, t = ckpt.load_state(path, device="cpu")
    assert t == 123.0 * SPY
    _assert_states_equal(back, state)
    assert back.geometry.ice_thickness.dtype == getattr(torch, dtype)
    assert back.till_phi is None and back.firn_depth is None
    with File(path, "r") as f:
        assert f.read_attrs("time")["calendar"] == "360_day"
        assert f.read("mask").dtype == np.int32
        assert f.get_global_attr("title") == "io test"


@pytest.mark.parametrize("fmt", ["netcdf4", "netcdf3"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_files_read_across_packages(tmp_path, fmt, writer):
    a = _arrays(2)
    path = str(tmp_path / "s.nc")
    t = 42.5 * SPY
    if writer == "jax":
        j_ckpt.save_state(path, _jax_state(a), JGrid(**GRID), t,
                          config=JConfig(CFG), format=fmt)
        state, t2 = ckpt.load_state(path, device="cpu")
        grid, cfg = ckpt.load_grid(path), ckpt.load_config(path)
        ref = _torch_state(a)
    else:
        ckpt.save_state(path, _torch_state(a), Grid(**GRID), t,
                        config=Config(CFG), format=fmt)
        state, t2 = j_ckpt.load_state(path)
        grid, cfg = j_ckpt.load_grid(path), j_ckpt.load_config(path)
        ref = _jax_state(a)
    assert t2 == t
    assert {k: getattr(grid, k) for k in GRID} == GRID
    assert cfg.non_default() == Config(CFG).non_default()
    _assert_states_equal(state, ref)


@pytest.mark.parametrize("fmt", ["netcdf3", "netcdf4"])
def test_unported_state_variables_raise(tmp_path, fmt):
    """A JAX file holding the state of the tracer components (the age, the
    CH system, the fracture density and age, the isochrone layers and the
    active layer), which the port refused before it carried them, loads
    with the JAX values; the 3D fields come back level-major, as their
    column solves leave them."""
    a = _arrays(3)
    path = str(tmp_path / "s.nc")
    g = JGrid(**GRID)
    rng = np.random.default_rng(4)
    extra = {"age": rng.uniform(0, 1e12, g.shape3),
             "ch_enthalpy": rng.uniform(1e5, 3e5, g.shape3),
             "fracture_density": rng.uniform(0, 1, g.shape2),
             "fracture_age": rng.uniform(0, 1e9, g.shape2),
             "iso_layers": rng.uniform(0, 100, g.shape2 + (6,))}
    js = _jax_state(a).replace(iso_top=jnp.asarray(3, jnp.int32),
                               **{k: jnp.asarray(v) for k, v in extra.items()})
    j_ckpt.save_state(path, js, g, 0.0, config=JConfig(CFG), format=fmt)
    st, t = ckpt.load_state(path, device="cpu")
    for name, want in extra.items():
        got = getattr(st, name)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
    assert st.iso_top == 3
    for name in ("enthalpy", "age", "ch_enthalpy"):
        assert getattr(st, name).movedim(-1, 0).is_contiguous(), name


def _halfar(fmt, tmp_path):
    from pism_tpu_torch.coupler.surface import Uniform
    from pism_tpu_torch.model.icemodel import IceModel
    from pism_tpu_torch.verification import halfar

    sol = halfar.test_B()
    grid = Grid(Mx=31, My=31, Lx=900e3, Ly=900e3)
    cfg = Config({"stress_balance.model": "sia",
                  "stress_balance.sia.flow_law": "isothermal_glen",
                  "flow_law.isothermal_Glen.ice_softness": halfar.A_SOFTNESS,
                  "energy.model": "none"})
    H0 = torch.as_tensor(sol.thickness(sol.t0, grid.radius))
    state0 = ModelState(geometry=new_geometry(H0, torch.zeros_like(H0)))
    model = IceModel(grid=grid, config=cfg, surface=Uniform(smb=0.0),
                     device="cpu")
    return model, state0, grid, cfg, sol.t0, 50 * SPY, 100 * SPY


def _hybrid_pdd(fmt, tmp_path, hydrology="null"):
    from pism_tpu_torch.coupler.atmosphere import SeariseGreenland
    from pism_tpu_torch.coupler.pdd import TemperatureIndex
    from pism_tpu_torch.model.icemodel import IceModel

    grid = Grid(Mx=20, My=24, Lx=200e3, Ly=240e3, Mz=15, Lz=3000.0)
    cfg = Config({"stress_balance.model": "ssa+sia",
                  "energy.model": "enthalpy",
                  "basal_resistance.pseudo_plastic.enabled": True,
                  "basal_yield_stress.model": "mohr_coulomb",
                  "hydrology.model": hydrology,
                  "geometry.part_grid.enabled": True})
    if hydrology != "null":
        # the routed water from the PDD's runoff, over a saturated till
        cfg.update({"hydrology.surface_input_from_runoff": True,
                    "hydrology.tillwat_decay_rate": 0.0,
                    "basal_yield_stress.add_transportable_water": True})
    X, Y = np.meshgrid(grid.x, grid.y)
    r2 = (X / 150e3) ** 2 + (Y / 190e3) ** 2
    bed = torch.as_tensor(200.0 - 700.0 * r2)
    H = torch.as_tensor(1500.0 * np.maximum(1.0 - r2, 0.0))
    atm = SeariseGreenland(latitude=torch.as_tensor(70.0 + Y / 240e3),
                           longitude=torch.as_tensor(-40.0 + X / 200e3),
                           precipitation=torch.full(grid.shape2, 0.4 / SPY,
                                                    dtype=torch.float64))
    model = IceModel(grid=grid, config=cfg,
                     surface=TemperatureIndex(atmosphere=atm, config=cfg),
                     device="cpu")
    state0 = model.prepare_state(ModelState(
        geometry=new_geometry(H, bed),
        tillwat=None if hydrology == "null" else torch.full_like(H, 2.0)))
    return model, state0, grid, cfg, 0.0, 0.75 * SPY, 1.5 * SPY


def _hybrid_routing(fmt, tmp_path):
    return _hybrid_pdd(fmt, tmp_path, "routing")


def _hybrid_distributed(fmt, tmp_path):
    return _hybrid_pdd(fmt, tmp_path, "distributed")


@pytest.mark.parametrize("case,fmt", [(_halfar, "netcdf4"),
                                      (_halfar, "netcdf3"),
                                      (_hybrid_pdd, "netcdf3"),
                                      (_hybrid_routing, "netcdf4"),
                                      (_hybrid_distributed, "netcdf3")],
                         ids=["halfar_B-netcdf4", "halfar_B-netcdf3",
                              "hybrid_pdd-netcdf3", "hybrid_routing-netcdf4",
                              "hybrid_distributed-netcdf3"])
def test_restart_through_file_bit_stable(tmp_path, fmt, case):
    """Two segments in memory against the same two with the state saved
    and read back between them: every field of the end state equal to the
    bit (``tests/test_io.py:69`` and ``:100``; the hybrid chain over 0.75 a
    + 0.75 a instead of 3 a + 3 a, to keep the test short)."""
    model, state0, grid, cfg, t0, seg, total = case(fmt, tmp_path)
    sB, tB, _ = model.step_once(state0, t0, seg)
    sA, tA, _ = model.step_once(sB, tB, t0 + total - tB)

    path = str(tmp_path / "restart.nc")
    ckpt.save_state(path, sB, grid, tB, config=cfg, format=fmt)
    sB2, tB2 = ckpt.load_state(path, config=cfg, device="cpu")
    assert tB2 == tB
    sB3, tB3, _ = model.step_once(sB2, tB2, t0 + total - tB2)
    assert tB3 == tA
    for name in ("enthalpy", "u_ssa", "v_ssa", "snow_depth", "firn_depth",
                 "basal_melt_rate", "tillwat", "hydro_W", "hydro_P",
                 "hydro_Q"):
        a, b = getattr(sA, name), getattr(sB3, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert torch.equal(a, b), name
    assert torch.equal(sA.geometry.ice_thickness, sB3.geometry.ice_thickness)
    if case is _hybrid_pdd:
        assert float(sB.snow_depth.max()) > 0
    if case in (_hybrid_routing, _hybrid_distributed):
        assert float(sB.hydro_W.max()) > 0
        with File(path, "r") as f:
            assert f.has_variable("bwat") and f.has_variable("bwp") \
                == (case is _hybrid_distributed)


_NO_H5PY = """
import sys
sys.modules["h5py"] = None        # as on a machine without h5py
import numpy as np
from pism_tpu_torch.io.nc4 import File, NetCDF4Unavailable
out = sys.argv[1]
for mode in ("w", "r"):
    try:
        File(sys.argv[2] if mode == "r" else out + "/x.nc", mode)
    except NetCDF4Unavailable as e:
        assert "-o_format netcdf3" in str(e), e
    else:
        raise AssertionError("no error for mode " + mode)
with File(out + "/c.nc", "w", format="netcdf3") as f:
    f.define_dimension("x", 3, np.arange(3.0))
    f.write("v", np.ones(3), ("x",))
with File(out + "/c.nc", "r") as f:
    assert f.read("v").tolist() == [1.0, 1.0, 1.0]
print("ok")
"""


def test_netcdf4_without_h5py_raises(tmp_path):
    """Without h5py a NetCDF-4 file can be neither written nor read, and
    the error names ``-o_format netcdf3``; classic files still work."""
    h5 = tmp_path / "h5.nc"
    with File(str(h5), "w") as f:
        f.define_dimension("x", 2, np.arange(2.0))
    out = subprocess.run([sys.executable, "-c", _NO_H5PY, str(tmp_path),
                          str(h5)], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
    assert not (tmp_path / "x.nc").exists()


def test_classic_file_is_not_appended(tmp_path):
    path = str(tmp_path / "c.nc")
    ckpt.save_state(path, _torch_state(_arrays(4)), Grid(**GRID), 0.0,
                    format="netcdf3")
    with pytest.raises(ValueError, match="classic"):
        File(path, "a")


def test_netcdf4_structure(tmp_path):
    """The port's NetCDF-4 files are HDF5 with netCDF-4 dimension scales,
    as the JAX package's (``tests/test_io.py::test_nc4_structure``)."""
    import h5py

    path = str(tmp_path / "s.nc")
    ckpt.save_state(path, _torch_state(_arrays(5)), Grid(**GRID), 1.0)
    with h5py.File(path, "r") as h5:
        assert "_NCProperties" in h5.attrs
        assert h5["y"].attrs["CLASS"] == b"DIMENSION_SCALE"
        assert h5["thk"].shape == (1, 9, 11)
        assert h5["enthalpy"].shape == (1, 9, 11, 5)
        assert h5["litho_temp"].shape == (1, 9, 11, 3)
        assert h5["thk"].attrs["units"] == "m"


def test_append_diagnostics_equals_one_pass(tmp_path):
    """``append_diagnostics`` on a NetCDF-4 state file writes the values
    that ``save_state(..., diagnostics=...)`` writes in one pass."""
    from pism_tpu_torch import setups

    model, state, grid, _ = setups.halfar_model("B", Mx=11, device="cpu")
    names = ["thk", "velbar_mag", "diffusivity", "sftgif", "no_such_name"]
    one, two = str(tmp_path / "one.nc"), str(tmp_path / "two.nc")
    values = ckpt.diagnostic_values(names, state, model, 0.0)
    assert sorted(values) == ["diffusivity", "sftgif", "thk", "velbar_mag"]
    ckpt.save_state(one, state, grid, 0.0, config=model.config,
                    format="netcdf3", diagnostics=values)
    ckpt.save_state(two, state, grid, 0.0, config=model.config)
    ckpt.append_diagnostics(two, names, state, model, 0.0)
    with File(one, "r") as a, File(two, "r") as b:
        assert sorted(a.variables()) == sorted(b.variables())
        for v in a.variables():
            np.testing.assert_array_equal(a.read(v), b.read(v), v)
            assert a.read_attrs(v).get("units") == b.read_attrs(v).get("units")


HYDRO_DIAGS = ("bwat", "bwp", "bwprel", "effbwp", "hydraulic_potential",
               "bwatflux", "bwatvel_x", "bwatvel_y", "wallmelt",
               "frontal_melt_rate", "frontal_melt_retreat_rate",
               "total_retreat_rate")


@pytest.mark.parametrize("hydrology", ["routing", "distributed", "steady"])
def test_hydrology_and_frontal_melt_diagnostics_match(hydrology):
    """The hydrology's and the frontal melt's spatial diagnostics equal the
    JAX package's on one state (1e-12 relative)."""
    from pism_tpu.coupler.surface import Uniform as JUniform
    from pism_tpu.model import diagnostics as j_dg
    from pism_tpu.model.icemodel import IceModel as JIceModel
    from pism_tpu_torch.coupler.surface import Uniform
    from pism_tpu_torch.model import diagnostics as dg
    from pism_tpu_torch.model.icemodel import IceModel

    over = {"stress_balance.model": "ssa+sia", "energy.model": "enthalpy",
            "basal_yield_stress.model": "mohr_coulomb",
            "hydrology.model": hydrology,
            "calving.methods": "eigen_calving",
            "calving.eigen_calving.K": 3.0e16,
            "frontal_melt.models": "constant",
            "frontal_melt.constant.melt_rate": 150.0,
            "frontal_melt.include_floating_ice": True}
    g = Grid(Mx=20, My=24, Lx=200e3, Ly=240e3, Mz=5, Lz=3000.0)
    a = _arrays(21)
    rng = np.random.default_rng(22)
    H = np.where(a["bed"] < 200.0, a["H"], 0.0)[:9, :11]
    H = np.pad(H, ((0, 15), (0, 9)))
    bed = np.pad(a["bed"][:9, :11], ((0, 15), (0, 9)), constant_values=-600.0)
    f = {"hydro_W": rng.uniform(0.0, 0.4, g.shape2),
         "hydro_P": 910.0 * 9.81 * H * rng.uniform(0.2, 1.0, g.shape2),
         "hydro_Q": rng.uniform(0.0, 1e-2, g.shape2),
         "u_ssa": rng.normal(0.0, 1e-5, g.shape2),
         "v_ssa": rng.normal(0.0, 1e-5, g.shape2),
         "tillwat": rng.uniform(0.0, 2.0, g.shape2)}
    if hydrology != "distributed":
        f.pop("hydro_P")
    if hydrology != "steady":
        f.pop("hydro_Q")
    jm = JIceModel(grid=JGrid(**{k: getattr(g, k) for k in
                                 ("Mx", "My", "Lx", "Ly", "Mz", "Lz")}),
                   config=JConfig(over), surface=JUniform())
    tm = IceModel(grid=g, config=Config(over), surface=Uniform(),
                  device="cpu")
    js = JModelState(geometry=j_new_geometry(jnp.asarray(H),
                                             jnp.asarray(bed)),
                     **{k: jnp.asarray(v) for k, v in f.items()})
    ts = ModelState(geometry=new_geometry(torch.tensor(H), torch.tensor(bed)),
                    **{k: torch.tensor(v) for k, v in f.items()})
    for name in HYDRO_DIAGS:
        want = np.asarray(j_dg.SPATIAL[name].func(js, jm, 0.0))
        got = dg.SPATIAL[name].func(ts, tm, 0.0).numpy()
        scale = max(np.abs(want).max(), 1e-300)
        assert np.abs(got - want).max() <= 1e-12 * scale, name
    assert float(np.abs(dg.SPATIAL["frontal_melt_retreat_rate"].func(
        ts, tm, 0.0)).max()) > 0.0


def test_subglacial_water_window_counts_the_routed_layer(tmp_path):
    """The reporting window's water amount is the till's plus the routed
    layer's, as the JAX output samples it, so
    ``tendency_of_subglacial_water_mass`` sees the routed water."""
    from pism_tpu_torch.model.output import OutputManager

    model, state0, grid, cfg, *_ = _hybrid_routing("netcdf3", tmp_path)
    W = torch.as_tensor(np.random.default_rng(23).uniform(
        0.0, 0.5, grid.shape2))
    state = state0.replace(hydro_W=W)
    out = OutputManager(grid=grid, config=cfg, format="netcdf3",
                        extra_vars=("tendency_of_subglacial_water_mass",),
                        extra_times=[0.0, SPY],
                        extra_file=str(tmp_path / "ex.nc"))
    assert out.needs_cell_budget
    s = out._sample(state, 0.0, model, None, cells=True)
    np.testing.assert_array_equal(s["water"], (state.tillwat + W).numpy())
