"""Parameter wiring of the MISMIP modules (the isothermal SSA+SIA with no
energy model, the constant and given yield stresses, periodic grids):
every key the JAX twins read on this path is read by the port on the same
path, or the port raises NotImplementedError when it (or the key that
gates its use) is set off its default, as
``tests/test_torch_coupler_factory.py::test_parameter_wiring`` holds the
bootstrap, coupler and PIK modules; and of the hydrology and frontal-melt
slice (every ``hydrology.*`` and ``frontal_melt.*`` key the JAX twins read
is read by the port)."""

import numpy as np
import pytest

from pism_tpu import Config as JConfig
from pism_tpu_torch import Config

#: the keys MISMIP3d and MISMIP experiment 1 set or rely on
MISMIP_KEYS = {"basal_yield_stress.constant.value",
               "basal_yield_stress.given.file",
               "flow_law.isothermal_Glen.ice_softness",
               "stress_balance.ssa.flow_law", "grid.periodicity",
               "geometry.grounded_cell_fraction"}
#: read by the JAX flow-law factory before it picks the law; the isothermal
#: law uses none of them
UNUSED = {"constants.ideal_gas_constant", "flow_law.Paterson_Budd.A_cold",
          "flow_law.Paterson_Budd.A_warm", "flow_law.Paterson_Budd.Q_cold",
          "flow_law.Paterson_Budd.Q_warm",
          "flow_law.Paterson_Budd.T_critical",
          # the JAX SSA reads it for regional mode's no_model_mask, which
          # the port's SSA does not take (ROADMAP Queue 1 item 7)
          "regional.zero_gradient"}
#: keys whose use another setting gates, with that setting: the port refuses
#: the setting
GATED = {
    "stress_balance.ssa.fd.lateral_drag.viscosity": {
        "stress_balance.ssa.fd.lateral_drag.enabled": True},
    "stress_balance.ssa.fd.mixed_production_rtol": {
        "stress_balance.ssa.fd.solve_dtype": "mixed",
        "runtime.float_dtype": "float32"},
}
BASE = {"stress_balance.model": "ssa+sia", "energy.model": "none",
        "stress_balance.sia.flow_law": "isothermal_glen",
        "stress_balance.ssa.flow_law": "isothermal_glen",
        "grid.periodicity": "y", "grid.Mx": 9, "grid.My": 5,
        "geometry.grounded_cell_fraction": True}


def _tauc_file(path):
    from scipy.io import netcdf_file
    from pism_tpu_torch import Grid
    g = Grid.from_config(Config(BASE))
    with netcdf_file(str(path), "w") as f:
        f.createDimension("x", g.Mx)
        f.createDimension("y", g.My)
        f.createVariable("x", "d", ("x",))[:] = g.x
        f.createVariable("y", "d", ("y",))[:] = g.y
        f.createVariable("tauc", "d", ("y", "x"))[:] = np.full(g.shape2, 1e5)


def _run(pkg, cfg):
    """The path's modules: the grid from the config, each yield stress of
    the factory, the flow laws, the SSA, and (port) the model that builds
    them, whose refusals gate the keys above."""
    if pkg == "jax":
        from pism_tpu.grid import Grid
        from pism_tpu.model.ssa import SSAFD
        from pism_tpu.physics import basal, rheology
    else:
        from pism_tpu_torch.coupler.surface import Uniform
        from pism_tpu_torch.grid import Grid
        from pism_tpu_torch.model.icemodel import IceModel
        from pism_tpu_torch.model.ssa import SSAFD
        from pism_tpu_torch.physics import basal, rheology
    grid = Grid.from_config(cfg)
    for name in ("constant", "given"):
        cfg.update({"basal_yield_stress.model": name})
        basal.yield_stress_from_config(cfg, grid)
        if pkg != "jax":
            IceModel(grid=grid, config=cfg, surface=Uniform(), device="cpu")
    rheology.flow_law_from_config(cfg, "sia")
    SSAFD(grid=grid, config=cfg, flow_law=rheology.flow_law_from_config(
        cfg, "ssa"))


def _reads(pkg, over):
    cfg = (JConfig if pkg == "jax" else Config)(dict(BASE, **over))
    _run(pkg, cfg)
    return set(cfg.used_parameters())


def test_mismip_parameter_wiring(tmp_path):
    path = tmp_path / "tauc.nc"
    _tauc_file(path)
    over = {"basal_yield_stress.given.file": str(path)}
    jax_reads, port_reads = _reads("jax", over), _reads("torch", over)
    assert MISMIP_KEYS <= jax_reads and MISMIP_KEYS <= port_reads
    missing = jax_reads - port_reads - UNUSED
    assert missing == set(GATED)
    for key in sorted(missing):
        with pytest.raises(NotImplementedError):
            _reads("torch", dict(over, **GATED[key]))
    # the SSA reads the fracture softening's limit as the JAX one does
    assert "fracture_density.softening_lower_limit" in port_reads
    # a law other than the isothermal one is refused on this isothermal
    # path (by the model; the factory builds every law)
    with pytest.raises(NotImplementedError):
        _reads("torch", dict(over, **{"stress_balance.ssa.flow_law": "hooke"}))


#: the keys of the hydrology and frontal-melt slice: every ``hydrology.*``
#: and ``frontal_melt.*`` key, and the yield stress's transportable water
SLICE_KEYS = ("basal_yield_stress.add_transportable_water",
              "basal_yield_stress.mohr_coulomb."
              "till_log_factor_transportable_water")


def _slice(keys):
    return {k for k in keys
            if k.startswith(("hydrology.", "frontal_melt.")) or k in SLICE_KEYS}


def _slice_reads(pkg, over):
    """The slice's modules on a small cap: the hydrology of the factory
    (a step; the steady model's with a stored discharge and its step end),
    the Mohr-Coulomb yield stress, the frontal melt of the factory and the
    front retreat it drives."""
    import jax.numpy as jnp
    import torch
    if pkg == "jax":
        from pism_tpu import state as S
        from pism_tpu.coupler.frontalmelt import frontal_melt_from_config
        from pism_tpu.grid import Grid
        from pism_tpu.model.calving import CalvingModel
        from pism_tpu.physics import basal
        from pism_tpu.physics.hydrology import hydrology_from_config
        arr, cfg = jnp.asarray, JConfig(dict(over))
    else:
        from pism_tpu_torch import state as S
        from pism_tpu_torch.coupler.frontalmelt import frontal_melt_from_config
        from pism_tpu_torch.grid import Grid
        from pism_tpu_torch.model.calving import CalvingModel
        from pism_tpu_torch.physics import basal
        from pism_tpu_torch.physics.hydrology import hydrology_from_config
        arr, cfg = torch.tensor, Config(dict(over))
    grid = Grid(Mx=9, My=7, Lx=20e3, Ly=15e3)
    X, Y = np.meshgrid(grid.x, grid.y)
    H = np.maximum(800.0 * (1.0 - (X / 15e3) ** 2 - (Y / 11e3) ** 2), 0.0)
    z = np.zeros(grid.shape2)
    state = S.ModelState(
        geometry=S.new_geometry(arr(H), arr(-0.004 * np.abs(X) - 20.0)),
        tillwat=arr(z + 2.0), basal_melt_rate=arr(z + 1e-9),
        hydro_W=arr(z + 0.1), hydro_Q=arr(z), u_ssa=arr(z), v_ssa=arr(z))
    hyd = hydrology_from_config(grid, cfg) if pkg == "jax" \
        else hydrology_from_config(grid, cfg, device="cpu")
    kw = {"t": 20.0 * 3.15569259747e7} if type(hyd).__name__ == "Steady" \
        else {}
    state = hyd.step(state, 1e5, **kw)
    basal.MohrCoulombYieldStress(cfg).compute(state)
    fields = {k: arr(z + 1.0) for k in ("frontal_melt_rate", "theta_ocean",
                                         "subglacial_discharge")}
    fm = frontal_melt_from_config(cfg, grid, inputs=fields)
    if fm is not None:
        rate = fm(state.geometry, 0.0, state=state)
        CalvingModel(grid=grid, config=cfg, methods=("none",)).step(
            state.geometry, None, 1e5, frontal_melt_rate=rate)
    return _slice(cfg.used_parameters())


def _input_file(path):
    from scipy.io import netcdf_file
    from pism_tpu_torch import Grid
    g = Grid(Mx=9, My=7, Lx=20e3, Ly=15e3)
    with netcdf_file(str(path), "w") as f:
        f.createDimension("x", g.Mx)
        f.createDimension("y", g.My)
        f.createVariable("x", "d", ("x",))[:] = g.x
        f.createVariable("y", "d", ("y",))[:] = g.y
        f.createVariable("water_input_rate", "d", ("y", "x"))[:] = \
            np.full(g.shape2, 1e-9)


@pytest.mark.parametrize("hydrology", ["null", "routing", "distributed",
                                       "steady"])
@pytest.mark.parametrize("frontal_melt", ["", "constant", "given", "routing",
                                          "discharge_given"])
def test_hydrology_frontal_melt_parameter_wiring(tmp_path, hydrology,
                                                 frontal_melt):
    """Every ``hydrology.*`` and ``frontal_melt.*`` key, and the yield
    stress's transportable-water pair, that the JAX twins read on this
    slice is read by the port on the same path."""
    path = tmp_path / "input.nc"
    _input_file(path)
    over = {"hydrology.model": hydrology,
            "hydrology.surface_input.file": str(path),
            "hydrology.surface_input_from_runoff": True,
            "basal_yield_stress.add_transportable_water": True,
            "frontal_melt.models": frontal_melt}
    jax_reads = _slice_reads("jax", over)
    port_reads = _slice_reads("torch", over)
    assert SLICE_KEYS[0] in jax_reads and "hydrology.model" in jax_reads
    assert jax_reads - port_reads == set()


def test_inverse_parameter_wiring(tmp_path, monkeypatch):
    """Every ``inverse.*`` key of the parameter database (all of which the
    JAX package's ``-inverse`` driver reads) is read by the port's
    ``-inverse`` over its three routes: tau_c by L-BFGS (the default), tau_c
    by Adam, the hardness."""
    from pism_tpu.config.parameters import PARAMETERS as J_PARAMETERS
    from pism_tpu_torch import cli as t_cli
    from pism_tpu_torch.config import config as tc
    from test_torch_cli import INVERSE_ARGV, inverse_inputs

    read = set()
    get = tc.Config._get

    def recording_get(self, name):
        read.add(name)
        return get(self, name)

    monkeypatch.setattr(tc.Config, "_get", recording_get)
    dome, obs = inverse_inputs(tmp_path)
    for route in ([], ["-inv_method", "adam"], ["-inv_design", "hardav"]):
        assert t_cli.main(["-i", dome, "-inv_data", obs] + INVERSE_ARGV + [
            "-config", "inverse.max_iterations=1", *route,
            "-o", str(tmp_path / "o.nc"), "-o_format", "netcdf3",
            "-platform", "cpu"]) == 0
    keys = {k for k in J_PARAMETERS if k.startswith("inverse.")}
    assert len(keys) == 19
    assert keys - read == set()


def _literal_keys(paths):
    import pathlib
    import re
    root = pathlib.Path(__file__).resolve().parents[1]
    text = "".join((root / p).read_text() for p in paths)
    return set(re.findall(r'"([a-z_]+(?:\.[A-Za-z_0-9]+)+)"', text))


def test_coupler_modules_name_every_key():
    """Every parameter that the JAX coupler modules name (``pism_tpu/
    coupler/*.py``, a literal search) and the file-driven calving inputs of
    ``model/calving.py`` is named by the port's twins."""
    import pathlib
    from pism_tpu_torch.config.parameters import PARAMETERS
    root = pathlib.Path(__file__).resolve().parents[1]
    jax_files = [p.relative_to(root) for p in
                 (root / "pism_tpu" / "coupler").glob("*.py")]
    port_files = [p.relative_to(root) for p in
                  (root / "pism_tpu_torch" / "coupler").glob("*.py")]
    keys = {k for k in _literal_keys(jax_files) if k in PARAMETERS}
    assert len(keys) >= 150
    assert keys - _literal_keys(port_files) == set()
    calving = {"calving.rate_scaling.file", "calving.thickness_calving.file",
               "calving.vonmises_calving.sigma_max_file",
               "geometry.front_retreat.prescribed.file"}
    assert calving <= _literal_keys(["pism_tpu/model/calving.py"])
    assert calving <= _literal_keys(["pism_tpu_torch/model/calving.py"])


@pytest.mark.parametrize("key", [
    "calving.rate_scaling.file", "calving.thickness_calving.file",
    "calving.vonmises_calving.sigma_max_file",
    "geometry.front_retreat.prescribed.file"])
def test_calving_file_keys_are_read(key):
    """The port's calving model reads each file key as the JAX one does
    (an empty name reads no file)."""
    from pism_tpu.grid import Grid as JGrid
    from pism_tpu.model import calving as j_calv
    from pism_tpu_torch import Grid
    from pism_tpu_torch.model import calving as t_calv
    methods = "prescribed_retreat" if "front_retreat" in key \
        else "thickness_calving,vonmises_calving"
    reads = []
    for C, G, m in ((JConfig, JGrid, j_calv), (Config, Grid, t_calv)):
        cfg = C({"calving.methods": methods,
                 "geometry.front_retreat.prescribed.file": "",
                 **({} if "front_retreat" not in key else {key: ""})})
        try:
            m.CalvingModel(grid=G(Mx=5, My=5, Lx=1e4, Ly=1e4), config=cfg)
        except ValueError:
            pass
        reads.append(key in set(cfg.used_parameters()))
    assert reads == [True, True]


#: the config groups of the tracer and damage slice
TRACER_PREFIXES = ("age.", "isochrones.", "fracture_density.",
                   "energy.ch_warming.", "energy.temperature_dependent",
                   "flow_law.", "time.eemian_", "time.holocene_start",
                   "stress_balance.sia.e_age_coupling",
                   "stress_balance.sia.enhancement_factor_interglacial",
                   "stress_balance.vertical_velocity_approximation",
                   "stress_balance.ssa.fd.brutal_sliding",
                   "bootstrapping.defaults.fracture_density")


def _tracer_reads(pkg, over):
    """The keys of the slice that the hybrid chain with every new component
    reads through its construction, ``prepare_state`` and one step (the
    JAX twin: ``bench.hybrid_greenland_model``), and every flow law of
    the factory."""
    import bench
    from pism_tpu_torch import setups
    SPY = 3.15569259747e7
    if pkg == "jax":
        from pism_tpu.physics import rheology
        model, state, _ = bench.hybrid_greenland_model(
            "float64", km=200.0, extra_cfg=over)
    else:
        from pism_tpu_torch.physics import rheology
        model, state, _ = setups.hybrid_greenland_model(
            "float64", km=200.0, device="cpu", extra_cfg=over)
    model.step_once(state, 0.0, 0.1 * SPY)
    cfg = model.config
    for name in ("isothermal_glen", "pb", "pb_cold", "pb_warm", "hooke",
                 "gpbld"):
        cfg.update({"stress_balance.sia.flow_law": name})
        rheology.flow_law_from_config(cfg, "sia")
    cfg.update({"flow_law.grain_aware_GK": True})
    rheology.flow_law_from_config(cfg, "sia")
    return {k for k in cfg.used_parameters() if k.startswith(TRACER_PREFIXES)}


@pytest.mark.parametrize("extra", [
    {}, {"fracture_density.max_shear_stress": True,
         "fracture_density.fd2d_scheme": False,
         "isochrones.deposition_times": "0.05,0.1",
         "isochrones.bootstrapping.n_layers": 4,
         "stress_balance.ssa.fd.brutal_sliding": True}])
def test_tracer_parameter_wiring(extra):
    """Every key of the slice's groups (``age.*``, ``isochrones.*``,
    ``fracture_density.*``, ``energy.ch_warming.*``, k(T), ``flow_law.*``,
    ``time.eemian_*``, ``time.holocene_start``, the SIA's age coupling,
    upstream w, brutal sliding) that the JAX twins read on the chain with
    every new component is read by the port on the same path."""
    from pism_tpu_torch import setups
    over = dict(setups.TRACER_CFG, **setups.FRACTURE_CFG, **extra)
    jax_reads = _tracer_reads("jax", over)
    port_reads = _tracer_reads("torch", over)
    assert {"age.initial_value", "time.holocene_start",
            "fracture_density.gamma", "energy.ch_warming.average_channel_"
            "spacing", "flow_law.Hooke.A"} <= jax_reads
    assert jax_reads - port_reads == set()
