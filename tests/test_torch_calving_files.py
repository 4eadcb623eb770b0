"""The file-driven calving inputs (``model/calving.py``), pism_tpu_torch
against pism_tpu on the CPU in float64 on the geometry of
``tests/test_torch_calving.py``: the prescribed retreat masks
(``geometry.front_retreat.prescribed.file``, a stack of records and a
single field), the calving-rate scaling series
(``calving.rate_scaling.file``) and the 2D thresholds
(``calving.thickness_calving.file``,
``calving.vonmises_calving.sigma_max_file``), each through the calving
step at several model times, its parts included (1e-12 relative); and the
refusal of prescribed retreat without a file, as the JAX package's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pism_tpu import Config as JConfig, Grid as JGrid
from pism_tpu.model import calving as j_calv
from pism_tpu_torch import Config, Grid
from pism_tpu_torch.io.nc4 import File
from pism_tpu_torch.model import calving as t_calv

from test_torch_calving import (DT, GRID, SB, SPY, _close, _inputs, _jgeom,
                                _tgeom)

torch.set_num_threads(2)

TIMES = [-2.0 * SPY, 0.5 * SPY, 3.0 * SPY, 11.0 * SPY]


def _grid_file(path, fields, times=None, fmt="netcdf3"):
    g = Grid(**GRID)
    with File(path, "w", format=fmt) as f:
        if times is not None:
            f.define_dimension("time", None, attrs={
                "units": "years since 1-1-1"})
        f.define_dimension("y", g.My, g.y)
        f.define_dimension("x", g.Mx, g.x)
        for name, a in fields.items():
            if times is None:
                f.write(name, a, ("y", "x"))
        if times is not None:
            for k, t in enumerate(times):
                n = f.append_time(t)
                for name, a in fields.items():
                    f.write(name, a[k][None], ("time", "y", "x"),
                            time_index=n)
    return path


def _series(path, name, t, v):
    with File(path, "w", format="netcdf3") as f:
        f.define_dimension("time", len(t), np.asarray(t, float), attrs={
            "units": "years since 1-1-1"})
        f.write(name, np.asarray(v, float), ("time",))
    return path


def _files(d):
    rng = np.random.default_rng(17)
    shp = (GRID["My"], GRID["Mx"])
    frac = np.clip(rng.uniform(-0.3, 1.3, (3,) + shp), 0.0, 1.0)
    return {
        "stack": _grid_file(str(d / "retreat.nc"),
                            {"land_ice_area_fraction_retreat": frac},
                            times=[0.0, 2.0, 10.0]),
        "single": _grid_file(str(d / "retreat1.nc"),
                             {"land_ice_area_fraction_retreat": frac[1]}),
        "scaling": _series(str(d / "scale.nc"), "frac_calving_rate",
                           [0.0, 5.0, 12.0], [0.5, 2.0, 1.2]),
        "thickness": _grid_file(str(d / "thk.nc"), {
            "calving_threshold": rng.uniform(50.0, 400.0, shp)}),
        "sigma_max": _grid_file(str(d / "sig.nc"), {
            "sigma_max": rng.uniform(0.5e6, 2e6, shp)}),
    }


def _cases(f):
    return {
        "prescribed_stack": {
            "calving.methods": "prescribed_retreat,thickness_calving",
            "geometry.front_retreat.prescribed.file": f["stack"]},
        "prescribed_single": {
            "calving.methods": "prescribed_retreat",
            "geometry.front_retreat.prescribed.file": f["single"]},
        "rate_scaling": {
            "calving.methods": "vonmises_calving",
            "calving.rate_scaling.file": f["scaling"]},
        "thickness_file": {
            "calving.methods": "thickness_calving",
            "calving.thickness_calving.threshold": 100.0,
            "calving.thickness_calving.file": f["thickness"]},
        "sigma_max_file": {
            "calving.methods": "vonmises_calving",
            "calving.vonmises_calving.sigma_max_file": f["sigma_max"]},
    }


CASES = ["prescribed_stack", "prescribed_single", "rate_scaling",
         "thickness_file", "sigma_max_file"]


@pytest.mark.parametrize("case", CASES)
def test_file_driven_calving_matches(tmp_path, case):
    over = _cases(_files(tmp_path))[case]
    cfg = dict({"runtime.float_dtype": "float64",
                "geometry.part_grid.enabled": True,
                "geometry.remove_icebergs": True,
                "calving.eigen_calving.K": 3.0e16}, **over)
    jm = j_calv.CalvingModel(grid=JGrid(**GRID), config=JConfig(cfg))
    tm = t_calv.CalvingModel(grid=Grid(**GRID), config=Config(cfg))
    geom, u, v, B = _inputs()
    results = []
    for t in TIMES:
        jout, jparts = jm.step(_jgeom(geom), SB(jnp.asarray(u),
                                                jnp.asarray(v)),
                               DT, t=t, hardness_B=jnp.asarray(B),
                               with_parts=True)
        tout, tparts = tm.step(_tgeom(geom), SB(torch.tensor(u),
                                                torch.tensor(v)),
                               DT, t=t, hardness_B=torch.tensor(B),
                               with_parts=True)
        for name in ("ice_thickness", "ice_area_specific_volume"):
            _close(getattr(tout, name), getattr(jout, name),
                   f"{name} at {t / SPY} a")
        for k in ("calving", "frontal_melt", "forced_retreat"):
            _close(tparts[k], jparts[k], f"{k} at {t / SPY} a")
        results.append(tout.ice_thickness + tout.ice_area_specific_volume)
    if case in ("prescribed_stack", "rate_scaling"):
        # the records (the scaling) differ in time
        assert not torch.equal(results[0], results[-1])
    if case.startswith("prescribed"):
        assert float(tparts["forced_retreat"].sum()) < 0.0


def test_prescribed_retreat_needs_its_file():
    cfg = {"calving.methods": "prescribed_retreat"}
    with pytest.raises(ValueError, match="prescribed.file"):
        j_calv.CalvingModel(grid=JGrid(**GRID), config=JConfig(cfg))
    with pytest.raises(ValueError, match="prescribed.file"):
        t_calv.CalvingModel(grid=Grid(**GRID), config=Config(cfg))
