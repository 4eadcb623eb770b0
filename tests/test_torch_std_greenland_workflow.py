"""The port's std-greenland workflow entry point on the CPU (twin of
``tests/test_std_greenland_workflow.py``): ``main()`` synthesizes the
SeaRISE-like data file, runs the three stages through the port's command
line, each restarting from the last, prints its JSON line and returns 0
when its ``ok`` test holds. Every output carries the data file's
polar-stereographic ``proj`` attribute and lat/lon with their bounds."""

import json
import os

import numpy as np
import pytest

from pism_tpu_torch import Grid
from pism_tpu_torch.examples import std_greenland_workflow as wf
from pism_tpu_torch.io.nc4 import File
from pism_tpu_torch.util import projection as prj


@pytest.mark.parametrize("o_format, workdir", [("netcdf3", "given"),
                                               ("netcdf4", "default")])
def test_workflow_main_quick(tmp_path, monkeypatch, capsys, o_format,
                             workdir):
    argv = ["--km", "100", "--quick", "--platform", "cpu",
            "--o_format", o_format]
    if workdir == "given":
        work = tmp_path / "wf"
        argv += ["--workdir", str(work)]
    else:
        monkeypatch.chdir(tmp_path)
        work = tmp_path / "std_greenland_100km"
    assert wf.main(argv) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("{")][-1]
    res = json.loads(line)
    assert res["ok"] is True
    assert res["stages_years"] == [2.0, 5.0, 5.0]
    v1, v2, v3 = res["volumes_km3"]
    assert abs(v2 - v1) < 0.02 * v1      # no-mass stage conserves geometry
    assert v3 > 0.2 * v1

    grid = Grid(Mx=16, My=29, Mz=41, Lx=wf.LX, Ly=wf.LY, Lz=4000.0)
    lon, lat = prj.lonlat_for_grid(grid, prj.from_proj_string(wf.SEARISE_PROJ))
    for name in ("g_boot.nc", "g_pre.nc", "g_nomass.nc", "g_spunup.nc"):
        path = os.path.join(work, name)
        assert os.path.exists(path), name
        with File(path, "r") as f:
            assert f.get_global_attr("proj") == wf.SEARISE_PROJ, name
            if name == "g_boot.nc":
                continue
            np.testing.assert_allclose(f.read("lat"), lat, rtol=0, atol=1e-12)
            np.testing.assert_allclose(f.read("lon"), lon, rtol=0, atol=1e-12)
            assert f.has_variable("lat_bnds") and f.has_variable("lon_bnds")
