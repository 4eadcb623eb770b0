"""The command line, pism_tpu_torch against pism_tpu on the CPU: the same
command lines through both packages' ``main`` give the same step counts
and dt-limit hits, and files with the same variables, dimensions, units
and time values, whose fields agree within 1e-10 of max (Halfar test B,
float64) and 1e-8 of max (EISMINT II A, float64, as
``tests/test_torch_eismint2.py`` holds the two packages' runs).

Each package's files are read by the port's reader in both formats: the
JAX package writes its series in NetCDF-4 and its state file in the
``-o_format`` given, the port writes every file of a run in that format.
The ``-eisII A -i`` restart, ``parse_times``, the shorthands, every option
the port does not carry (NotImplementedError), the card as the default
device, and the import purity of the new modules under an audit hook
are checked too.
"""

import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu import cli as j_cli  # noqa: E402
from pism_tpu_torch import cli as t_cli  # noqa: E402
from pism_tpu_torch.io import checkpoint as t_ckpt  # noqa: E402
from pism_tpu_torch.io.nc4 import File  # noqa: E402

SPY = 3.15569259747e7
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _count(capsys):
    """(steps, dt-limit hits) from the count_time_steps log line."""
    text = capsys.readouterr().out
    m = re.search(r"count_time_steps: (\d+) adaptive steps \(binding "
                  r"limits: (\{.*\})\)", text)
    assert m, text
    return int(m.group(1)), eval(m.group(2))


def _read(path):
    with File(str(path), "r") as f:
        return {v: (f.read(v), f.read_attrs(v).get("units"))
                for v in f.variables()}, f.read("time")


def _compare_files(a, b, tol):
    (va, ta), (vb, tb) = _read(a), _read(b)
    assert sorted(va) == sorted(vb)
    np.testing.assert_allclose(ta, tb, rtol=1e-12, atol=0)
    for name, (xa, ua) in va.items():
        xb, ub = vb[name]
        assert xa.shape == xb.shape, name
        assert ua == ub, name
        if xa.dtype.kind in "iub":
            np.testing.assert_array_equal(xa, xb, err_msg=name)
        else:
            scale = max(np.abs(xb).max(), 1e-300)
            assert np.abs(xa - xb).max() <= tol * scale, name


HALFAR = ["-test", "B", "-Mx", "31", "-y", "100", "-max_dt", "5",
          "-o", "{d}/b.nc", "-o_size", "medium",
          "-ts_file", "{d}/ts.nc", "-ts_times", "430:10:520",
          "-extra_file", "{d}/ex.nc", "-extra_times", "450:50:500",
          "-save_times", "480", "-save_file", "{d}/snap_{{kyr:.3f}}.nc"]
EISMINT = ["-eisII", "A", "-Mx", "21", "-Mz", "11", "-y", "50", "-max_dt", "5",
           "-o", "{d}/a.nc",
           "-ts_file", "{d}/ts.nc", "-ts_times", "5:5:50",
           "-extra_file", "{d}/ex.nc", "-extra_times", "10:20:50",
           "-save_times", "25", "-save_file", "{d}/snap_{{kyr:.3f}}.nc"]


@pytest.mark.parametrize("route,argv,tol,port_fmt,jax_fmt", [
    ("halfar", HALFAR, 1e-10, "netcdf3", "netcdf4"),
    ("eismint", EISMINT, 1e-8, "netcdf4", "netcdf3"),
])
def test_cli_matches_jax(tmp_path, capsys, route, argv, tol, port_fmt,
                         jax_fmt):
    capsys.readouterr()
    out = {}
    for pkg, main, fmt, extra in (("jax", j_cli.main, jax_fmt, []),
                                  ("torch", t_cli.main, port_fmt,
                                   ["-platform", "cpu"])):
        d = tmp_path / pkg
        d.mkdir()
        args = [a.format(d=d) for a in argv]
        assert main(args + ["-o_format", fmt, "-verbose", "1", "-config",
                            "time_stepping.count_time_steps=true"] + extra) == 0
        out[pkg] = (d, _count(capsys))
    (dj, cj), (dt, ct) = out["jax"], out["torch"]
    assert ct == cj
    names = sorted(p.name for p in dj.iterdir())
    assert names == sorted(p.name for p in dt.iterdir())
    assert len(names) == 4, names
    for name in names:
        _compare_files(dt / name, dj / name, tol)
    # the port's files are in its -o_format, the JAX package's series in
    # NetCDF-4 whatever -o_format says
    for name in names:
        with open(dt / name, "rb") as fh:
            assert (fh.read(3) == b"CDF") == (port_fmt == "netcdf3")


def test_series_record_counts(tmp_path):
    """The output times of ``chip_smoke.py`` phase 7a (EISMINT II A, 1000
    a): both packages write 11 scalar and 3 spatial records (the first
    segment ends at 50 a, where the records due at 0 a are written)."""
    counts = {}
    for pkg, main, extra in (("jax", j_cli.main, []),
                             ("torch", t_cli.main, ["-platform", "cpu"])):
        d = tmp_path / pkg
        d.mkdir()
        assert main(["-eisII", "A", "-Mx", "11", "-Mz", "5", "-y", "1000",
                     "-ts_file", str(d / "ts.nc"), "-ts_times", "0:100:1000",
                     "-extra_file", str(d / "ex.nc"),
                     "-extra_times", "0:500:1000", "-save_times", "500",
                     "-save_file", str(d / "snap.nc"), "-o", str(d / "a.nc"),
                     "-o_format", "netcdf3", "-verbose", "0"] + extra) == 0
        counts[pkg] = tuple(_read(d / n)[1].tolist() for n in ("ts.nc", "ex.nc"))
    assert counts["torch"] == counts["jax"]
    assert tuple(map(len, counts["torch"])) == (11, 3)


def test_medium_classic_output(tmp_path):
    """``-o_format netcdf3 -o_size medium``: the JAX package writes the
    state file and then reopens it with h5py to append the diagnostics,
    which a classic file refuses; the port writes the state and the
    diagnostics in one pass, the same variables the JAX package writes in
    NetCDF-4."""
    argv = ["-eisII", "A", "-Mx", "11", "-Mz", "5", "-y", "10", "-verbose",
            "0", "-o_size", "medium"]
    with pytest.raises(OSError):
        j_cli.main(argv + ["-o", str(tmp_path / "j3.nc"),
                           "-o_format", "netcdf3"])
    assert j_cli.main(argv + ["-o", str(tmp_path / "j4.nc")]) == 0
    assert t_cli.main(argv + ["-o", str(tmp_path / "t3.nc"), "-o_format",
                              "netcdf3", "-platform", "cpu"]) == 0
    _compare_files(tmp_path / "t3.nc", tmp_path / "j4.nc", 1e-8)


def test_cli_eismint_restart(tmp_path):
    """``-eisII A -i``: an experiment continues from a saved state
    (``tests/test_cli.py::test_cli_eismint_restart_and_outputs``)."""
    a, a2 = tmp_path / "a.nc", tmp_path / "a2.nc"
    assert t_cli.main(["-eisII", "A", "-Mx", "21", "-Mz", "11", "-y", "50",
                       "-o", str(a), "-max_dt", "5", "-verbose", "1",
                       "-platform", "cpu", "-o_format", "netcdf3"]) == 0
    assert t_cli.main(["-eisII", "A", "-i", str(a), "-y", "25", "-o", str(a2),
                       "-verbose", "1", "-platform", "cpu"]) == 0
    s1, t1 = t_ckpt.load_state(str(a), device="cpu")
    s2, t2 = t_ckpt.load_state(str(a2), device="cpu")
    assert t2 == pytest.approx(t1 + 25 * SPY, rel=1e-9)
    assert float(s2.geometry.ice_thickness.max()) \
        >= float(s1.geometry.ice_thickness.max())


def test_eismint_float32_field_dtype(tmp_path):
    """``-config runtime.float_dtype=float32`` on the EISMINT II route: the
    JAX CLI builds the state before it reads ``-config`` and never casts it,
    so its fields stay float64 (its model's other arrays are float32); the
    port casts the state to the configured dtype, so every field it writes
    is float32, and its own load_state reads them back to the bit."""
    dtypes = {}
    for pkg, main, extra in (("jax", j_cli.main, []),
                             ("torch", t_cli.main, ["-platform", "cpu"])):
        path = tmp_path / f"{pkg}.nc"
        assert main(["-eisII", "A", "-Mx", "11", "-Mz", "5", "-y", "10",
                     "-o", str(path), "-o_format", "netcdf3", "-verbose",
                     "0", "-config", "runtime.float_dtype=float32"]
                    + extra) == 0
        with File(str(path), "r") as f:
            dtypes[pkg] = {v: f.read(v).dtype.str for v in f.variables()}
    assert sorted(dtypes["jax"]) == sorted(dtypes["torch"])
    for name, dt in dtypes["torch"].items():
        want = "<i4" if name == "mask" else "<f4"
        assert dt == want, name
        assert dtypes["jax"][name] == ("<i4" if name == "mask" else "<f8")
    state, _ = t_ckpt.load_state(str(tmp_path / "torch.nc"), device="cpu")
    with File(str(tmp_path / "torch.nc"), "r") as f:
        np.testing.assert_array_equal(state.enthalpy.numpy(),
                                      f.read("enthalpy")[-1])
        assert state.enthalpy.dtype == torch.float32


@pytest.mark.parametrize("spec,start,end", [
    ("0:10:30", None, None), ("5,7", None, None), ("0:2.5:10", None, None),
    ("yearly", 0.5, 3.0), ("monthly", 0.0, 0.25), ("1:monthly:2", None, None),
])
def test_parse_times_matches(spec, start, end):
    assert t_cli.parse_times(spec, SPY, start, end) \
        == j_cli.parse_times(spec, SPY, start, end)


def test_parser_matches():
    """Every option of the JAX CLI parses, with the same defaults."""
    def opts(p):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs)
                for a in p._actions if a.dest != "help"}
    assert opts(t_cli.build_parser()) == opts(j_cli.build_parser())
    assert t_cli._PARAM_SHORTHANDS == j_cli._PARAM_SHORTHANDS
    argv = ["-stress_balance", "ssa+sia", "-energy", "none", "-hydrology",
            "routing", "-calving", "float_kill", "-bed_def", "iso",
            "-skip_max", "7", "-sia_e", "3", "-plastic_phi", "20",
            "-ssa_method", "fd", "-pik", "-max_dt", "2",
            "-config", "a.b=1", "-config", "c.d=x"]
    assert vars(t_cli.build_parser().parse_args(argv)) \
        == vars(j_cli.build_parser().parse_args(argv))


def test_shorthands_set_the_config(tmp_path):
    """The shorthands and the output options land in the stored config as
    in the JAX package (``pism_tpu/cli.py:559-628``, ``:872-881``)."""
    argv = ["-test", "B", "-Mx", "11", "-y", "10", "-sia_e", "1.5",
            "-max_dt", "2", "-skip_max", "3", "-o_format", "netcdf3",
            "-verbose", "0", "-config", "stress_balance.sia.Glen_exponent=3.0"]
    cfgs = {}
    for pkg, main, extra in (("jax", j_cli.main, []),
                             ("torch", t_cli.main, ["-platform", "cpu"])):
        path = tmp_path / f"{pkg}.nc"
        assert main(argv + ["-o", str(path)] + extra) == 0
        nd = t_ckpt.load_config(str(path)).non_default()
        nd.pop("output.file")
        nd.pop("run_info.command", None)
        nd.pop("runtime.platform", None)
        cfgs[pkg] = nd
    assert cfgs["torch"] == cfgs["jax"]
    assert cfgs["torch"]["stress_balance.sia.enhancement_factor"] == 1.5
    assert cfgs["torch"]["time_stepping.skip.max"] == 3


@pytest.mark.parametrize("argv", [
    ["-bootstrap", "-i", "x.nc"], ["-regrid_file", "x.nc"], ["-regional"],
    ["-no_model_strip", "30"], ["-atmosphere", "uniform"],
    ["-surface", "pdd"], ["-ocean", "pik"], ["-sea_level", "constant"],
    ["-inverse"], ["-view", "thk"], ["-list_params"], ["-list_diagnostics"],
    ["-test", "E"], ["-test", "F"], ["-test", "G"], ["-test", "I"],
    ["-test", "J"], ["-test", "K"], ["-test", "M"], ["-test", "N"],
    ["-test", "O"], ["-test", "P"], ["-test", "V"],
    ["-test", "B", "-Mx", "11", "-config", "grid.Nx=2",
     "-config", "grid.Ny=2"],
    ["-test", "B", "-Mx", "11", "-o_size", "big"],
    ["-test", "B", "-Mx", "11", "-extra_file", "e.nc", "-extra_times", "1",
     "-extra_vars", "temppa"],
    ["-eisII", "E"],
])
def test_unported_options_raise(tmp_path, argv):
    with pytest.raises(NotImplementedError):
        t_cli.main(argv + ["-platform", "cpu", "-y", "1", "-verbose", "0",
                           "-o", str(tmp_path / "o.nc"),
                           "-o_format", "netcdf3"])


def test_cli_defaults_to_the_card(tmp_path):
    """Without ``-platform cpu`` the fields go to the card; without one the
    CLI raises instead of running on the CPU."""
    argv = ["-test", "B", "-Mx", "11", "-y", "1", "-verbose", "0",
            "-o", str(tmp_path / "b.nc"), "-o_format", "netcdf3"]
    if torch.cuda.is_available():
        assert t_cli.main(argv) == 0
    else:
        with pytest.raises(RuntimeError, match="-platform cpu"):
            t_cli.main(argv)
        assert not (tmp_path / "b.nc").exists()


_AUDIT = """
import os, sys
root, out = sys.argv[1], sys.argv[2]
jax_pkg = os.path.join(root, "pism_tpu") + os.sep
opened = []

def hook(event, args):
    if event == "open" and isinstance(args[0], (str, bytes)):
        opened.append(os.path.abspath(os.fsdecode(args[0])))

sys.addaudithook(hook)
sys.argv = ["pism_tpu_torch"]
import runpy
sys.argv += ["-test", "B", "-Mx", "11", "-y", "20", "-platform", "cpu",
             "-o", out + "/b.nc", "-o_format", "netcdf3", "-verbose", "0",
             "-ts_file", out + "/ts.nc", "-ts_times", "425:5:440",
             "-extra_file", out + "/ex.nc", "-extra_times", "430",
             "-o_size", "medium"]
try:
    runpy.run_module("pism_tpu_torch", run_name="__main__")
except SystemExit as e:
    assert e.code == 0, e.code
bad = sorted(p for p in opened if p.startswith(jax_pkg))
assert not bad, bad
mods = sorted(m for m in sys.modules
              if m.split(".")[0] in ("jax", "pism_tpu", "h5py"))
assert not mods, mods
new = ("cli", "io.nc4", "io.checkpoint", "model.output",
       "model.diagnostics", "util.logger", "util.signals")
assert all("pism_tpu_torch." + m in sys.modules for m in new)
print("clean", len([p for p in opened if p.startswith(out)]))
"""


def test_cli_module_entry_reads_nothing_of_the_jax_package(tmp_path):
    """``python -m pism_tpu_torch`` (run as a module in a fresh
    interpreter under an audit hook on ``open``) writes its classic files
    without reading any file under ``pism_tpu/`` and without importing
    jax, pism_tpu or h5py."""
    out = subprocess.run([sys.executable, "-c", _AUDIT, str(ROOT),
                          str(tmp_path)], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1].startswith("clean"), out.stdout
    for name in ("b.nc", "ts.nc", "ex.nc"):
        with open(tmp_path / name, "rb") as fh:
            assert fh.read(3) == b"CDF"
