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


#: options that the port refused before it carried the whole coupler: each
#: now does in the port what it does in the JAX package
COUPLER_ARGV = [
    ["-test", "B", "-Mx", "11", "-atmosphere", "yearly_cycle"],
    ["-test", "B", "-Mx", "11", "-sea_level", "constant",
     "-config", "ocean.delta_sl_2d.file=x.nc"],
    ["-test", "B", "-Mx", "11", "-atmosphere", "uniform,anomaly"],
    ["-test", "B", "-Mx", "11", "-surface", "pdd,cache"],
    ["-test", "B", "-Mx", "11", "-ocean", "th"],
    ["-test", "B", "-Mx", "11", "-sea_level", "constant,delta_sl_2d"],
    ["-test", "B", "-Mx", "11", "-surface", "elevation"],
]


@pytest.mark.parametrize("argv", COUPLER_ARGV)
def test_coupler_options_behave_as_jax(tmp_path, argv):
    """The same outcome through both command lines: the same exception
    where an input is missing, else the same steps and dt-limit hits."""
    import contextlib
    import io

    res = {}
    for pkg, main, fmt, extra in (
            ("jax", j_cli.main, "netcdf4", []),
            ("torch", t_cli.main, "netcdf3", ["-platform", "cpu"])):
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                main(argv + extra + [
                    "-y", "1", "-o", str(tmp_path / f"{pkg}.nc"),
                    "-o_format", fmt, "-config",
                    "time_stepping.count_time_steps=true"])
        except (ValueError, OSError) as e:
            res[pkg] = type(e).__name__
            continue
        m = re.search(r"count_time_steps: (\d+) adaptive steps", buf.getvalue())
        res[pkg] = int(m.group(1))
    assert res["torch"] == res["jax"], res


@pytest.mark.parametrize("argv", [
    ["-regional"],
    ["-no_model_strip", "30"],
    ["-i", "{dome}", "-stress_balance", "ssa+sia", "-inverse", "-inv_data",
     "{obs}", "-config", "runtime.float_dtype=float32"],
    ["-view", "thk"], ["-list_params"], ["-list_diagnostics"],
    ["-test", "B", "-Mx", "11", "-energy", "cold"],
    ["-test", "J", "-config", "stress_balance.ssa.fd.preconditioner=linemg"],
    ["-test", "M", "-config", "stress_balance.ssa.fd.krylov_method=cg"],
    ["-test", "N", "-config", "stress_balance.ssa.fd.preconditioner=linemg"],
    ["-test", "V", "-config", "stress_balance.ssa.fd.line_block=64"],
    ["-test", "B", "-Mx", "11", "-config", "grid.Nx=2",
     "-config", "grid.Ny=2"],
    ["-test", "B", "-Mx", "11", "-o_size", "big"],
    ["-test", "B", "-Mx", "11", "-extra_file", "e.nc", "-extra_times", "1",
     "-extra_vars", "temppa"],
    ["-test", "B", "-Mx", "11", "-bed_def", "given"],
])
def test_unported_options_raise(tmp_path, argv):
    if "-inverse" in argv:   # the inversion of float32 fields
        dome, obs = inverse_inputs(tmp_path)
        argv = [a.format(dome=dome, obs=obs) for a in argv]
    with pytest.raises(NotImplementedError):
        t_cli.main(argv + ["-platform", "cpu", "-y", "1", "-verbose", "0",
                           "-o", str(tmp_path / "o.nc"),
                           "-o_format", "netcdf3"])


def inverse_inputs(d):
    """(state file, observations file) of a small inversion: EISMINT II
    A's 11x11x5 setup with a 1000 m parabolic dome, saved by the port (its
    config and enthalpy), and observed velocities of 20 m/a pointing away
    from the centre over the ice, NaN (no data) outside it."""
    import torch
    from pism_tpu_torch.state import new_geometry
    from pism_tpu_torch.verification import eismint2
    es = eismint2.setup("A", Mx=11, Mz=5, device="cpu")
    grid = es.grid
    X, Y = np.meshgrid(grid.x, grid.y)
    R = np.sqrt(X ** 2 + Y ** 2) / 600e3
    H = np.where(R < 1, 1000.0 * np.sqrt(np.clip(1 - R ** 2, 0, 1)), 0.0)
    state = es.state.replace(geometry=new_geometry(
        torch.tensor(H), es.state.geometry.bed_elevation))
    dome, obs = str(d / "dome.nc"), str(d / "obs.nc")
    t_ckpt.save_state(dome, state, grid, 0.0, config=es.config,
                      format="netcdf3")
    u = np.where(H > 10.0, 20.0 / SPY * X / 600e3, np.nan)
    v = np.where(H > 10.0, 20.0 / SPY * Y / 600e3, np.nan)
    with File(obs, "w", format="netcdf3") as f:
        for name, c in (("x", grid.x), ("y", grid.y)):
            f.define_dimension(name, len(c), values=np.asarray(c),
                               attrs={"units": "m"})
        f.write("u_ssa", u, dims=("y", "x"), attrs={"units": "m s-1"})
        f.write("v_ssa", v, dims=("y", "x"), attrs={"units": "m s-1"})
    return dome, obs


#: the inversion's command line: pseudo-plastic till at 30 kPa (off the
#: plastic dead zone), the exact drag Jacobian (few Newton sweeps), a light
#: L2 weight and no Morozov stop, two L-BFGS iterates
INVERSE_ARGV = ["-stress_balance", "ssa+sia", "-inverse", "-pseudo_plastic",
                "-config", "basal_yield_stress.model=constant",
                "-config", "basal_yield_stress.constant.value=3e4",
                "-config", "stress_balance.ssa.fd.drag_jacobian=exact",
                "-config", "inverse.design.cL2=1e-4",
                "-config", "inverse.target_misfit=0",
                "-config", "inverse.max_iterations=2", "-verbose", "1"]


def test_cli_inverse_matches_jax(tmp_path):
    """``-inverse`` (tau_c, bounded L-BFGS) through both packages' ``main``
    on the same files: the port writes ``tauc`` and ``inv_misfit`` in one
    pass in both formats, and they agree with the JAX package's within
    1e-4 (the gradient tests' bound in ``tests/test_torch_inverse.py``).
    The JAX package writes them by reopening its state file "r+", which
    only a NetCDF-4 file takes, so its run is NetCDF-4."""
    dome, obs = inverse_inputs(tmp_path)
    argv = ["-i", dome, "-inv_data", obs] + INVERSE_ARGV
    ref = tmp_path / "jax.nc"
    assert j_cli.main(argv + ["-o", str(ref)]) == 0
    with File(str(ref), "r") as f:
        want = {v: np.asarray(f.read(v)) for v in ("tauc", "inv_misfit")}
    assert want["inv_misfit"].shape == (3,)
    assert want["inv_misfit"][-1] < want["inv_misfit"][0]
    for fmt in ("netcdf3", "netcdf4"):
        out = tmp_path / f"port_{fmt}.nc"
        assert t_cli.main(argv + ["-o", str(out), "-o_format", fmt,
                                  "-platform", "cpu"]) == 0
        with File(str(out), "r") as f:
            assert f.has_variable("thk") and f.has_variable("u_ssa")
            for v, x in want.items():
                got = np.asarray(f.read(v))
                assert got.shape == x.shape, v
                np.testing.assert_allclose(got, x, rtol=0,
                                           atol=1e-4 * np.abs(x).max())


SLIDING = [["-eisII", "G", "-Mx", "21", "-Mz", "11", "-y", "300"],
           ["-eisII", "L", "-Mx", "21", "-Mz", "11", "-y", "300"],
           ["-eisII", "E", "-i", "{a}", "-y", "30"]]


@pytest.mark.parametrize("argv", SLIDING, ids=["G", "L", "E-restart"])
def test_cli_sliding_experiments_match(tmp_path, capsys, argv):
    """EISMINT II G (Weertman sliding from zero ice), L (the mound bed with
    sliding, the bed smoother on) and E restarted from an A state (the
    sector's sliding map passed to the model), through both packages'
    ``main``: equal steps and dt-limit hits, state files within 1e-8 of
    max (as the A route), the sliding velocity carried as u_ssa/v_ssa."""
    a = tmp_path / "a.nc"
    if "{a}" in argv:
        assert t_cli.main(["-eisII", "A", "-Mx", "21", "-Mz", "11", "-y",
                           "100", "-o", str(a), "-o_format", "netcdf3",
                           "-verbose", "0", "-platform", "cpu"]) == 0
    capsys.readouterr()
    out = {}
    for pkg, main, extra in (("jax", j_cli.main, []),
                             ("torch", t_cli.main, ["-platform", "cpu"])):
        path = tmp_path / f"{pkg}.nc"
        assert main([x.format(a=a) for x in argv]
                    + ["-o", str(path), "-o_format", "netcdf3", "-verbose",
                       "1", "-config", "time_stepping.count_time_steps=true"]
                    + extra) == 0
        out[pkg] = (path, _count(capsys))
    assert out["torch"][1] == out["jax"][1]
    _compare_files(out["torch"][0], out["jax"][0], 1e-8)
    with File(str(out["torch"][0]), "r") as f:
        assert np.abs(f.read("u_ssa")).max() > 0.0


@pytest.mark.parametrize("argv", [["-test", "E", "-Mx", "21", "-y", "100"],
                                  ["-test", "G", "-Mx", "21", "-Mz", "11",
                                   "-y", "100"],
                                  ["-test", "K", "-Mz", "11"],
                                  ["-test", "O", "-Mz", "11"]],
                         ids=["E", "G", "K", "O"])
def test_cli_verification_letters_match(capsys, monkeypatch, argv):
    """``-test E, G, K, O`` through both packages' ``main``: the report
    lines equal but for the digits, the numbers within 1e-6 relative (or
    1e-9 absolute, for errors at rounding level). The JAX package's K
    loop runs its BTU step under ``jax.jit`` (one compile; eager, each of
    its 200 calls takes ~0.3 s on the CPU)."""
    if argv[1] == "K":
        import jax
        from pism_tpu.model.btu import BTUFull
        real = BTUFull.step
        jitted = {}

        def step(self, *a):
            if id(self) not in jitted:
                jitted[id(self)] = (self, jax.jit(lambda *x: real(self, *x)))
            return jitted[id(self)][1](*a)
        monkeypatch.setattr(BTUFull, "step", step)
    capsys.readouterr()
    text = {}
    for pkg, main, extra in (("jax", j_cli.main, []),
                             ("torch", t_cli.main, ["-platform", "cpu"])):
        assert main(argv + extra) == 0
        text[pkg] = capsys.readouterr().out.strip().splitlines()
    num = re.compile(r"[-+]?\d+\.\d+")
    lines = [(a, b) for a, b in zip(text["jax"], text["torch"])]
    assert len(text["jax"]) == len(text["torch"]) >= 4
    assert text["torch"][0].startswith(f"NUMERICAL ERRORS in test {argv[1]} ")
    for a, b in lines:
        assert num.sub("#", b) == num.sub("#", a)
        for x, y in zip(num.findall(a), num.findall(b)):
            assert float(y) == pytest.approx(float(x), rel=1e-6, abs=1e-9)


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



# -- the std-greenland workflow through both command lines ----------------

def _untie(src, dst):
    """``src``'s state with the enthalpies that sit exactly at the
    pressure-melting value moved 1 J/kg below it, written to ``dst``
    (the JAX package decides those ties at random under ``jit``;
    tests/test_torch_hybrid_chain.py); returns how many moved."""
    from pism_tpu_torch.physics.enthalpy_converter import EnthalpyConverter
    cfg = t_ckpt.load_config(src)
    st, t = t_ckpt.load_state(src, device="cpu")
    grid = t_ckpt.load_grid(src)
    EC = EnthalpyConverter.from_config(cfg)
    depth = torch.clamp(st.geometry.ice_thickness[..., None]
                        - torch.as_tensor(grid.z), min=0.0)
    Es = EC.enthalpy_cts(EC.pressure(depth))
    tie = (st.enthalpy - Es).abs() <= 1e-9 * Es.abs()
    st = st.replace(enthalpy=torch.where(tie, st.enthalpy - 1.0, st.enthalpy))
    t_ckpt.save_state(dst, st, grid, t, config=cfg, format="netcdf3")
    return int(tie.sum())


def _both_clis(argv_of):
    """``argv_of(pkg, fmt)`` through both packages' main (the JAX package
    writing NetCDF-4, the port classic files): {pkg: (steps, hits)}."""
    import contextlib
    import io

    out = {}
    for pkg, main, fmt, extra in (
            ("jax", j_cli.main, "netcdf4", []),
            ("torch", t_cli.main, "netcdf3", ["-platform", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv_of(pkg, fmt) + extra + [
                "-config", "time_stepping.count_time_steps=true"]) == 0
        m = re.search(r"count_time_steps: (\d+) adaptive steps \(binding "
                      r"limits: (\{.*\})\)", buf.getvalue())
        out[pkg] = (int(m.group(1)), eval(m.group(2))) if m else (0, {})
    return out


@pytest.fixture(scope="module")
def workflow(tmp_path_factory):
    """The std-greenland workflow at 100 km (16 x 29 x 41, float64) through
    both command lines: the bootstrap (zero length), stage 1 (SIA, 2 a),
    stage 2 (no mass, 2 a) and stage 3 (hybrid, 2 a; and its first 0.5 a
    alone). Each package continues from its own file, except where the
    enthalpy ties are moved off (after the bootstrap and before stage 3):
    both continue from the port's untied file there."""
    from pism_tpu_torch.examples.std_greenland_workflow import (
        stage_argv, synthesize_bootstrap_file)

    d = tmp_path_factory.mktemp("std_greenland")
    boot = str(d / "g_boot.nc")
    synthesize_bootstrap_file(boot, 100.0, "netcdf4")
    f = {(p, k): str(d / f"{p}_{k}.nc") for p in ("jax", "torch")
         for k in ("b0", "pre", "nomass", "spun", "s3a")}

    def argv(p, fmt, stage, src=None, out=None, y=None):
        files = (f[p, "pre"], f[p, "nomass"], f[p, "spun"])
        a = stage_argv(boot, files, 100.0, (2.0, 2.0, 2.0), fmt,
                       dtype="float64")[stage]
        for flag, val in (("-i", src), ("-o", out), ("-y", y)):
            if val is not None:
                a[a.index(flag) + 1] = str(val)
        return a

    def stage1(p, fmt):
        a = argv(p, fmt, 0)
        return ["-i", str(d / "tie0.nc")] + a[a.index("-stress_balance"):]

    res = {"files": f, "boot": boot, "dir": d}
    res["b0"] = _both_clis(lambda p, fmt: argv(p, fmt, 0, out=f[p, "b0"],
                                               y=0))
    res["ties0"] = _untie(f["torch", "b0"], str(d / "tie0.nc"))
    res["pre"] = _both_clis(stage1)
    res["nomass"] = _both_clis(lambda p, fmt: argv(p, fmt, 1))
    res["ties2"] = _untie(f["torch", "nomass"], str(d / "tie2.nc"))
    res["s3a"] = _both_clis(lambda p, fmt: argv(
        p, fmt, 2, src=d / "tie2.nc", out=f[p, "s3a"], y=0.5))
    res["spun"] = _both_clis(lambda p, fmt: argv(p, fmt, 2,
                                                 src=d / "tie2.nc"))
    return res


def _cmp(a, b, names, tol_of_max):
    """The port's nccmp on ``names``, each within ``tol_of_max`` of its
    max |value| in ``b``."""
    from pism_tpu_torch.util import nccmp
    bad = []
    for name in names:
        with File(b, "r") as fb:
            scale = float(np.abs(np.asarray(fb.read(name), float)).max())
        bad += nccmp.compare(a, b, [name], atol=tol_of_max * scale)
    return [str(m) for m in bad]


def test_workflow_bootstrap_matches(workflow):
    """The bootstrap through both command lines: the same variables, every
    field within 1e-12 of its max."""
    f = workflow["files"]
    a, b = f["torch", "b0"], f["jax", "b0"]
    with File(a, "r") as fa, File(b, "r") as fb:
        names = sorted(set(fa.variables()))
        assert names == sorted(set(fb.variables()))
    names = [n for n in names if n not in ("time", "mask")]
    assert _cmp(a, b, names, 1e-12) == []
    assert workflow["b0"]["torch"] == workflow["b0"]["jax"]
    assert workflow["ties0"] > 0


@pytest.mark.parametrize("stage", ["pre", "nomass"])
def test_workflow_sia_stages_match(workflow, stage):
    """Stages 1 and 2: equal steps and dt-limit hits, H within 1e-9 of
    max|H|, E within 1e-9 relative, the PDD's snow within 1e-9."""
    f = workflow["files"]
    steps = workflow[stage]
    assert steps["torch"] == steps["jax"] and steps["torch"][0] > 0
    a, b = f["torch", stage], f["jax", stage]
    assert _cmp(a, b, ["thk", "usurf", "enthalpy", "snow_depth",
                       "firn_depth"], 1e-9) == []


def test_workflow_no_mass_stage_keeps_thickness(workflow):
    f = workflow["files"]
    with File(f["torch", "pre"], "r") as fa, \
            File(f["torch", "nomass"], "r") as fb:
        np.testing.assert_array_equal(fa.read("thk")[-1], fb.read("thk")[-1])
        assert fb.read("time")[-1] - fa.read("time")[-1] == \
            pytest.approx(2.0 * SPY)


def test_workflow_hybrid_stage_matches(workflow):
    """Stage 3's first 0.5 a (one step: the cold SSA solve) at the hybrid
    chain's tolerances (tests/test_torch_hybrid_chain.py). Its SSA solves
    do not converge in either package (at this 100 km state the Newton
    loop stagnates at |F|^2 ~ 1e7 tolerance, 42 sweeps, in both), so from
    the second step on the two runs part as rounding decides; over the
    stage's 2 a they are held to equal steps and dt-limit hits and the
    ice volume within 1e-3, and the workflow's own check."""
    from pism_tpu_torch.examples.std_greenland_workflow import volume_of
    f = workflow["files"]
    assert workflow["s3a"]["torch"] == workflow["s3a"]["jax"]
    a, b = f["torch", "s3a"], f["jax", "s3a"]
    assert _cmp(a, b, ["thk", "usurf", "enthalpy", "Href"], 5e-7) == []
    assert _cmp(a, b, ["u_ssa", "v_ssa"], 5e-2) == []
    assert workflow["spun"]["torch"] == workflow["spun"]["jax"]
    (vj, _), (vt, thk) = volume_of(f["jax", "spun"]), \
        volume_of(f["torch", "spun"])
    assert abs(vt - vj) <= 1e-3 * vj
    v1 = volume_of(f["torch", "pre"])[0]
    v2 = volume_of(f["torch", "nomass"])[0]
    assert np.isfinite(thk).all() and vt > 0.2 * v1 and abs(v2 - v1) < 0.02 * v1


def test_regrid_file_matches(workflow, tmp_path):
    """``-regrid_file``/``-regrid_vars`` over a restart: the named 2D
    fields replaced where the file has data (NaN keeps the restored
    value; points outside its extent take its edge values), a name that is
    no 2D state variable skipped; both packages alike."""
    f = workflow["files"]
    src = str(tmp_path / "regrid.nc")
    with File(workflow["boot"], "r") as fb:
        x, y = fb.read("x"), fb.read("y")
        thk = 0.9 * np.asarray(fb.read("thk"))
    thk[10:14, 5:9] = np.nan
    sel = slice(2, -2)
    with File(src, "w") as fo:
        fo.define_dimension("y", y[sel].size, y[sel])
        fo.define_dimension("x", x[sel].size, x[sel])
        fo.write("thk", thk[sel, sel], ("y", "x"), {"units": "m"})
        fo.write("bmelt", np.full(thk[sel, sel].shape, 1e-9), ("y", "x"),
                 {"units": "m s-1"})
        fo.write("lat", np.zeros(thk[sel, sel].shape), ("y", "x"), {})
    outs = {}

    def argv(p, fmt):
        outs[p] = str(tmp_path / f"{p}.nc")
        return ["-i", f[p, "pre"], "-y", "0", "-o", outs[p], "-o_format", fmt,
                "-regrid_file", src, "-regrid_vars", "thk,bmelt,lat",
                "-verbose", "1"]

    _both_clis(argv)
    assert _cmp(outs["torch"], outs["jax"], ["thk", "bmelt", "usurf"],
                1e-12) == []
    with File(outs["torch"], "r") as fo, File(f["torch", "pre"], "r") as fi:
        new, old = fo.read("thk")[-1], fi.read("thk")[-1]
        assert not np.array_equal(new, old)
        np.testing.assert_array_equal(fo.read("bmelt")[-1], 1e-9)
        cfg = t_ckpt.load_config(outs["torch"])
        assert cfg.get_string("input.regrid.file") == src


def test_stored_chains_are_rebuilt_on_restart(workflow, tmp_path):
    """A plain ``-i`` restart rebuilds the coupler chains stored in the
    file's config (searise_greenland + pdd, with the data file named
    there): equal to the bit to the run that names them, and to the JAX
    package's restart within 1e-9."""
    f = workflow["files"]
    outs = {}

    def argv(p, fmt, name="plain"):
        outs[p, name] = str(tmp_path / f"{p}_{name}.nc")
        return ["-i", f["torch", "pre"], "-y", "0.5", "-o", outs[p, name],
                "-o_format", fmt, "-verbose", "1"]

    _both_clis(argv)
    cfg = t_ckpt.load_config(f["torch", "pre"]).non_default()
    assert cfg["atmosphere.models"] == "searise_greenland"
    assert cfg["surface.models"] == "pdd"
    flags = ["-atmosphere", "searise_greenland", "-surface", "pdd"]
    assert t_cli.main(argv("torch", "netcdf3", "flags") + flags
                      + ["-platform", "cpu"]) == 0
    from pism_tpu_torch.util import nccmp
    names = ["thk", "enthalpy", "snow_depth", "firn_depth"]
    assert nccmp.compare(outs["torch", "plain"], outs["torch", "flags"],
                         names) == []
    assert _cmp(outs["torch", "plain"], outs["jax", "plain"], names,
                1e-9) == []


PROJ = "+proj=stere +lat_0=90 +lat_ts=71 +lon_0=-39 +k=1 +x_0=0 +y_0=0"


@pytest.mark.parametrize("fmt", ["netcdf3", "netcdf4"])
def test_bootstrap_outputs_carry_the_projection(tmp_path, fmt):
    """A data file with a ``proj`` attribute: the run adopts it, and its
    state file and spatial series carry ``proj``, lat/lon and their cell
    bounds from ``util/projection.py`` in either format; the JAX package's
    NetCDF-4 state file holds the same."""
    from pism_tpu_torch.examples.std_greenland_workflow import (
        stage_argv, synthesize_bootstrap_file)
    from pism_tpu_torch.util import nccmp
    from pism_tpu_torch.util import projection as prj

    boot = str(tmp_path / "boot.nc")
    synthesize_bootstrap_file(boot, 100.0, fmt, proj=PROJ)
    out, ex = str(tmp_path / "o.nc"), str(tmp_path / "ex.nc")
    a = stage_argv(boot, (out, "", ""), 100.0, (1.0, 0, 0), fmt,
                   Mz=11, dtype="float64")[0]
    assert t_cli.main(a + ["-platform", "cpu", "-extra_file", ex,
                           "-extra_times", "1"]) == 0
    grid = t_ckpt.load_grid(out)
    lon, lat = prj.lonlat_for_grid(grid, prj.from_proj_string(PROJ))
    lon_b, lat_b = prj.lonlat_bounds_for_grid(grid, prj.from_proj_string(PROJ))
    for path in (out, ex):
        with File(path, "r") as fo:
            assert fo.get_global_attr("proj") == PROJ
            np.testing.assert_array_equal(fo.read("lat"), lat)
            np.testing.assert_array_equal(fo.read("lon"), lon)
            np.testing.assert_array_equal(fo.read("lat_bnds"), lat_b)
            np.testing.assert_array_equal(fo.read("lon_bnds"), lon_b)
    jout = str(tmp_path / "j.nc")
    ja = stage_argv(boot, (jout, "", ""), 100.0, (0, 0, 0), "netcdf4",
                    Mz=11, dtype="float64")[0]
    assert j_cli.main(ja) == 0
    assert nccmp.compare(out, jout, ["lat", "lon", "lat_bnds", "lon_bnds"],
                         atol=1e-12) == []


def test_ssa_dirichlet_bc_from_the_input_file(workflow, tmp_path):
    """``stress_balance.ssa.dirichlet_bc`` reads ``bc_mask``, ``u_bc`` and
    ``v_bc`` (m/year) from ``-i``: the solved velocity equals the BC on the
    mask to the bit, and one hybrid step agrees with the JAX package's at
    the hybrid chain's tolerances."""
    f = workflow["files"]
    src = str(workflow["dir"] / "tie2.nc")
    st, t = t_ckpt.load_state(src, device="cpu")
    grid = t_ckpt.load_grid(src)
    cfg = t_ckpt.load_config(src)
    H = st.geometry.ice_thickness.numpy()
    mask = np.zeros(H.shape)
    mask[8:20, 7] = 1.0
    mask[H < 100.0] = 0.0
    u_bc = np.where(mask > 0, 120.0, 0.0)
    v_bc = np.where(mask > 0, -35.0, 0.0)
    inp = str(tmp_path / "bc.nc")
    t_ckpt.save_state(inp, st, grid, t, config=cfg, format="netcdf4",
                      extra_2d={"bc_mask": (mask, {}),
                                "u_bc": (u_bc, {"units": "m year-1"}),
                                "v_bc": (v_bc, {"units": "m year-1"})})
    outs = {}

    def argv(p, fmt):
        outs[p] = str(tmp_path / f"{p}.nc")
        return ["-i", inp, "-y", "0.5", "-o", outs[p], "-o_format", fmt,
                "-stress_balance", "ssa+sia", "-pseudo_plastic",
                "-pseudo_plastic_q", "0.25", "-skip", "-skip_max", "10",
                "-config", "geometry.update.enabled=true",
                "-config", "stress_balance.ssa.dirichlet_bc=true",
                "-verbose", "1"]

    steps = _both_clis(argv)
    assert steps["torch"] == steps["jax"]
    with File(outs["torch"], "r") as fo:
        u, v = fo.read("u_ssa")[-1], fo.read("v_ssa")[-1]
    on = mask > 0
    assert on.sum() >= 5
    np.testing.assert_array_equal(u[on], (u_bc / SPY)[on])
    np.testing.assert_array_equal(v[on], (v_bc / SPY)[on])
    assert _cmp(outs["torch"], outs["jax"], ["thk", "enthalpy"], 5e-7) == []
    assert _cmp(outs["torch"], outs["jax"], ["u_ssa", "v_ssa"], 5e-2) == []


def test_bootstrap_takes_searise_inputs_from_the_input_file(tmp_path):
    """``-atmosphere searise_greenland`` with no forcing file named: lat,
    lon and precipitation come from ``-i`` (the acceptance command's form,
    on the default 1500 km half-widths, so the file's edges are clamped);
    one step through both command lines gives the same PDD snow (which
    the atmosphere's inputs drive) within 1e-9 of max, and the same
    thickness wherever the basal melt agrees: the bootstrap's enthalpy
    ties at the melting point, which the JAX package decides at random,
    set the basal melt of the first energy step, which the mass transport
    uses (1e-2 m in 0.01 a where they differ)."""
    from pism_tpu_torch.examples.std_greenland_workflow import (
        synthesize_bootstrap_file)

    boot = str(tmp_path / "boot.nc")
    synthesize_bootstrap_file(boot, 100.0, "netcdf4")
    outs = {}

    def argv(p, fmt):
        outs[p] = str(tmp_path / f"{p}.nc")
        return ["-i", boot, "-bootstrap", "-Mx", "16", "-My", "29", "-Mz",
                "11", "-Lz", "4000", "-stress_balance", "sia",
                "-atmosphere", "searise_greenland", "-surface", "pdd",
                "-y", "0.01", "-o", outs[p], "-o_format", fmt,
                "-config", "runtime.float_dtype=float64", "-verbose", "1"]

    steps = _both_clis(argv)
    assert steps["torch"] == steps["jax"] and steps["torch"][0] > 0
    assert _cmp(outs["torch"], outs["jax"], ["snow_depth", "topg"],
                1e-9) == []
    with File(outs["torch"], "r") as ft, File(outs["jax"], "r") as fj:
        same = np.abs(ft.read("bmelt") - fj.read("bmelt")) <= 1e-20
        Ht, Hj = ft.read("thk"), fj.read("thk")
    assert same.mean() > 0.8
    assert np.abs(Ht - Hj)[same].max() <= 1e-9 * np.abs(Hj).max()


# -- the PISM-PIK Antarctic chain through the command line ------------------

@pytest.fixture(scope="module")
def pik(tmp_path_factory):
    """The PIK chain's command line (``examples/antarctica_pik.py``'s
    ``bootstrap_argv``: -bootstrap -pik -atmosphere pik -surface pik -ocean
    pico -calving eigen_calving,thickness_calving -bed_def lc) on the
    synthetic Antarctic data file at 200 km (21 x 21 x 11, float64; the
    Lingle-Clark update every year instead of every 10 a): the
    bootstrap (zero length) through both command lines, then 2 a of both
    from the port's untied file; the port's run continued by a plain -i
    restart for 1 a. ``IceModel.run`` is recorded, so the port's runs can
    be continued in memory."""
    from pism_tpu_torch.examples.antarctica_pik import (
        bootstrap_argv, synthesize_data_file)
    from pism_tpu_torch.model.icemodel import IceModel

    d = tmp_path_factory.mktemp("antarctica_pik")
    data = str(d / "ant.nc")
    synthesize_data_file(data, 200.0, "netcdf4")
    f = {(p, k): str(d / f"{p}_{k}.nc") for p in ("jax", "torch")
         for k in ("b0", "run")}

    def argv(p, fmt, out, y, src=None):
        # the bed updated every year, so every run here moves it
        a = bootstrap_argv(data, out, 200.0, y, fmt, Mz=11, dtype="float64",
                           extra=("-config",
                                  "bed_deformation.update_interval=1"))
        a = [x for x in a if x != "-verbose" and x != "1"]
        if src is not None:   # the same flags on a -i of ``src``
            a = ["-i", src] + a[a.index("-stress_balance"):]
        return a

    res = {"files": f, "data": data, "dir": d}
    res["b0"] = _both_clis(lambda p, fmt: argv(p, fmt, f[p, "b0"], 0.0))
    tie = str(d / "tie0.nc")
    res["ties"] = _untie(f["torch", "b0"], tie)
    records = []
    orig = IceModel.run

    def run(self, state, time, *a, **k):
        out = orig(self, state, time, *a, **k)
        records.append((self, time, out[0]))
        return out

    IceModel.run = run
    try:
        res["run"] = _both_clis(lambda p, fmt: argv(p, fmt, f[p, "run"], 2.0,
                                                    src=tie))
        rst = str(d / "restart.nc")
        assert t_cli.main(["-i", f["torch", "run"], "-y", "1", "-o", rst,
                           "-o_format", "netcdf3", "-platform", "cpu",
                           "-verbose", "0"]) == 0
    finally:
        IceModel.run = orig
    res["records"] = records
    res["restart"] = rst
    return res


def test_pik_bootstrap_matches(pik):
    """The PIK bootstrap through both command lines: the same variables,
    every field within 1e-12 of its max (the Lingle-Clark references and
    viscous displacement included)."""
    f = pik["files"]
    a, b = f["torch", "b0"], f["jax", "b0"]
    with File(a, "r") as fa, File(b, "r") as fb:
        names = sorted(set(fa.variables()))
        assert names == sorted(set(fb.variables()))
    assert "viscous_bed_displacement" in names and "lat" in names
    names = [n for n in names if n not in ("time", "mask")]
    assert _cmp(a, b, names, 1e-12) == []
    assert pik["ties"] > 0


def test_pik_run_matches(pik):
    """2 a of the chain from the untied bootstrap through both command
    lines: equal steps and dt-limit hits, H within 5e-7 of max H (from the
    second SSA solve on the two packages' stagnating solves part, as in
    tests/test_torch_antarctica.py; measured 2.2e-7) and the viscous
    displacement too (linear in the load, which carries H's difference;
    8.1e-8), the bed within 1e-9 of its max (1.7e-12)."""
    f = pik["files"]
    steps = pik["run"]
    assert steps["torch"] == steps["jax"] and steps["torch"][0] > 0
    a, b = f["torch", "run"], f["jax", "run"]
    assert _cmp(a, b, ["thk", "usurf", "Href", "viscous_bed_displacement"],
                5e-7) == []
    assert _cmp(a, b, ["topg"], 1e-9) == []


def test_pik_cli_equals_python(pik):
    """The CLI's 2 a run equals, to the bit, the same run driven from
    Python: the untied file's state, the couplers through the factory
    from the run's stored config and the data file, ``IceModel.run``."""
    import dataclasses

    from pism_tpu_torch.examples.antarctica_pik import couplers
    from pism_tpu_torch.model.icemodel import IceModel
    from pism_tpu_torch.util.timecal import Time

    f = pik["files"]
    cfg = t_ckpt.load_config(f["torch", "run"])
    grid = t_ckpt.load_grid(f["torch", "run"])
    tie = str(pik["dir"] / "tie0.nc")
    st0, t0 = t_ckpt.load_state(tie, config=cfg, device="cpu")
    surface, ocean = couplers(cfg, grid, tie, "cpu")
    model = IceModel(grid=grid, config=cfg, surface=surface, ocean=ocean,
                     device="cpu")
    st, _ = model.run(st0.replace(u_ssa=None, v_ssa=None),
                      Time(t0, t0 + 2.0 * SPY))
    cli_state = t_ckpt.load_state(f["torch", "run"], device="cpu")[0]
    # (not the grounded fraction: the step recomputes it without the
    # sub-grid rule after the bed update, as the JAX step does, and
    # load_state with it)
    for fld in dataclasses.fields(st.geometry):
        if fld.name != "cell_grounded_fraction":
            assert torch.equal(getattr(st.geometry, fld.name),
                               getattr(cli_state.geometry, fld.name)), fld.name
    for name in ("enthalpy", "u_ssa", "bed_uplift", "bed_reference",
                 "bed_load_reference"):
        assert torch.equal(getattr(st, name), getattr(cli_state, name)), name


def test_pik_restart_continues_to_the_bit(pik):
    """A plain -i restart of the 2 a run (its chains rebuilt from the
    stored config; lat from the file's projection, precipitation and PICO's
    ocean from the data file) equals the first run's state continued in
    memory for the same 1 a, to the bit: H, E, u, the bed, the viscous
    displacement and the Lingle-Clark references."""
    from pism_tpu_torch.util.timecal import Time

    model, time, end = [r for r in pik["records"]
                        if r[0].device.type == "cpu"][-2]
    st, _ = model.run(end, Time(time.end, time.end + SPY))
    rst = t_ckpt.load_state(pik["restart"], device="cpu")[0]
    assert torch.equal(st.geometry.ice_thickness, rst.geometry.ice_thickness)
    assert torch.equal(st.geometry.bed_elevation, rst.geometry.bed_elevation)
    for name in ("enthalpy", "u_ssa", "v_ssa", "bed_uplift", "bed_reference",
                 "bed_load_reference"):
        assert torch.equal(getattr(st, name), getattr(rst, name)), name
    # the restart's year moved the bed
    first = t_ckpt.load_state(pik["files"]["torch", "run"], device="cpu")[0]
    assert not torch.equal(rst.bed_uplift, first.bed_uplift)


def test_test_P_through_main_equals_run_P(capsys):
    """``-test P`` through the port's ``cli.main`` prints the report of
    ``runner.run_P`` on the same grid and run length."""
    from pism_tpu_torch.verification import runner

    assert t_cli.main(["-test", "P", "-Mx", "21", "-y", "0.25",
                       "-platform", "cpu"]) == 0
    via_main = capsys.readouterr().out
    runner.run_P(Mx=21, years=0.25, device="cpu")
    assert via_main == capsys.readouterr().out
    assert "test P (routing steady state, 0.2 a, 21x21)" in via_main


@pytest.mark.parametrize("hydrology", ["routing", "distributed", "steady"])
def test_hydrology_refused_on_member_axis_and_mesh(hydrology):
    """``-hydrology routing|distributed|steady`` on an ensemble's member axis
    and under a mesh raises, naming ROADMAP Queue 1 items 3 and 10."""
    from pism_tpu_torch import setups
    from pism_tpu_torch.parallel import make_mesh
    from pism_tpu_torch.parallel.ensemble import EnsembleRunner

    model, *_ = setups.hybrid_ensemble_model(
        2, 200.0, "float64", device="cpu",
        extra_cfg={"hydrology.model": hydrology})
    with pytest.raises(NotImplementedError, match="item 3"):
        EnsembleRunner(model)
    with pytest.raises(NotImplementedError, match="item 10"):
        setups.hybrid_greenland_model("float64", 200.0, device="cpu",
                                      hydrology=hydrology,
                                      mesh=make_mesh(["cpu"] * 4, (2, 2)))


def test_hydrology_flag_runs(tmp_path):
    """``-hydrology routing`` builds the routing model in a restart of the
    hybrid chain, and its state is saved as ``bwat``."""
    from pism_tpu_torch import setups
    from pism_tpu_torch.physics.hydrology import Routing

    model, state, grid = setups.hybrid_greenland_model("float64", 200.0,
                                                       device="cpu")
    src, out = str(tmp_path / "s.nc"), str(tmp_path / "o.nc")
    t_ckpt.save_state(src, state, grid, 0.0, config=model.config,
                      format="netcdf3")
    built = []
    orig = Routing.__post_init__

    def spy(self):
        orig(self)
        built.append(self)

    Routing.__post_init__ = spy
    try:
        assert t_cli.main(["-i", src, "-hydrology", "routing", "-y", "0.2",
                           "-o", out, "-o_format", "netcdf3", "-platform",
                           "cpu", "-verbose", "0", "-surface", "uniform"]) == 0
    finally:
        Routing.__post_init__ = orig
    assert built
    with File(out, "r") as f:
        assert f.has_variable("bwat")


@pytest.mark.parametrize("test,Mx", [("blatter_xz", "17"),
                                     ("blatter_xz_cfbc", "49")])
def test_cli_blatter_xz_matches_runner(capsys, test, Mx):
    """``-test blatter_xz[_cfbc] -Mx N`` through the port's ``main`` prints
    the JAX package's runner table for that row (its command line refuses
    the name; its runner takes it), the numbers within 1e-6 relative."""
    from pism_tpu.verification import runner as j_runner

    capsys.readouterr()
    j_runner.run_test(test, Mx=int(Mx))
    want = capsys.readouterr().out.strip().splitlines()
    assert t_cli.main(["-test", test, "-Mx", Mx, "-platform", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()
    num = re.compile(r"[-+]?\d+\.\d+")
    assert len(got) == len(want) >= 3
    for a, b in zip(want, got):
        assert num.sub("#", b) == num.sub("#", a)
        for x, y in zip(num.findall(a), num.findall(b)):
            assert float(y) == pytest.approx(float(x), rel=1e-6, abs=1e-9)


def test_cli_test_I_fem_matches(capsys):
    """``-test I -config stress_balance.ssa.method=fem`` (at 11 x 31)
    through both packages' ``main``: the same report line, its velocities
    and errors within 1e-5 of max|u| (and the last printed digit)."""
    argv = ["-test", "I", "-My", "31", "-config",
            "stress_balance.ssa.method=fem"]
    capsys.readouterr()
    assert j_cli.main(argv) == 0
    want = capsys.readouterr().out.strip().splitlines()[-1]
    assert t_cli.main(argv + ["-platform", "cpu"]) == 0
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got.startswith("test I (SSAFEM): ")
    num = re.compile(r"[-+]?\d+\.\d+")
    assert num.sub("#", got) == num.sub("#", want)
    a, b = [float(x) for x in num.findall(want)], \
        [float(x) for x in num.findall(got)]
    for x, y in zip(a, b):
        assert abs(x - y) <= 1e-5 * a[0] + 0.0051


def _blatter_dome_file(path):
    """The JAX Blatter test's dome (16 x 16 x 11, enthalpy, Mohr-Coulomb)
    prepared by the port and saved with its config."""
    from pism_tpu_torch import Config, Grid
    from pism_tpu_torch.coupler.surface import Uniform
    from pism_tpu_torch.model.icemodel import IceModel
    from pism_tpu_torch.state import ModelState, new_geometry

    grid = Grid(Mx=16, My=16, Lx=300e3, Ly=300e3, Mz=11, Lz=3000.0)
    cfg = Config({"stress_balance.model": "blatter",
                  "energy.model": "enthalpy",
                  "basal_yield_stress.model": "mohr_coulomb",
                  "hydrology.model": "null",
                  "time_stepping.maximum_time_step": 20.0})
    r = np.asarray(grid.radius)
    H = torch.as_tensor(2500.0 * np.maximum(1.0 - (r / 280e3) ** 2, 0.0))
    model = IceModel(grid=grid, config=cfg, device="cpu",
                     surface=Uniform(smb=0.3 / SPY, temperature=253.15))
    state = model.prepare_state(ModelState(
        geometry=new_geometry(H, torch.zeros_like(H))))
    t_ckpt.save_state(path, state, grid, 0.0, config=cfg, format="netcdf3")


def _mismip_file(path, model_name):
    from pism_tpu_torch import setups
    model, state, grid = setups.mismip_model(
        "float64", 31, 5, device="cpu",
        extra_cfg={"stress_balance.model": model_name})
    t_ckpt.save_state(path, state, grid, 0.0, config=model.config,
                      format="netcdf3")


@pytest.mark.parametrize("model,years", [("blatter", 20), ("ssa", 1),
                                         ("none", 1)])
def test_cli_stress_balance_runs_and_restarts(tmp_path, model, years):
    """``-stress_balance blatter`` on a small dome and ``ssa``/``none`` on
    MISMIP 1 run from a saved state, and a restart from the run's end
    continues to the bit (two runs of ``years`` against one of twice as
    long with an output at the middle), in ``-o_format netcdf3``."""
    from pism_tpu_torch.convert import state_to_numpy

    src = str(tmp_path / "src.nc")
    (_blatter_dome_file if model == "blatter"
     else lambda p: _mismip_file(p, model))(src)
    base = ["-stress_balance", model, "-platform", "cpu", "-verbose", "0",
            "-o_format", "netcdf3"]
    full, half, cont = (str(tmp_path / n) for n in ("full.nc", "half.nc",
                                                    "cont.nc"))
    assert t_cli.main(["-i", src, "-y", str(2 * years), "-o", full,
                       "-extra_file", str(tmp_path / "ex.nc"),
                       "-extra_times", str(years), "-extra_vars", "thk"]
                      + base) == 0
    assert t_cli.main(["-i", src, "-y", str(years), "-o", half] + base) == 0
    assert t_cli.main(["-i", half, "-y", str(years), "-o", cont] + base) == 0
    a = state_to_numpy(t_ckpt.load_state(full, device="cpu")[0])
    b = state_to_numpy(t_ckpt.load_state(cont, device="cpu")[0])
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    H0 = t_ckpt.load_state(src, device="cpu")[0].geometry.ice_thickness
    u = a.get("u_ssa")
    if model == "none":
        # no velocity, and a restart's surface is a zero SMB: nothing moves
        assert u is None or not np.any(u)
        np.testing.assert_array_equal(a["ice_thickness"], H0.numpy())
    else:
        assert not np.array_equal(a["ice_thickness"], H0.numpy())
        assert np.isfinite(u).all() and np.abs(u).max() > 0


# -- the rest of the coupler through the command line -----------------------

def _ismip6_files(d, boot):
    """An ISMIP6 reference climate and a three-record anomaly/gradient
    forcing on the bootstrap file's grid (classic NetCDF). Both packages
    read the anomalies and gradients without a unit conversion, so they
    are in internal units (m s-1 ice equivalent)."""
    with File(boot, "r") as f:
        x, y = f.read("x"), f.read("y")
        usurf = np.maximum(f.read("thk") + f.read("topg"), 0.0)
    shp = (y.size, x.size)
    ref, frc = str(d / "ismip6_ref.nc"), str(d / "ismip6.nc")
    with File(ref, "w", format="netcdf3") as f:
        f.define_dimension("y", y.size, y)
        f.define_dimension("x", x.size, x)
        f.write("climatic_mass_balance", np.full(shp, 250.0) - 0.1 * usurf,
                ("y", "x"), {"units": "kg m-2 year-1"})
        f.write("ice_surface_temp", 265.0 - 0.006 * usurf, ("y", "x"),
                {"units": "K"})
        f.write("usurf", usurf, ("y", "x"), {"units": "m"})
    with File(frc, "w", format="netcdf3") as f:
        f.define_dimension("time", None, attrs={"units": "years"})
        f.define_dimension("y", y.size, y)
        f.define_dimension("x", x.size, x)
        for k in range(3):
            n = f.append_time(0.5 * k)
            for name, v, u in (
                    ("climatic_mass_balance_anomaly", -0.06 / SPY * k,
                     "m s-1"),
                    ("ice_surface_temp_anomaly", 0.8 * k, "K"),
                    ("climatic_mass_balance_gradient", -2e-5 / SPY * k,
                     "s-1"),
                    ("ice_surface_temp_gradient", -0.001 * k, "K m-1")):
                f.write(name, np.full((1,) + shp, v), ("time", "y", "x"),
                        {"units": u}, time_index=n)
    return ref, frc


@pytest.fixture(scope="module")
def coupler_runs(tmp_path_factory):
    """The rest of the coupler through both command lines, each bootstrapped
    and run in float64: dEBM over the SeaRISE atmosphere with
    orographic precipitation (``examples/greenland_debm.py``'s command
    line: ``-o_size medium`` with the dEBM diagnostics) and ISMIP6 on the
    example's synthetic Greenland file at 100 km (SIA; 1.55 a and 1 a),
    the three-equation ``-ocean th`` on the synthetic Antarctic file at
    200 km (the PIK chain's flags, 1 a from the bootstrap with its ties
    moved, as the ``pik`` fixture runs); then the port's dEBM run continued
    by a plain -i restart for 0.5 a. ``IceModel.run`` is recorded."""
    from pism_tpu_torch.examples import greenland_debm
    from pism_tpu_torch.examples.antarctica_pik import (
        bootstrap_argv, synthesize_data_file)
    from pism_tpu_torch.model.icemodel import IceModel

    d = tmp_path_factory.mktemp("couplers")
    boot, ant = str(d / "g.nc"), str(d / "ant.nc")
    greenland_debm.synthesize_data_file(boot, 100.0, "netcdf4")
    synthesize_data_file(ant, 200.0, "netcdf4")
    ref, frc = _ismip6_files(d, boot)
    sia = ("-stress_balance", "sia")
    # to mid-July, where the high latitudes see the sun
    debm = greenland_debm.cli_argv(boot, "x.nc", 100.0, 1.55, Mz=11,
                                   extra=sia)
    i = debm.index("-o")
    del debm[i:i + 4]          # -o x.nc -o_format netcdf4
    cases = {
        "debm": debm,
        "ismip6": ["-i", boot, "-bootstrap", "-Mx", "16", "-My", "29", "-Mz",
                   "11", "-Lx", "750", "-Ly", "1400", "-Lz", "4000", "-y", "1",
                   "-surface", "ismip6",
                   "-config", "runtime.float_dtype=float64",
                   "-config", f"surface.ismip6.reference_file={ref}",
                   "-config", f"surface.ismip6.file={frc}", *sia],
    }
    out = {"dir": d}
    for name, argv in cases.items():
        # the bootstrap (zero length), its enthalpy ties moved, the run
        def boot0(p, fmt, argv=argv, name=name):
            out[name + "0", p] = str(d / f"{name}0_{p}.nc")
            a = list(argv)
            a[a.index("-y") + 1] = "0"
            return a + ["-o", out[name + "0", p], "-o_format", fmt]

        def run(p, fmt, argv=argv, name=name):
            out[name, p] = str(d / f"{name}_{p}.nc")
            return ["-i", out[name + "tie"]] + argv[argv.index("-Lz") + 2:] + [
                "-o", out[name, p], "-o_format", fmt]

        _both_clis(boot0)
        out[name + "tie"] = str(d / f"{name}_tie.nc")
        _untie(out[name + "0", "torch"], out[name + "tie"])
        out[name] = _both_clis(run)
        cases[name] = run("torch", "netcdf3")[:-4]

    def th(p, fmt, key, y, src=None):
        out[key, p] = str(d / f"{key}_{p}.nc")
        a = bootstrap_argv(ant, out[key, p], 200.0, y, fmt, Mz=11,
                           dtype="float64")
        i = a.index("-verbose")
        del a[i:i + 2]
        a[a.index("pico")] = "th"
        if src is not None:   # the same flags on a -i of ``src``
            a = ["-i", src] + a[a.index("-stress_balance"):]
        return a + ["-config", f"ocean.th.file={ant}"]

    # as the PIK fixture: the bootstrap, its enthalpy ties moved, the run
    _both_clis(lambda p, fmt: th(p, fmt, "th0", 0.0))
    tie = str(d / "th_tie.nc")
    _untie(out["th0", "torch"], tie)
    out["th"] = _both_clis(lambda p, fmt: th(p, fmt, "th", 1.0, src=tie))
    records = []
    orig = IceModel.run

    def run(self, state, time, *a, **k):
        res = orig(self, state, time, *a, **k)
        records.append((self, time, res[0]))
        return res

    IceModel.run = run
    try:
        first = str(d / "debm_first.nc")
        assert t_cli.main(cases["debm"] + ["-o", first, "-o_format",
                                           "netcdf3", "-platform", "cpu",
                                           "-verbose", "0"]) == 0
        out["restart"] = str(d / "debm_restart.nc")
        assert t_cli.main(["-i", first, "-y", "0.5", "-o", out["restart"],
                           "-o_format", "netcdf3", "-platform", "cpu"]) == 0
    finally:
        IceModel.run = orig
    out["records"] = records
    return out


@pytest.mark.parametrize("case", ["debm", "ismip6", "th"])
def test_coupler_routes_match(coupler_runs, case):
    """Equal steps and dt-limit hits through both command lines, the ice
    and the surface's state within 5e-7 of their maxima (the bound
    tests/test_torch_hybrid_chain.py and test_pik_run_matches hold H to)."""
    r = coupler_runs
    steps = r[case]
    assert steps["torch"] == steps["jax"] and steps["torch"][0] > 0
    names = {"debm": ["snow_depth", "albedo"], "th": ["usurf"]}.get(case, [])
    assert _cmp(r[case, "torch"], r[case, "jax"], ["thk"] + names,
                5e-7) == []


def test_debm_output_holds_albedo_and_insolation(coupler_runs):
    with File(coupler_runs["debm", "torch"], "r") as f:
        names = set(f.variables())
        alb, ins = f.read("albedo"), f.read("insolation")
    assert {"albedo", "insolation", "snow_depth", "climatic_mass_balance"} \
        <= names
    assert alb.min() >= 0.47 and alb.max() <= 0.82
    assert np.isfinite(ins).all() and ins.max() > 0.0


def test_debm_restart_continues_to_the_bit(coupler_runs):
    """A plain -i restart of the dEBM run (its chains rebuilt from the
    stored config, lat from the file) equals the first run's state
    continued in memory for the same 0.5 a, to the bit."""
    from pism_tpu_torch.util.timecal import Time

    model, time, end = coupler_runs["records"][-2]
    st, _ = model.run(end, Time(time.end, time.end + 0.5 * SPY))
    rst = t_ckpt.load_state(coupler_runs["restart"], device="cpu")[0]
    assert torch.equal(st.geometry.ice_thickness, rst.geometry.ice_thickness)
    for name in ("enthalpy", "surface_albedo", "snow_depth"):
        assert torch.equal(getattr(st, name), getattr(rst, name)), name


# -- the column tracers through both command lines ------------------------

TRACER_CONFIG = ("age.enabled=true", "age.initial_value=15000",
                 "age.isochrones.enabled=true",
                 "age.isochrones.deposition_times=4:0.1:6",
                 "energy.ch_warming.enabled=true")
TRACER_VARS = "age,isochrone_depth,ch_temp"


@pytest.fixture(scope="module")
def tracer_cli(workflow):
    """Stage 3 of the 100 km std-greenland workflow from its untied
    stage-2 file with ``-config`` turning on the age, isochrones (every
    0.1 a) and the CH system, 0.5 a (one step) with ``-extra_vars
    age,isochrone_depth,ch_temp`` at its end: through the JAX command line
    (NetCDF-4) and the port's in both formats; then the port's classic
    output continued by a plain -i restart for 0.5 a. ``IceModel.run`` is
    recorded, so the port's run can be continued in memory."""
    from pism_tpu_torch.examples.std_greenland_workflow import stage_argv
    from pism_tpu_torch.model.icemodel import IceModel

    d, boot = workflow["dir"], workflow["boot"]
    src = str(d / "tie2.nc")
    t0 = t_ckpt.load_state(src, device="cpu")[1] / SPY
    out = {}

    def argv(p, fmt):
        a = stage_argv(boot, (None, None, None), 100.0, (2.0, 2.0, 0.5),
                       fmt, dtype="float64")[2]
        a[a.index("-i") + 1] = src
        a[a.index("-o") + 1] = str(d / f"tr_{p}_{fmt}.nc")
        for kv in TRACER_CONFIG:
            a += ["-config", kv]
        return a + ["-extra_file", str(d / f"trx_{p}_{fmt}.nc"),
                    "-extra_vars", TRACER_VARS,
                    "-extra_times", f"{t0 + 0.5:.10g}"]

    out["counts"] = _both_clis(argv)
    records = []
    orig = IceModel.run

    def run(self, state, time, *a, **k):
        res = orig(self, state, time, *a, **k)
        records.append((self, time, res[0]))
        return res

    IceModel.run = run
    try:
        assert t_cli.main(argv("torch", "netcdf4") + ["-platform", "cpu"]) \
            == 0
        out["first"] = records[-1]
        rst = str(d / "tr_restart.nc")
        # (the stored config names the first run's extra file: the
        # restart writes its own)
        assert t_cli.main(["-i", str(d / "tr_torch_netcdf3.nc"), "-y", "0.5",
                           "-o", rst, "-o_format", "netcdf3", "-platform",
                           "cpu", "-verbose", "0", "-extra_file",
                           str(d / "trx_restart.nc")]) == 0
    finally:
        IceModel.run = orig
    out.update(dir=d, restart=rst, t0=t0)
    return out


def test_tracer_cli_matches_jax(tracer_cli):
    """Equal steps and hits; the state files' tracers and the extra file's
    isochrone_depth and ch_temp within the hybrid chain's 5e-7 of max (one
    step from equal states), the layer axis ``nl`` in both. The age within
    1e-5 of max: this stage's SSA solve stagnates in both packages and
    leaves the sliding velocity 5e-4 apart at the western margin
    (``test_workflow_hybrid_stage_matches`` holds it at 5e-2), where the
    age steps from 15 ka to 0 between neighbours, so the upwinded age at
    some 60 of 19,024 basal margin cells moves by up to 3e-6 of max."""
    d = tracer_cli["dir"]
    assert tracer_cli["counts"]["torch"] == tracer_cli["counts"]["jax"]
    assert _cmp(str(d / "tr_torch_netcdf4.nc"), str(d / "tr_jax_netcdf4.nc"),
                ["thk", "enthalpy", "ch_enthalpy",
                 "isochronal_layer_thickness"], 5e-7) == []
    a, b = str(d / "trx_torch_netcdf4.nc"), str(d / "trx_jax_netcdf4.nc")
    assert _cmp(a, b, ["isochrone_depth", "ch_temp"], 5e-7) == []
    for x, y in ((a, b), (str(d / "tr_torch_netcdf4.nc"),
                          str(d / "tr_jax_netcdf4.nc"))):
        assert _cmp(x, y, ["age"], 1e-5) == []
    with File(a, "r") as f:
        assert f.read("isochrone_depth").shape[-1] == 16
        assert f.read("age").shape[-1] == 41
    with File(str(d / "tr_torch_netcdf3.nc"), "r") as f:
        assert int(f.get_global_attr("iso_top")) >= 1


def test_tracer_cli_formats_equal(tracer_cli):
    """The port's classic and NetCDF-4 outputs hold the same values."""
    d = tracer_cli["dir"]
    for name in ("tr", "trx"):
        (va, ta), (vb, tb) = _read(d / f"{name}_torch_netcdf3.nc"), \
            _read(d / f"{name}_torch_netcdf4.nc")
        assert sorted(va) == sorted(vb)
        np.testing.assert_array_equal(ta, tb)
        for k, (x, _) in va.items():
            np.testing.assert_array_equal(x, vb[k][0], err_msg=k)


def test_tracer_cli_restart_continues_to_the_bit(tracer_cli):
    """A plain -i restart of the classic output (the tracers rebuilt from
    the stored config) equals the first run continued in memory for the
    same 0.5 a, to the bit: H, E, the age, the CH state, the isochrone
    layers and the active layer."""
    from pism_tpu_torch.util.timecal import Time

    model, time, end = tracer_cli["first"]
    st, _ = model.run(end, Time(time.end, time.end + 0.5 * SPY))
    rst = t_ckpt.load_state(tracer_cli["restart"], device="cpu")[0]
    assert torch.equal(st.geometry.ice_thickness, rst.geometry.ice_thickness)
    for name in ("enthalpy", "age", "ch_enthalpy", "iso_layers", "u_ssa"):
        assert torch.equal(getattr(st, name), getattr(rst, name)), name
    assert st.iso_top == rst.iso_top >= 2
