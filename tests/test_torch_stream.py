"""Streamed forcing (``coupler/stream.py``, ``GivenStreamed``) on the CPU:
the record lookup (piecewise constant, clamped, cycled, refused outside
the series without time extrapolation) and the read-ahead, from NetCDF-4
and classic files, a bounded cache that keeps handing out the right
records while it evicts, the same records as the stack loaded up front,
and a model run driven by the streamed climate against the JAX package's
(the JAX package's ``tests/test_stream.py`` cases)."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pism_tpu_torch import Config, Grid, Time
from pism_tpu_torch.coupler.stream import ForcingStream
from pism_tpu_torch.coupler.surface import GivenStreamed
from pism_tpu_torch.io.nc4 import File
from pism_tpu_torch.util.forcing import constant_slice

torch.set_num_threads(2)

SPY = 3.15569259747e7


def _write_forcing(path, grid, nt=12, fmt="netcdf4"):
    """Monthly SMB [m/a = month index] and temperature records."""
    with File(str(path), "w", format=fmt) as f:
        f.define_dimension("time", None, attrs={"units": "s"})
        f.define_dimension("y", grid.My, np.asarray(grid.y))
        f.define_dimension("x", grid.Mx, np.asarray(grid.x))
        f.define_variable("climatic_mass_balance", ("time", "y", "x"))
        f.define_variable("ice_surface_temp", ("time", "y", "x"))
        for k in range(nt):
            f.append_time(k * SPY / 12.0)
            f.write("climatic_mass_balance",
                    np.full(grid.shape2, float(k) / SPY), time_index=k)
            f.write("ice_surface_temp",
                    np.full(grid.shape2, 250.0 + k), time_index=k)
    return str(path)


@pytest.mark.parametrize("fmt", ["netcdf4", "netcdf3"])
def test_stream_lookup_and_prefetch(tmp_path, fmt):
    grid = Grid(Mx=16, My=16, Lx=100e3, Ly=100e3)
    path = _write_forcing(tmp_path / "forcing.nc", grid, fmt=fmt)
    s = ForcingStream(path, "climatic_mass_balance", lookahead=3)
    assert s.nt == 12 and s.shape == grid.shape2
    assert float(s.slice_at(0.0)[0, 0]) * SPY == 0.0
    assert abs(float(s.slice_at(2.5 * SPY / 12.0)[0, 0]) * SPY - 2.0) < 1e-4
    assert abs(float(s.slice_at(99.0 * SPY)[0, 0]) * SPY - 11.0) < 1e-4
    assert abs(float(s.slice_at(-5.0 * SPY)[0, 0]) * SPY) < 1e-4
    assert s.slice_at(4.1 * SPY / 12.0).dtype == torch.float32
    time.sleep(0.3)
    # the read-ahead filled records never asked for
    assert s.prefetch_hits + len(s._cache) > s.misses
    s.close()


def test_bounded_cache_keeps_the_right_records(tmp_path):
    grid = Grid(Mx=8, My=6, Lx=100e3, Ly=100e3)
    path = _write_forcing(tmp_path / "f.nc", grid, nt=12, fmt="netcdf3")
    s = ForcingStream(path, "ice_surface_temp", lookahead=1, cache_slices=2)
    rng = np.random.default_rng(0)
    for t in list(np.arange(12) * SPY / 12.0 + 1.0) \
            + list(rng.uniform(0.0, SPY, 30)):
        k = int(np.clip(np.searchsorted(s.times, t, side="right") - 1, 0, 11))
        assert torch.equal(s.slice_at(t), torch.full(grid.shape2, 250.0 + k))
    # the cache holds at least lookahead + 2 records
    assert s.cache_slices == 3 and len(s._cache) <= 3
    s.close()


def test_periodic_and_no_extrapolation(tmp_path):
    grid = Grid(Mx=8, My=6, Lx=100e3, Ly=100e3)
    path = _write_forcing(tmp_path / "f.nc", grid, nt=12)
    s = ForcingStream(path, "ice_surface_temp", period=SPY)
    assert float(s.slice_at(3.0 * SPY + 5.5 * SPY / 12.0)[0, 0]) == 255.0
    s.close()
    s = ForcingStream(path, "ice_surface_temp",
                      **ForcingStream.config_kwargs(Config(
                          {"input.forcing.time_extrapolation": False})))
    assert float(s.slice_at(0.5 * SPY)[0, 0]) == 256.0
    with pytest.raises(RuntimeError, match="does not cover"):
        s.slice_at(3.0 * SPY)
    s.close()


def test_streamed_records_equal_the_loaded_stack(tmp_path):
    """The records the stream hands out are the stack loaded up front,
    looked up at the same times."""
    from pism_tpu_torch.io.bootstrap import read_forcing_fields
    grid = Grid(Mx=9, My=7, Lx=100e3, Ly=100e3)
    path = _write_forcing(tmp_path / "f.nc", grid, fmt="netcdf3")
    fields, times = read_forcing_fields(path, grid, ["ice_surface_temp"])
    stack = torch.tensor(fields["ice_surface_temp"])
    s = ForcingStream(path, "ice_surface_temp")
    for t in np.linspace(-0.1, 1.2, 17) * SPY:
        assert torch.equal(s.slice_at(t).double(),
                           constant_slice(stack, times, 0.0, t,
                                          torch.float64)), t
    s.close()


@pytest.fixture(scope="module")
def streamed_runs(tmp_path_factory):
    """0.5 a with the SMB of the streamed records (no flow, no energy),
    in both packages."""
    from pism_tpu import Config as JConfig
    from pism_tpu import Grid as JGrid
    from pism_tpu import Time as JTime
    from pism_tpu.coupler.stream import ForcingStream as JStream
    from pism_tpu.coupler.surface import GivenStreamed as JStreamed
    from pism_tpu.model.icemodel import IceModel as JIceModel
    from pism_tpu.state import ModelState as JState
    from pism_tpu.state import new_geometry as j_geom
    from pism_tpu_torch.model.icemodel import IceModel
    from pism_tpu_torch.state import ModelState, new_geometry

    kw = dict(Mx=16, My=16, Lx=100e3, Ly=100e3)
    grid = Grid(**kw)
    path = _write_forcing(tmp_path_factory.mktemp("s") / "f.nc", grid)
    cfg = {"stress_balance.model": "none", "energy.model": "none",
           "geometry.part_grid.enabled": False,
           "time_stepping.maximum_time_step": 1.0 / 24.0}
    smb = ForcingStream(path, "climatic_mass_balance", lookahead=3)
    temp = ForcingStream(path, "ice_surface_temp", lookahead=3)
    model = IceModel(grid=grid, config=Config(cfg),
                     surface=GivenStreamed(smb=smb, temperature=temp),
                     device="cpu")
    s0 = ModelState(geometry=new_geometry(
        torch.full(grid.shape2, 500.0, dtype=torch.float64),
        torch.zeros(grid.shape2, dtype=torch.float64)))
    ts, tstats = model.run(s0, Time(0.0, 0.5 * SPY))
    jsmb = JStream(path, "climatic_mass_balance", lookahead=3)
    jtemp = JStream(path, "ice_surface_temp", lookahead=3)
    jm = JIceModel(grid=JGrid(**kw), config=JConfig(cfg),
                   surface=JStreamed(smb=jsmb, temperature=jtemp))
    js, jstats = jm.run(JState(geometry=j_geom(
        jnp.full(grid.shape2, 500.0), jnp.zeros(grid.shape2))),
        JTime(0.0, 0.5 * SPY))
    out = (ts, tstats, js, jstats, smb.misses + len(smb._cache))
    for s in (smb, temp, jsmb, jtemp):
        s.close()
    return out


def test_streamed_surface_drives_model(streamed_runs):
    ts, tstats, js, jstats, touched = streamed_runs
    # the SMB ramps 0..5 m/a over the first six months: the time mean of
    # the visited records
    growth = float(ts.geometry.ice_thickness[8, 8]) - 500.0
    assert abs(growth - np.mean([0, 1, 2, 3, 4, 5]) * 0.5) < 0.2
    assert touched <= 12
    assert tstats.nsteps == int(jstats.nsteps)
    want = np.asarray(js.geometry.ice_thickness)
    assert np.abs(ts.geometry.ice_thickness.numpy() - want).max() \
        <= 1e-12 * want.max()
