"""PICO (``coupler/pico.py``), pism_tpu_torch against pism_tpu on the CPU.

One numpy geometry on a 29 x 29 grid: a grounded ice sheet, an ice shelf
around it with an ice rise (a grounded island in the shelf), open ocean,
and per-cell ambient temperature and salinity made from a seed. In
float64 the box index and both hop distances (d_gl, d_if) are equal and
the melt, the shelf-base and box temperatures, the salinity and the
overturning agree to 1e-12 relative, for: no basins, one basin, two basins
and a third one without continental-shelf data (its T_basal is the
Beckmann-Goosse fallback's), ``exclude_ice_rises`` off, and
``maximize_grounding_line_distance``. In float32 the box indices and
distances are equal (both packages take the distances in float64). With
the JAX example's cold water on its synthetic Antarctica at 100 km the
cascade overflows to inf on the same cells in both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pism_tpu import Config as JConfig, Grid as JGrid
from pism_tpu.coupler.pico import Pico as JPico
from pism_tpu.state import new_geometry as j_geom
from pism_tpu_torch import Config, Grid, new_geometry
from pism_tpu_torch.coupler.pico import Pico
from pism_tpu_torch.util import hostsync

torch.set_num_threads(2)

GRID = dict(Mx=29, My=29, Lx=700e3, Ly=700e3)
RTOL = 1e-12


def shelf_geometry(seed=3):
    """(H, bed, T0, S0, basins) of a marine ice sheet with a shelf, an ice
    rise and open ocean; basins 1 (x <= 0), 2 (x > 0) and 3 (a corner of
    deep ocean, no continental-shelf data)."""
    g = JGrid(**GRID)
    X, Y = np.meshgrid(g.x, g.y)
    r = np.sqrt(X ** 2 + Y ** 2)
    rng = np.random.default_rng(seed)
    bed = 600.0 - 1400.0 * (r / 500e3) ** 2 \
        + 700.0 * np.exp(-((X - 500e3) ** 2 + Y ** 2) / 30e3 ** 2)
    H = np.where(r < 350e3, 2500.0 * np.sqrt(np.clip(1 - (r / 420e3) ** 2,
                                                       0, None)), 0.0)
    shelf = (r >= 350e3) & (r < 580e3)
    H = np.where(shelf, 550.0 - 1.5e-3 * (r - 350e3), H)
    H = H * (1.0 + 0.05 * rng.uniform(-1, 1, H.shape))
    # warm ambient water (above the liquidus at every draft), so every box
    # melts
    T0 = 272.6 + 0.6 * (X + Y) / 1400e3 + rng.uniform(0.0, 0.3, H.shape)
    S0 = 34.5 + 0.2 * (X - Y) / 1400e3 + rng.uniform(0.0, 0.2, H.shape)
    basins = np.where(X <= 0.0, 1, 2)
    basins = np.where((X < -550e3) & (Y < -550e3), 3, basins)
    return H, bed, T0, S0, basins


def _both(dtype="float64", basins=None, over=None):
    H, bed, T0, S0, b = shelf_geometry()
    cfg = dict({"runtime.float_dtype": dtype}, **(over or {}))
    npdt = np.float32 if dtype == "float32" else np.float64
    tdt = torch.float32 if dtype == "float32" else torch.float64
    jg = j_geom(jnp.asarray(H.astype(npdt)), jnp.asarray(bed.astype(npdt)))
    tg = new_geometry(torch.tensor(H, dtype=tdt), torch.tensor(bed, dtype=tdt))
    bm = {None: None, "one": np.ones_like(b), "three": b}[basins]
    jp = JPico(temperature_ocean=jnp.asarray(T0),
               salinity_ocean=jnp.asarray(S0), config=JConfig(cfg),
               grid=JGrid(**GRID),
               basin_mask=None if bm is None else jnp.asarray(bm))
    tp = Pico(temperature_ocean=torch.tensor(T0),
              salinity_ocean=torch.tensor(S0), config=Config(cfg),
              grid=Grid(**GRID),
              basin_mask=None if bm is None else torch.tensor(bm))
    return jp.solve(jg, 0.0), tp.solve(tg, 0.0), np.asarray(jg.cell_type)


def _close(got, want, name):
    g, w = got.numpy().astype(np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape, name
    scale = max(np.abs(w).max(), 1e-300)
    err = np.abs(g - w).max()
    assert err <= RTOL * scale, f"{name}: {err:.3e} > {RTOL:.0e} * {scale:.3e}"


CASES = [(None, None), ("one", None), ("three", None),
         (None, {"ocean.pico.exclude_ice_rises": False}),
         ("three", {"ocean.pico.maximize_grounding_line_distance": True})]


@pytest.mark.parametrize("basins,over", CASES)
def test_pico_matches(basins, over):
    jf, tf, mask = _both(basins=basins, over=over)
    # the geometry has a shelf in several boxes and an ice rise
    assert (mask == 3).sum() > 100 and len(np.unique(np.asarray(jf.box))) >= 4
    assert mask[14, 24] == 2 and (mask[13:16, 23:26] == 3).sum() == 8
    for name in ("box", "d_gl", "d_if", "contshelf"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                      np.asarray(getattr(jf, name)),
                                      err_msg=name)
    for name in ("melt", "T_basal", "temperature", "salinity", "overturning"):
        _close(getattr(tf, name), getattr(jf, name), name)
    assert float(tf.melt.max()) > 0.0


def test_basin_without_data_takes_the_fallback():
    """Basin 3 has no continental shelf and no shelf ice: its cells get the
    Beckmann-Goosse shelf-base temperature of the T_dummy/S_dummy ambient,
    in both packages."""
    jf, tf, _ = _both(basins="three")
    _, _, _, _, b = shelf_geometry()
    corner = b == 3
    assert corner.any()
    tb = tf.T_basal.numpy()
    np.testing.assert_allclose(tb[corner], np.asarray(jf.T_basal)[corner],
                               rtol=RTOL)
    # the fallback's liquidus at S_dummy, not the default B_LIQ
    assert not np.allclose(tb[corner], 0.0788 + 273.15)


def test_exclude_ice_rises_changes_the_boxes():
    a = _both()[1].box
    b = _both(over={"ocean.pico.exclude_ice_rises": False})[1].box
    assert not torch.equal(a, b)


@pytest.mark.parametrize("basins", [None, "three"])
def test_float32_box_indices_equal(basins):
    jf, tf, _ = _both("float32", basins=basins)
    for name in ("box", "d_gl", "d_if"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                      np.asarray(getattr(jf, name)),
                                      err_msg=name)
    assert tf.d_gl.dtype == torch.float64 and tf.melt.dtype == torch.float32


def test_host_syncs_per_call_are_counted():
    """Each flood fill reads its change flag once per CHECK_EVERY sweeps;
    the three fills of a call take a handful of syncs, far fewer than the
    sweeps (which the JAX loop bounds by My + Mx)."""
    H, bed, T0, S0, _ = shelf_geometry()
    p = Pico(temperature_ocean=torch.tensor(T0),
             salinity_ocean=torch.tensor(S0),
             config=Config({"runtime.float_dtype": "float64"}),
             grid=Grid(**GRID))
    geom = new_geometry(torch.tensor(H), torch.tensor(bed))
    n0 = hostsync.COUNT
    p.solve(geom, 0.0)
    n = hostsync.COUNT - n0
    assert 3 <= n <= 3 * (GRID["Mx"] + GRID["My"]) // 8 + 3


@pytest.mark.parametrize("basins", [None, "two"])
def test_cold_water_cascade_agrees_where_it_overflows(basins):
    """The JAX example's ocean (271.45 K, 34.65 g/kg) on its initial
    synthetic Antarctica at 100 km (41 x 41), float64. The cascade takes
    each cell with its own overburden pressure, and under the deep drafts
    the water refreezes: the denominator of boxes k >= 2 is clamped at
    1e-30 and the melt, the shelf-base temperature and the box salinity
    overflow to inf there. Both packages overflow on the same cells with
    the same boxes and hop distances. Without basins (the example's own
    ocean) the finite values agree to 1e-12. With two basins the
    continental-shelf means are sums in a different order (JAX's
    segment_sum adds cell by cell) and differ by 1e-14 relative; the
    cascade's finite values, up to 1e267 next to the overflowing cells,
    amplify that, so they are held to 1e-10 (the overturning, which
    stays physical, to 1e-12)."""
    from pism_tpu_torch.setups import antarctic_geometry
    g = dict(Mx=41, My=41, Lx=2000e3, Ly=2000e3)
    H, bed, _ = antarctic_geometry(Grid(**g))
    T0, S0 = np.full(H.shape, 271.45), np.full(H.shape, 34.65)
    bm = None if basins is None else \
        np.where(np.meshgrid(Grid(**g).x, Grid(**g).y)[0] < 0.0, 1, 2)
    cfg = {"runtime.float_dtype": "float64"}
    jf = JPico(temperature_ocean=jnp.asarray(T0),
               salinity_ocean=jnp.asarray(S0), config=JConfig(cfg),
               grid=JGrid(**g),
               basin_mask=None if bm is None else jnp.asarray(bm)).solve(
        j_geom(jnp.asarray(H), jnp.asarray(bed)), 0.0)
    tf = Pico(temperature_ocean=torch.tensor(T0),
              salinity_ocean=torch.tensor(S0), config=Config(cfg),
              grid=Grid(**g),
              basin_mask=None if bm is None else torch.tensor(bm)).solve(
        new_geometry(torch.tensor(H), torch.tensor(bed)), 0.0)
    for name in ("box", "d_gl", "d_if"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                      np.asarray(getattr(jf, name)),
                                      err_msg=name)
    assert not np.isfinite(np.asarray(jf.melt)).all()
    rtol = {None: RTOL, "two": 1e-10}[basins]
    for name in ("melt", "T_basal", "temperature", "salinity", "overturning"):
        w = np.asarray(getattr(jf, name))
        got = getattr(tf, name).numpy()
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=name)
        np.testing.assert_array_equal(got[~fin], w[~fin], err_msg=name)
        tol = RTOL if name == "overturning" else rtol
        scale = max(np.abs(w[fin]).max(), 1e-300)
        err = np.abs(got[fin] - w[fin]).max()
        assert err <= tol * scale, f"{name}: {err:.3e} > {tol:.0e} * {scale:.3e}"


def test_pico_diagnostics_follow_the_state():
    """The pico_* diagnostics solve PICO once per record: states queried
    one after another at the same time, each freed before the next is
    made, each get their own geometry's fields."""
    from types import SimpleNamespace

    from pism_tpu_torch.model import diagnostics as dg
    from pism_tpu_torch.state import ModelState
    H, bed, T0, S0, _ = shelf_geometry()
    p = Pico(temperature_ocean=torch.tensor(T0),
             salinity_ocean=torch.tensor(S0),
             config=Config({"runtime.float_dtype": "float64"}),
             grid=Grid(**GRID))
    model = SimpleNamespace(ocean=p)
    for scale in (1.0, 0.5, 1.0, 0.3):
        state = ModelState(geometry=new_geometry(torch.tensor(H * scale),
                                                 torch.tensor(bed)))
        want = p.solve(state.geometry, 0.0)
        for name, field in (("pico_box_mask", want.box),
                            ("pico_basal_melt_rate", want.melt)):
            assert torch.equal(dg.SPATIAL[name].func(state, model, 0.0),
                               field), (name, scale)
        del state
