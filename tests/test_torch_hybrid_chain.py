"""The whole hybrid slice: pism_tpu_torch against pism_tpu on the 100 km
synthetic-Greenland chain in float64, two model years through
``IceModel.step_once``.

Both packages build the chain themselves (``bench.hybrid_greenland_model``
and ``setups.hybrid_greenland_model``), and the initial states are equal.
Before the run the trajectories start from one numpy state in which the
enthalpies that the bootstrap put exactly at the pressure-melting value are
moved 1 J/kg below it. Those 3425 ties decide temperate-or-cold tests
(``E >= E_s``), and under ``jit`` XLA evaluates E_s with rounding that
differs from the unfused expression by about 1e-11 J/kg either way, so the
reference itself flips them at random; left in, they move the enthalpy by
1e-2 relative within a year.

Tolerances. Step counts and dt-limit hits are equal, and the ice volume
agrees to 1e-9 relative. The fields are held to looser bounds than 1e-8 of
max H, 1e-9 relative enthalpy and 1e-6 of max|u|, because every SSA solve
amplifies rounding (tests/test_torch_ssa_solve.py: 1e-15 in, 1e-5 of
max|u| out). Measured after two years (3 steps): H agrees to 2e-8 of
max H, the part-grid volume and grounded fraction to 5e-8 and the
enthalpy to 3e-8 relative; bounds 5e-7. The velocities are
those of the last solve, which starts with the Picard warmup, whose inner
solves stop at 1e-2 relative residual: there the two packages leave the
warmup 1% apart in |F|^2 and take 5 and 6 Newton sweeps, ending 1e-2 of
max|u| apart (that step is under a minute long, so H does not see it);
bound 5e-2. The calving discharge agrees to 7e-7 relative, bound 1e-5.
"""

import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

# importing bench.py turns on a persistent compilation cache (in the repo
# unless JAX_COMPILATION_CACHE_DIR is set): point it at a temporary
# directory, then put the cache settings and the environment back
_env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
_cache = (jax.config.jax_compilation_cache_dir,
          jax.config.jax_persistent_cache_min_compile_time_secs)
os.environ["JAX_COMPILATION_CACHE_DIR"] = tempfile.mkdtemp()
import bench  # noqa: E402

jax.config.update("jax_compilation_cache_dir", _cache[0])
jax.config.update("jax_persistent_cache_min_compile_time_secs", _cache[1])
if _env is None:
    del os.environ["JAX_COMPILATION_CACHE_DIR"]
else:
    os.environ["JAX_COMPILATION_CACHE_DIR"] = _env

from pism_tpu import state as JS  # noqa: E402
from pism_tpu_torch import setups  # noqa: E402
from pism_tpu_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402

SPY = 3.15569259747e7
YEARS = 2.0


def jax_to_numpy(st):
    d = {f.name: np.asarray(getattr(st.geometry, f.name))
         for f in dataclasses.fields(st.geometry)}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if f.name != "geometry" and v is not None:
            d[f.name] = np.asarray(v)
    return d


def numpy_to_jax(d):
    names = {f.name for f in dataclasses.fields(JS.Geometry)}
    geom = JS.Geometry(**{k: jnp.asarray(d[k]) for k in names})
    return JS.ModelState(geometry=geom, **{k: jnp.asarray(v) for k, v in d.items()
                                           if k not in names})


def break_pressure_melting_ties(d, grid, EC):
    """Move enthalpies that sit exactly at E_s(p) 1 J/kg below it."""
    H = torch.tensor(d["ice_thickness"])
    z = torch.as_tensor(grid.z)
    Es = EC.enthalpy_cts(EC.pressure(torch.clamp(H[..., None] - z, min=0.0)))
    E = d["enthalpy"]
    tie = np.abs(E - Es.numpy()) <= 1e-9 * np.abs(Es.numpy())
    out = dict(d)
    out["enthalpy"] = np.where(tie, E - 1.0, E)
    return out, int(tie.sum())


@pytest.fixture(scope="module")
def chain():
    jm, js, _ = bench.hybrid_greenland_model("float64", km=100)
    tm, ts, grid = setups.hybrid_greenland_model("float64", km=100,
                                                 device="cpu")
    d0_jax, d0_torch = jax_to_numpy(js), state_to_numpy(ts)
    d, n_ties = break_pressure_melting_ties(d0_jax, grid, tm.EC)
    js, tj, sj = jm.step_once(numpy_to_jax(d), 0.0, YEARS * SPY)
    ts, tt, st = tm.step_once(state_from_numpy(d, device="cpu"), 0.0, YEARS * SPY)
    return dict(d0_jax=d0_jax, d0_torch=d0_torch, n_ties=n_ties,
                jax=(jax_to_numpy(js), float(tj), sj),
                torch=(state_to_numpy(ts), tt, st), grid=grid)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def test_initial_states_equal(chain):
    a, b = chain["d0_jax"], chain["d0_torch"]
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert chain["n_ties"] > 0


def test_step_counts_and_limit_hits_equal(chain):
    (_, tj, sj), (_, tt, st) = chain["jax"], chain["torch"]
    assert st.nsteps == int(sj.nsteps) > 0
    assert st.limit_hits_dict() == sj.limit_hits_dict()
    assert tt == pytest.approx(YEARS * SPY, abs=1e-6) and tt == tj
    assert st.dt_min == pytest.approx(float(sj.dt_min), rel=1e-12)
    assert st.dt_max == pytest.approx(float(sj.dt_max), rel=1e-12)


def test_ice_volume(chain):
    (a, _, sj), (b, _, st) = chain["jax"], chain["torch"]
    vj, vt = a["ice_thickness"].sum(), b["ice_thickness"].sum()
    assert abs(vt - vj) <= 1e-9 * vj
    for name in ("sum_smb", "sum_bmb", "sum_div_flux"):
        assert float(getattr(st, name)) == pytest.approx(
            float(getattr(sj, name)), rel=1e-6, abs=1e-6 * abs(float(sj.sum_smb)))
    assert float(st.sum_discharge) == pytest.approx(float(sj.sum_discharge),
                                                    rel=1e-5)


@pytest.mark.parametrize("field,tol", [
    ("ice_thickness", 5e-7), ("ice_surface_elevation", 5e-7),
    ("ice_area_specific_volume", 5e-7), ("cell_grounded_fraction", 5e-7),
    ("enthalpy", 5e-7), ("tillwat", 5e-7), ("snow_depth", 5e-7),
    ("firn_depth", 5e-7), ("u_ssa", 5e-2), ("v_ssa", 5e-2),
])
def test_fields_agree(chain, field, tol):
    (a, _, _), (b, _, _) = chain["jax"], chain["torch"]
    assert np.all(np.isfinite(b[field]))
    if np.abs(a[field]).max() == 0.0:
        assert np.abs(b[field]).max() == 0.0
    else:
        assert _rel(b[field], a[field]) <= tol


def test_masks_equal(chain):
    (a, _, _), (b, _, _) = chain["jax"], chain["torch"]
    np.testing.assert_array_equal(b["cell_type"], a["cell_type"])
    np.testing.assert_array_equal(b["bed_elevation"], a["bed_elevation"])
