"""One SSAFD.solve of pism_tpu_torch against pism_tpu's in float64 on the
100 km hybrid-chain state, cold (zero initial velocity, Picard warmup) and
warm (a converged velocity after a perturbation of the geometry).

Tolerances. The Newton sweep counts are equal. The Krylov totals and the
velocities are held to looser bounds than equality and 1e-6 of max|u|,
because the solve itself amplifies rounding: perturbing tau_c by 1e-15
relative moves the cold solution by 1.0e-5 to 1.5e-5 of max|u| and its
Krylov total by 2 of 81. The two packages sum their dot products in a
different order, and measured 3.5e-5 (cold) and 4.3e-5 (warm) of max|u|
apart, with Krylov totals 81/84 and 99/101. The bounds are 1e-4 of max|u|
and 10% of the Krylov total.
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
from pism_tpu_torch.convert import state_from_numpy  # noqa: E402


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


@pytest.fixture(scope="module")
def models():
    jm, js, _ = bench.hybrid_greenland_model("float64", km=100)
    tm, _, grid = setups.hybrid_greenland_model("float64", km=100,
                                                 device="cpu")
    return jm, tm, grid, jax_to_numpy(js)


def _solve_both(models, d):
    jm, tm, _, _ = models
    js, ts = numpy_to_jax(d), state_from_numpy(d, device="cpu")
    ju, jv, ji = jm.ssa.solve(js, jm.yield_stress.compute(js),
                              diagnostics=True)
    tu, tv, ti = tm.ssa.solve(ts, tm.yield_stress.compute(ts),
                              diagnostics=True)
    return (np.asarray(ju), np.asarray(jv), ji), (tu.numpy(), tv.numpy(), ti)


def _compare(j, t, u_tol, krylov_tol):
    (ju, jv, ji), (tu, tv, ti) = j, t
    assert ti["newton_iters"] == int(ji["newton_iters"])
    assert bool(ti["warmup_skipped"]) == bool(ji["warmup_skipped"])
    kj = int(ji["krylov_iters"])
    assert abs(ti["krylov_iters"] - kj) <= krylov_tol * kj
    scale = max(np.abs(ju).max(), np.abs(jv).max())
    assert np.abs(tu - ju).max() <= u_tol * scale
    assert np.abs(tv - jv).max() <= u_tol * scale
    assert np.isclose(float(ti["b_norm2"]), float(ji["b_norm2"]), rtol=1e-12)


def test_cold_solve(models):
    d = dict(models[3])
    j, t = _solve_both(models, d)
    assert not bool(j[2]["warmup_skipped"])
    _compare(j, t, u_tol=1e-4, krylov_tol=0.10)


def test_warm_solve(models):
    jm, _, grid, d0 = models
    j0, _ = _solve_both(models, dict(d0))
    d = dict(d0)
    X, Y = np.meshgrid(grid.x, grid.y)
    H = d0["ice_thickness"] * (1.0 + 0.01 * np.sin(X / 200e3) * np.cos(Y / 300e3))
    geom = JS.ensure_consistency(
        JS.Geometry(**{k: jnp.asarray(d0[k]) for k in
                       (f.name for f in dataclasses.fields(JS.Geometry))}
                    ).replace(ice_thickness=jnp.asarray(H)),
        910.0, 1028.0, 0.01, True)
    d.update({f.name: np.asarray(getattr(geom, f.name))
              for f in dataclasses.fields(JS.Geometry)})
    d["u_ssa"], d["v_ssa"] = j0[0], j0[1]
    j, t = _solve_both(models, d)
    assert bool(j[2]["warmup_skipped"])
    _compare(j, t, u_tol=1e-4, krylov_tol=0.10)
