"""Calving and front retreat (``model/calving.py``), pism_tpu_torch against
pism_tpu on the CPU in float64, on one numpy geometry (20 x 24 cells: a
grounded island, a floating tongue with a thin front, a grounded marine
margin, a detached berg and part-grid Href in the ocean) with velocities,
hardness and Href made from a seed.

Each calving law (eigen, von Mises, Hayhurst; eigen with
``make_margin_floating``), with part-grid and with the thickness-scaling
fallback; float kill with both tails (``margin_only``,
``calve_near_grounding_line``); thickness and ocean-kill calving; the
part-grid retreat alone; the front-retreat dt limit; and the
per-mechanism parts: all to 1e-12 relative.
"""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pism_tpu import Config as JConfig, Grid as JGrid
from pism_tpu import state as JS
from pism_tpu.model import calving as j_calv
from pism_tpu_torch import Config, Grid
from pism_tpu_torch import state as TS
from pism_tpu_torch.model import calving as t_calv

torch.set_num_threads(2)

SPY = 3.15569259747e7
GRID = dict(Mx=24, My=20, Lx=115e3, Ly=95e3)
RTOL = 1e-12
DT = 0.7 * SPY


class SB(NamedTuple):
    u_ssa: object
    v_ssa: object


def _inputs(seed=11):
    H = np.zeros((20, 24))
    bed = np.full(H.shape, -800.0)
    bed[4:16, 3:10] = 200.0
    H[4:16, 3:10] = 900.0          # grounded island
    H[6:14, 10:15] = 300.0         # floating tongue
    H[8:12, 15] = 30.0             # thin floating front
    H[2:4, 18:21] = 200.0          # detached floating berg
    bed[15:18, 10:14] = -150.0
    H[15:18, 10:14] = 400.0        # grounded marine margin
    rng = np.random.default_rng(seed)
    H = np.where(H > 0, H * (1 + 0.1 * rng.uniform(-1, 1, H.shape)), 0.0)
    jgeom = JS.new_geometry(jnp.asarray(H), jnp.asarray(bed), subgl=True)
    ocean = np.asarray(jgeom.cell_type) == JS.MASK_ICE_FREE_OCEAN
    Href = np.where(ocean, rng.uniform(0.0, 60.0, H.shape), 0.0) \
        * (rng.uniform(size=H.shape) < 0.3)
    geom = {k: np.asarray(getattr(jgeom, k))
            for k in JS.Geometry.__dataclass_fields__}
    geom["ice_area_specific_volume"] = Href
    u = rng.normal(0.0, 300.0, H.shape) / SPY + 500.0 / SPY
    v = rng.normal(0.0, 300.0, H.shape) / SPY
    B = rng.uniform(1e8, 2e8, H.shape)
    return geom, u, v, B


def _jgeom(g):
    return JS.Geometry(**{k: jnp.asarray(v) for k, v in g.items()})


def _tgeom(g):
    return TS.Geometry(**{k: torch.tensor(v) for k, v in g.items()})


def _close(got, want, name):
    g = got.numpy() if torch.is_tensor(got) else np.asarray(got, float)
    w = np.asarray(want, np.float64)
    assert g.shape == w.shape, name
    scale = max(np.abs(w).max(), 1e-300)
    err = np.abs(g - w).max()
    assert err <= RTOL * scale, f"{name}: {err:.3e} > {RTOL:.0e} * {scale:.3e}"


def _models(over, ocean_kill=None):
    cfg = dict({"runtime.float_dtype": "float64",
                "geometry.part_grid.enabled": True,
                "geometry.remove_icebergs": True,
                "calving.eigen_calving.K": 3.0e16}, **over)
    jm = j_calv.CalvingModel(
        grid=JGrid(**GRID), config=JConfig(cfg),
        ocean_kill_mask=None if ocean_kill is None else jnp.asarray(ocean_kill))
    tm = t_calv.CalvingModel(
        grid=Grid(**GRID), config=Config(cfg),
        ocean_kill_mask=None if ocean_kill is None
        else torch.tensor(ocean_kill))
    return jm, tm


LAWS = [
    {"calving.methods": "eigen_calving"},
    {"calving.methods": "eigen_calving,thickness_calving",
     "calving.thickness_calving.threshold": 150.0},
    {"calving.methods": "eigen_calving",
     "calving.eigen_calving.make_margin_floating": True},
    {"calving.methods": "vonmises_calving"},
    {"calving.methods": "hayhurst_calving"},
    {"calving.methods": "eigen_calving,vonmises_calving,hayhurst_calving"},
    {"calving.methods": "eigen_calving,vonmises_calving",
     "geometry.part_grid.enabled": False},
    {"calving.methods": "hayhurst_calving",
     "geometry.part_grid.enabled": False},
    {"calving.methods": "float_kill"},
    {"calving.methods": "float_kill", "calving.float_kill.margin_only": True},
    {"calving.methods": "thickness_calving",
     "calving.float_kill.enabled": True,
     "calving.float_kill.calve_near_grounding_line": False},
    {"calving.methods": "float_kill", "calving.float_kill.margin_only": True,
     "calving.float_kill.calve_near_grounding_line": False},
    {"calving.methods": "ocean_kill,thickness_calving"},
]


@pytest.mark.parametrize("over", LAWS)
def test_calving_step_matches(over):
    geom, u, v, B = _inputs()
    okm = None
    if "ocean_kill" in over["calving.methods"]:
        okm = np.zeros(u.shape, bool)
        okm[6:14, 13:16] = True
    jm, tm = _models(over, okm)
    jout, jparts = jm.step(_jgeom(geom), SB(jnp.asarray(u), jnp.asarray(v)),
                           DT, t=3.0 * SPY, hardness_B=jnp.asarray(B),
                           with_parts=True)
    tout, tparts = tm.step(_tgeom(geom), SB(torch.tensor(u), torch.tensor(v)),
                           DT, t=3.0 * SPY, hardness_B=torch.tensor(B),
                           with_parts=True)
    for name in ("ice_thickness", "ice_area_specific_volume"):
        _close(getattr(tout, name), getattr(jout, name), name)
    for k in ("calving", "frontal_melt", "forced_retreat"):
        _close(tparts[k], jparts[k], k)
    # something calved
    assert float(tparts["calving"].sum()) < 0.0


@pytest.mark.parametrize("methods", ["eigen_calving", "vonmises_calving",
                                     "hayhurst_calving",
                                     "eigen_calving,hayhurst_calving"])
def test_rates_and_max_timestep_match(methods):
    geom, u, v, B = _inputs()
    jm, tm = _models({"calving.methods": methods})
    jsb, tsb = SB(jnp.asarray(u), jnp.asarray(v)), \
        SB(torch.tensor(u), torch.tensor(v))
    _close(tm.retreat_rate(_tgeom(geom), tsb.u_ssa, tsb.v_ssa,
                           torch.tensor(B)),
           jm.retreat_rate(_jgeom(geom), jsb.u_ssa, jsb.v_ssa,
                           jnp.asarray(B)), "retreat_rate")
    jr = jm.applicable_rate(_jgeom(geom), jsb, hardness_B=jnp.asarray(B))
    _close(tm.applicable_rate(_tgeom(geom), tsb, torch.tensor(B)), jr,
           "applicable_rate")
    jdt = float(jm.max_timestep(_jgeom(geom), jsb, hardness_B=jnp.asarray(B)))
    tdt = _port_max_timestep(tm, geom, tsb, torch.tensor(B))
    assert np.isfinite(jdt) and tdt == pytest.approx(jdt, rel=RTOL)


def _port_max_timestep(tm, geom, sb, B=None):
    """The port's front-retreat dt limit as ``IceModel`` forms it: the max
    rate on the device, the dt on the host."""
    r = float(tm.max_rate(_tgeom(geom), sb, B))
    return tm.max_timestep_from_rate(r, torch.float64)


def test_max_timestep_without_retreat_is_inf():
    geom, u, v, _ = _inputs()
    jm, tm = _models({"calving.methods": "eigen_calving"})
    z = np.zeros_like(u)
    assert float(jm.max_timestep(_jgeom(geom), SB(jnp.asarray(z),
                                                  jnp.asarray(z)))) == np.inf
    assert _port_max_timestep(tm, geom, SB(torch.tensor(z),
                                           torch.tensor(z))) == np.inf


def test_strain_eigenvalues_and_hayhurst_rate_match():
    geom, u, v, _ = _inputs()
    jm, tm = _models({"calving.methods": "hayhurst_calving"})
    for a, b in zip(tm._strain_eigenvalues(torch.tensor(u), torch.tensor(v)),
                    jm._strain_eigenvalues(jnp.asarray(u), jnp.asarray(v))):
        _close(a, b, "eigenvalue")
    _close(tm.hayhurst_rate(_tgeom(geom)), jm.hayhurst_rate(_jgeom(geom)),
           "hayhurst")


def test_retreat_partgrid_matches():
    geom, u, v, B = _inputs()
    jm, tm = _models({"calving.methods": "eigen_calving"})
    rng = np.random.default_rng(4)
    rate = rng.uniform(0.0, 3e-4, u.shape)
    mask = geom["cell_type"]
    icy = (mask == 2) | (mask == 3)
    ifo = mask == 4
    H, Href = geom["ice_thickness"], geom["ice_area_specific_volume"]
    jo = jm._retreat_partgrid(jnp.asarray(H), jnp.asarray(Href),
                              jnp.asarray(rate), DT, jnp.asarray(icy),
                              jnp.asarray(ifo))
    to = tm._retreat_partgrid(torch.tensor(H), torch.tensor(Href),
                              torch.tensor(rate), DT, torch.tensor(icy),
                              torch.tensor(ifo))
    for name, a, b in zip(("H", "Href", "removed"), to, jo):
        _close(a, b, name)
    assert float(to[2].max()) > 0.0


@pytest.mark.parametrize("methods", ["prescribed_retreat",
                                     "eigen_calving,no_such_law"])
def test_unported_methods_raise(methods):
    """A law neither package has is refused; prescribed retreat without
    its file raises the JAX package's ValueError."""
    exc = ValueError if methods == "prescribed_retreat" \
        else NotImplementedError
    with pytest.raises(exc):
        t_calv.CalvingModel(grid=Grid(**GRID), config=Config(
            {"calving.methods": methods}))
