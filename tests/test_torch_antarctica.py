"""The PISM-PIK Antarctic chain: ``setups.antarctica_pik_model`` against
the chain of the JAX package's ``examples/antarctica_pik.py`` on the CPU in
float64, at 200 km (21 x 21) with Mz = 11; the JAX model steps on the host
(``runtime.device_loop = False``). Both build the same initial state
(equal to the bit). As in ``tests/test_torch_hybrid_chain.py``, the
enthalpies the bootstrap put exactly at the pressure-melting value are
moved 1 J/kg below it before the runs (the JAX package decides those ties
at random under ``jit``).

- One step (a 1 a segment from t = 9.5 a, so that it crosses the
  Lingle-Clark update at 10 a): the stress balance (the first SSA solve,
  from equal states), energy, ten mass substeps each with PICO, calving and
  the bed solve. Measured: H, Href, E, the bed and the viscous
  displacement within 1e-12 of their max, the mask equal; bounds 5e-7 (the
  hybrid chain's), velocities 1e-6.
- Three 2 a segments from t = 0 (six steps): equal step counts and dt-limit
  hits per segment. The SSA solves at 200 km stop on stagnation in both
  packages (|F|^2 ~ 1e7 x the tolerance), so from the second solve on the
  velocities differ by percents (measured 18% of max|u| after 2 a, at thin
  floating cells at the domain edge) and the trajectories separate:
  after 2 a H agrees to 2.2e-8 of max H (bound 5e-7) and the volume to
  1.8e-12 (bound 1e-9); after 6 a the volume to 8.8e-6, inside the 2e-4
  envelope of ``docs/VALIDATION.md:807-812`` the ROADMAP holds
  trajectories to.
- The front-retreat dt limit (``calving.front_retreat.use_cfl``), made to
  bind by Hayhurst calving at 1e4 times its rate (the eigen rates at
  200 km are too small to): the steps, dt-limit hits and shortest dt
  equal.

Then ``topg_to_phi``, slippery grounding lines and ``prepare_state``'s
till friction angle and ocean-kill mask against the JAX package (1e-12).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pism_tpu import Config as JConfig, Grid as JGrid
from pism_tpu import state as JS
from pism_tpu.coupler.atmosphere import Uniform as JAtmUniform
from pism_tpu.coupler.pico import Pico as JPico
from pism_tpu.coupler.surface import PIK as JSurfacePIK
from pism_tpu.model.icemodel import IceModel as JIceModel
from pism_tpu_torch import setups
from pism_tpu_torch.convert import state_from_numpy, state_to_numpy

torch.set_num_threads(2)

SPY = 3.15569259747e7
KM, MZ = 200.0, 11


def jax_chain(extra=None):
    """The JAX example's chain (``examples/antarctica_pik.py:61-117``) at
    KM with MZ levels, stepping on the host."""
    dx = KM * 1e3
    L = 2000e3
    Mx = int(2 * L / dx) + 1
    grid = JGrid(Mx=Mx, My=Mx, Lx=L, Ly=L, Mz=MZ, Lz=5000.0)
    cfg = JConfig(dict(setups.ANTARCTICA_PIK_CFG, **{
        "runtime.float_dtype": "float64", "runtime.device_loop": False},
        **(extra or {})))
    H, bed, lat = setups.antarctic_geometry(grid)
    surface = JSurfacePIK(
        atmosphere=JAtmUniform(temperature=248.0, precipitation=0.25 / SPY),
        latitude=jnp.asarray(lat))
    ocean = JPico(temperature_ocean=jnp.full(grid.shape2, 271.45),
                  salinity_ocean=jnp.full(grid.shape2, 34.65),
                  config=cfg, grid=grid)
    model = JIceModel(grid=grid, config=cfg, surface=surface, ocean=ocean)
    state = model.prepare_state(JS.ModelState(
        geometry=JS.new_geometry(jnp.asarray(H), jnp.asarray(bed))))
    return model, state


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
    return JS.ModelState(geometry=geom, **{
        k: jnp.asarray(v) for k, v in d.items() if k not in names})


def untie(d, grid, EC):
    """Move enthalpies that sit exactly at E_s(p) 1 J/kg below it."""
    H = torch.tensor(d["ice_thickness"])
    z = torch.as_tensor(grid.z)
    Es = EC.enthalpy_cts(EC.pressure(torch.clamp(H[..., None] - z,
                                                 min=0.0))).numpy()
    tie = np.abs(d["enthalpy"] - Es) <= 1e-9 * np.abs(Es)
    return dict(d, enthalpy=np.where(tie, d["enthalpy"] - 1.0,
                                     d["enthalpy"])), int(tie.sum())


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _volume_rel(a, b):
    return abs(a["ice_thickness"].sum() - b["ice_thickness"].sum()) \
        / b["ice_thickness"].sum()


@pytest.fixture(scope="module")
def chain():
    jm, js = jax_chain()
    tm, ts, grid = setups.antarctica_pik_model("float64", km=KM,
                                               device="cpu", Mz=MZ)
    d0 = (jax_to_numpy(js), state_to_numpy(ts))
    d, n_ties = untie(d0[0], grid, tm.EC)
    out = {"d0": d0, "n_ties": n_ties, "grid": grid}
    # one step across the Lingle-Clark update at 10 a
    t0 = 9.5 * SPY
    j1, jt1, jst1 = jm.step_once(numpy_to_jax(d), t0, SPY)
    t1, tt1, tst1 = tm.step_once(state_from_numpy(d, device="cpu"), t0, SPY)
    out["step"] = ((jax_to_numpy(j1), float(jt1), jst1),
                   (state_to_numpy(t1), tt1, tst1))
    # three 2 a segments from 0
    js, ts, tj, tt, segs = numpy_to_jax(d), state_from_numpy(
        d, device="cpu"), 0.0, 0.0, []
    for _ in range(3):
        js, tj, sj = jm.step_once(js, tj, 2.0 * SPY)
        ts, tt, st = tm.step_once(ts, tt, 2.0 * SPY)
        segs.append(((jax_to_numpy(js), float(tj), sj),
                     (state_to_numpy(ts), tt, st)))
    out["segments"] = segs
    return out


def test_initial_states_equal(chain):
    a, b = chain["d0"]
    assert sorted(a) == sorted(b) and "bed_uplift" in b
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert chain["n_ties"] > 0


def test_one_step_matches(chain):
    (a, ta, sa), (b, tb, sb) = chain["step"]
    assert int(sa.nsteps) == sb.nsteps == 1 and tb == pytest.approx(ta)
    assert sa.limit_hits_dict() == sb.limit_hits_dict()
    np.testing.assert_array_equal(b["cell_type"], a["cell_type"])
    for name in ("ice_thickness", "ice_area_specific_volume", "enthalpy",
                 "bed_elevation", "bed_uplift", "cell_grounded_fraction"):
        assert _rel(b[name], a[name]) <= 5e-7, name
    for name in ("u_ssa", "v_ssa"):
        assert _rel(b[name], a[name]) <= 1e-6, name
    # the step crossed the bed update, and the shelves melted
    assert np.abs(b["bed_uplift"]).max() > 0.0
    for name in ("sum_bmb", "sum_smb", "sum_discharge", "sum_calving"):
        x, y = float(getattr(sb, name)), float(getattr(sa, name))
        assert abs(x - y) <= 1e-9 * max(abs(y), 1.0), name
    assert float(sb.sum_bmb) != 0.0


def test_segments_steps_and_limit_hits_equal(chain):
    for (a, ta, sa), (b, tb, sb) in chain["segments"]:
        assert int(sa.nsteps) == sb.nsteps
        assert sa.limit_hits_dict() == sb.limit_hits_dict()
        assert tb == pytest.approx(ta)


def test_segments_trajectory(chain):
    (a, _, _), (b, _, _) = chain["segments"][0]
    assert _rel(b["ice_thickness"], a["ice_thickness"]) <= 5e-7
    assert _volume_rel(b, a) <= 1e-9
    (a, _, _), (b, _, _) = chain["segments"][-1]
    assert _volume_rel(b, a) <= 2e-4
    for v in b.values():
        assert np.isfinite(v).all()
    # the chain grows shelves
    assert (b["cell_type"] == 3).sum() > 200


def test_front_retreat_limit_matches():
    over = {"calving.front_retreat.use_cfl": True,
            "calving.methods": "eigen_calving,thickness_calving,"
                               "hayhurst_calving",
            "calving.hayhurst_calving.modifier": 1.0e4}
    jm, js = jax_chain(over)
    tm, ts, grid = setups.antarctica_pik_model(
        "float64", km=KM, device="cpu", Mz=MZ, extra_cfg=over)
    d, _ = untie(jax_to_numpy(js), grid, tm.EC)
    assert tm.front_retreat_cfl
    _, tj, sj = jm.step_once(numpy_to_jax(d), 0.0, 5.0 * SPY)
    _, tt, st = tm.step_once(state_from_numpy(d, device="cpu"), 0.0,
                             5.0 * SPY)
    assert st.limit_hits_dict() == sj.limit_hits_dict()
    assert "front_retreat" in st.limit_hits_dict()
    assert st.dt_min == pytest.approx(float(sj.dt_min), rel=1e-12)


# -- the chain's basal physics and its preparation -------------------------

def _geometry_pair(seed=5):
    from pism_tpu_torch import state as TS
    grid = JGrid(Mx=21, My=21, Lx=2000e3, Ly=2000e3)
    H, bed, _ = setups.antarctic_geometry(grid)
    rng = np.random.default_rng(seed)
    tillwat = rng.uniform(0.0, 2.0, H.shape)
    jst = JS.ModelState(geometry=JS.new_geometry(jnp.asarray(H),
                                                 jnp.asarray(bed)),
                        tillwat=jnp.asarray(tillwat))
    tst = TS.ModelState(geometry=TS.new_geometry(torch.tensor(H),
                                                 torch.tensor(bed)),
                        tillwat=torch.tensor(tillwat))
    return jst, tst


@pytest.mark.parametrize("over", [
    {"basal_yield_stress.mohr_coulomb.topg_to_phi.enabled": True},
    {"basal_yield_stress.slippery_grounding_lines": True},
    {"basal_yield_stress.mohr_coulomb.topg_to_phi.enabled": True,
     "basal_yield_stress.slippery_grounding_lines": True,
     "basal_yield_stress.mohr_coulomb.topg_to_phi.topg_min": -500.0,
     "basal_yield_stress.mohr_coulomb.topg_to_phi.phi_max": 30.0},
])
def test_yield_stress_options_match(over):
    from pism_tpu.physics.basal import MohrCoulombYieldStress as JMC
    from pism_tpu_torch import Config
    from pism_tpu_torch.physics.basal import MohrCoulombYieldStress
    jst, tst = _geometry_pair()
    jy, ty = JMC(JConfig(over)), MohrCoulombYieldStress(Config(over))
    if jy.t2p_enabled:
        jphi = jy.topg_to_phi(jst.geometry.bed_elevation)
        tphi = ty.topg_to_phi(tst.geometry.bed_elevation)
        assert _rel(tphi.numpy(), np.asarray(jphi)) <= 1e-12
        jst, tst = jst.replace(till_phi=jphi), tst.replace(till_phi=tphi)
    a = ty.compute(tst).numpy()
    b = np.asarray(jy.compute(jst))
    assert _rel(a, b) <= 1e-12
    if jy.slippery_gl:
        # some grounded marine cells at the ocean lost their till drag
        plain = MohrCoulombYieldStress(Config({})).compute(tst).numpy()
        assert ((plain > 0) & (a == 0)).any()


def test_prepare_state_till_phi_and_ocean_kill_match():
    over = {"basal_yield_stress.mohr_coulomb.topg_to_phi.enabled": True,
            "calving.methods": "ocean_kill,thickness_calving",
            "bed_deformation.model": "none"}
    jm, js = jax_chain(over)
    tm, ts, _ = setups.antarctica_pik_model("float64", km=KM, device="cpu",
                                            Mz=MZ, extra_cfg=over)
    assert _rel(ts.till_phi.numpy(), np.asarray(js.till_phi)) <= 1e-12
    np.testing.assert_array_equal(tm.calving.ocean_kill_mask.numpy(),
                                  np.asarray(jm.calving.ocean_kill_mask))
    assert tm.calving.ocean_kill_mask.any()



PIK_DIAGNOSTICS = ("shelfbmassflux", "shelfbtemp", "dbdt_total",
                   "viscous_bed_displacement", "eigen_calving_rate",
                   "vonmises_calving_rate", "hayhurst_calving_rate",
                   "total_retreat_rate", "pico_box_mask",
                   "pico_temperature_box", "pico_salinity_box",
                   "pico_overturning", "pico_contshelf_mask",
                   "pico_basal_melt_rate", "pico_basal_temperature",
                   "pico_shelf_mask", "pico_basin_mask")


def test_pik_diagnostics_match():
    """The spatial diagnostics this chain's fields feed, on its initial
    state with SSA velocities made from a seed, against the JAX package's
    registry (1e-12 of their max)."""
    import pism_tpu.model.diagnostics_ext  # noqa: F401 (registers)
    from pism_tpu.model import diagnostics as jd
    from pism_tpu_torch.model import diagnostics as td
    jm, js = jax_chain()
    tm, ts, grid = setups.antarctica_pik_model("float64", km=KM,
                                               device="cpu", Mz=MZ)
    rng = np.random.default_rng(12)
    u, v = (rng.normal(0.0, 300.0, grid.shape2) / SPY for _ in range(2))
    bed = jax_to_numpy(js)["bed_elevation"] + rng.normal(0, 5, grid.shape2)
    js = js.replace(u_ssa=jnp.asarray(u), v_ssa=jnp.asarray(v),
                    geometry=js.geometry.replace(bed_elevation=jnp.asarray(bed)))
    ts = ts.replace(u_ssa=torch.tensor(u), v_ssa=torch.tensor(v),
                    geometry=ts.geometry.replace(bed_elevation=torch.tensor(bed)))
    for name in PIK_DIAGNOSTICS:
        a = td.SPATIAL[name].func(ts, tm, 0.0).numpy().astype(np.float64)
        b = np.asarray(jd.SPATIAL[name].func(js, jm, 0.0), np.float64)
        assert a.shape == b.shape and _rel(a, b) <= 1e-12, name
        assert td.SPATIAL[name].units == jd.SPATIAL[name].units, name
    assert np.abs(td.SPATIAL["eigen_calving_rate"].func(ts, tm, 0.0)
                  .numpy()).max() > 0.0
