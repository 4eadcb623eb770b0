"""The ensemble (BASELINE config 5), pism_tpu_torch against pism_tpu on the
CPU: ``parallel.ensemble.EnsembleRunner`` against the JAX package's
``EnsembleRunner`` (``jax.vmap`` over its device loop), each member
against a run of it alone, the SIA kernels' plain versions on a member
axis, the ensemble mesh and what an ensemble refuses.

Tolerances. The Halfar B ensemble (the JAX ``tests/test_ensemble.py``
case, isothermal plain SIA, float64): equal steps and dt-limit hits per
member, H within 1e-12 of max H. The paleo ensemble at 100 km (thermo
SIA, Haseloff gradients and the bed smoother, float64; enthalpies tied at
E_s moved 1 J/kg below it first, as in ``tests/test_torch_hybrid_chain.py``,
because the JAX package decides those ties at random under ``jit``): equal
steps and hits, H and E within 1e-10 relative. A member against its solo
run in the port, and the plain K3 and K4 on a member axis against
per-member calls: equal to the bit on the CPU (the same operations on the
same values; reductions are per member and only feed the statistics).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu import Config as JConfig, Grid as JGrid  # noqa: E402
from pism_tpu import state as JS  # noqa: E402
from pism_tpu.coupler.surface import FunctionSurface as JFunctionSurface  # noqa: E402
from pism_tpu.model.icemodel import IceModel as JIceModel  # noqa: E402
from pism_tpu.parallel import ensemble as j_ens  # noqa: E402
from pism_tpu.verification import halfar as j_halfar  # noqa: E402
import pism_tpu_torch as pt  # noqa: E402
from pism_tpu_torch import setups  # noqa: E402
from pism_tpu_torch import state as S  # noqa: E402
from pism_tpu_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402
from pism_tpu_torch.coupler.surface import FunctionSurface, Uniform  # noqa: E402
from pism_tpu_torch.model.icemodel import IceModel  # noqa: E402
from pism_tpu_torch.ops import stencils as st  # noqa: E402
from pism_tpu_torch.ops.kernels import sia_iso as K4  # noqa: E402
from pism_tpu_torch.ops.kernels import sia_thermo as K3  # noqa: E402
from pism_tpu_torch.parallel import make_mesh  # noqa: E402
from pism_tpu_torch.parallel.ensemble import (  # noqa: E402
    EnsembleRunner, broadcast_state, member, stack_states)
from pism_tpu_torch.physics.enthalpy_converter import EnthalpyConverter  # noqa: E402
from pism_tpu_torch.physics.rheology import GPBLD  # noqa: E402
from pism_tpu_torch.verification import halfar  # noqa: E402

SPY = 3.15569259747e7
SCALES = (0.0, 1.0, 2.0)
HALFAR_YEARS = 50.0
# the paleo ensemble at 100 km: 4 members over 300 a (50 a is one step
# there: the limits allow more than the segment)
PALEO_MEMBERS, PALEO_KM, PALEO_MZ, PALEO_YEARS = 4, 100.0, 11, 300.0


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


# -- the Halfar B ensemble (the JAX test's case) -----------------------------

def _halfar_cfg():
    return {"stress_balance.model": "sia",
            "stress_balance.sia.flow_law": "isothermal_glen",
            "flow_law.isothermal_Glen.ice_softness": halfar.A_SOFTNESS,
            "energy.model": "none"}


def _t_halfar_smb(geometry, t):
    # the member's SMB scale rides in on Href, as in the JAX test
    scale = geometry.ice_area_specific_volume[0, 0]
    m = scale * 0.3 / SPY * torch.ones_like(geometry.ice_thickness)
    return m, torch.full_like(geometry.ice_thickness, 253.15)


def _j_halfar_smb(geometry, t):
    scale = geometry.ice_area_specific_volume[0, 0]
    m = scale * 0.3 / SPY * jnp.ones_like(geometry.ice_thickness)
    return m, jnp.full(geometry.ice_thickness.shape, 253.15)


def _t_halfar(Mx=31):
    sol = halfar.test_B()
    grid = pt.Grid(Mx=Mx, My=Mx, Lx=900e3, Ly=900e3)
    model = IceModel(grid=grid, config=pt.Config(_halfar_cfg()),
                     surface=FunctionSurface(_t_halfar_smb), device="cpu")
    H0 = torch.tensor(sol.thickness(sol.t0, grid.radius))
    members = [model.prepare_state(S.ModelState(geometry=S.new_geometry(
        H0, torch.zeros_like(H0), Href=torch.full_like(H0, s))))
        for s in SCALES]
    return model, members, sol


@pytest.fixture(scope="module")
def halfar_runs():
    model, members, sol = _t_halfar()
    t_end = sol.t0 + HALFAR_YEARS * SPY
    out, stats = EnsembleRunner(model).run_segment(stack_states(members),
                                                  sol.t0, t_end)
    grid = JGrid(Mx=31, My=31, Lx=900e3, Ly=900e3)
    jm = JIceModel(grid=grid, config=JConfig(_halfar_cfg()),
                   surface=JFunctionSurface(_j_halfar_smb))
    H0 = jnp.asarray(sol.thickness(sol.t0, grid.radius))
    jmembers = [jm.prepare_state(JS.ModelState(geometry=JS.new_geometry(
        H0, jnp.zeros(grid.shape2), Href=jnp.full(grid.shape2, s))))
        for s in SCALES]
    jout, jstats = j_ens.EnsembleRunner(model=jm).run_segment(
        j_ens.stack_states(jmembers), sol.t0, t_end)
    return dict(model=model, members=members, sol=sol, t_end=t_end,
                out=out, stats=stats, H0=H0,
                jH=np.asarray(jout.geometry.ice_thickness), jstats=jstats)


def test_halfar_ensemble_matches_jax(halfar_runs):
    r = halfar_runs
    H = r["out"].geometry.ice_thickness.numpy()
    for b, st_ in enumerate(r["stats"]):
        assert st_.nsteps == int(r["jstats"].nsteps[b]) > 1
        hits = np.asarray(r["jstats"].limit_hits)[b]
        assert st_.limit_hits == [int(h) for h in hits]
        assert _rel(H[b], r["jH"][b]) <= 1e-12


def test_halfar_ensemble_members_diverge(halfar_runs):
    """The JAX test's checks: more accumulation, more volume; the member
    with no SMB keeps its volume."""
    V = halfar_runs["out"].geometry.ice_thickness.sum(dim=(1, 2)).numpy()
    assert V[2] > V[1] > V[0]
    V0 = float(np.sum(np.asarray(halfar_runs["H0"])))
    assert abs(V[0] - V0) / V0 < 1e-12


# -- the paleo ensemble ------------------------------------------------------

def _jax_paleo_model():
    """The JAX example's model (``examples/paleo_ensemble.py:56-93``) at
    100 km with the test's Mz, float64."""
    L = 800e3
    Mx = int(2 * L / (PALEO_KM * 1e3)) + 1
    grid = JGrid(Mx=Mx, My=Mx, Lx=L, Ly=L, Mz=PALEO_MZ, Lz=4000.0)
    cfg = JConfig({"stress_balance.model": "sia", "energy.model": "enthalpy",
                   "runtime.float_dtype": "float64"})

    def smb_fn(geometry, t):
        dT = geometry.ice_area_specific_volume[0, 0]
        h = geometry.ice_surface_elevation
        T = 248.0 - 6.0e-3 * h + dT
        precip = 0.35 / SPY * jnp.exp(0.07 * dT)
        melt = 1.0e-9 * jnp.maximum(T - 263.15, 0.0)
        smb = precip - melt
        return (jnp.broadcast_to(smb, h.shape),
                jnp.broadcast_to(jnp.minimum(T, 273.15), h.shape))

    X, Y = np.meshgrid(grid.x, grid.y)
    r = np.sqrt(X ** 2 + Y ** 2)
    H0 = np.where(r < 500e3, 2500.0 * (1 - (r / 600e3) ** 2), 0.0).clip(0)
    bed = 100.0 - 300.0 * (r / 800e3) ** 2
    model = JIceModel(grid=grid, config=cfg,
                      surface=JFunctionSurface(fn=smb_fn))
    state0 = model.prepare_state(JS.ModelState(geometry=JS.new_geometry(
        jnp.asarray(H0), jnp.asarray(bed))))
    return model, state0


def _jax_to_numpy(st_):
    d = {f.name: np.asarray(getattr(st_.geometry, f.name))
         for f in dataclasses.fields(st_.geometry)}
    for f in dataclasses.fields(st_):
        v = getattr(st_, f.name)
        if f.name != "geometry" and v is not None:
            d[f.name] = np.asarray(v)
    return d


def _numpy_to_jax(d):
    names = {f.name for f in dataclasses.fields(JS.Geometry)}
    geom = JS.Geometry(**{k: jnp.asarray(d[k]) for k in names})
    return JS.ModelState(geometry=geom, **{
        k: jnp.asarray(v) for k, v in d.items() if k not in names})


def _break_ties(d, grid, EC):
    """Move enthalpies that sit exactly at E_s(p) 1 J/kg below it."""
    H = torch.tensor(d["ice_thickness"])
    z = torch.as_tensor(grid.z)
    Es = EC.enthalpy_cts(EC.pressure(torch.clamp(H[..., None] - z, min=0.0)))
    E = d["enthalpy"]
    tie = np.abs(E - Es.numpy()) <= 1e-9 * np.abs(Es.numpy())
    return dict(d, enthalpy=np.where(tie, E - 1.0, E)), int(tie.sum())


@pytest.fixture(scope="module")
def paleo_runs():
    model, batched, grid, dT = setups.paleo_ensemble_model(
        PALEO_MEMBERS, PALEO_KM, device="cpu", Mz=PALEO_MZ)
    jm, jstate0 = _jax_paleo_model()
    d0 = _jax_to_numpy(jstate0)
    same_start = all(np.array_equal(state_to_numpy(member(batched, 0))[k],
                                    v) for k, v in d0.items()
                     if k != "ice_area_specific_volume")
    d, n_ties = _break_ties(state_to_numpy(batched), grid, model.EC)
    t_end = PALEO_YEARS * SPY
    out, stats = EnsembleRunner(model).run_segment(
        state_from_numpy(d, device="cpu"), 0.0, t_end)
    jout, jstats = j_ens.EnsembleRunner(model=jm).run_segment(
        _numpy_to_jax(d), 0.0, t_end)
    return dict(model=model, d=d, n_ties=n_ties, same_start=same_start,
                out=state_to_numpy(out), stats=stats,
                jout=_jax_to_numpy(jout), jstats=jstats, t_end=t_end, dT=dT,
                grid=grid)


def test_paleo_initial_state_is_the_jax_examples(paleo_runs):
    assert paleo_runs["same_start"]
    assert paleo_runs["n_ties"] > 0
    Href = paleo_runs["d"]["ice_area_specific_volume"]
    np.testing.assert_array_equal(Href[:, 3, 5], paleo_runs["dT"])


def test_paleo_ensemble_matches_jax(paleo_runs):
    r = paleo_runs
    for b, st_ in enumerate(r["stats"]):
        assert st_.nsteps == int(r["jstats"].nsteps[b]) > 1
        assert st_.limit_hits == [int(h) for h in
                                  np.asarray(r["jstats"].limit_hits)[b]]
    for name in ("ice_thickness", "enthalpy", "basal_melt_rate"):
        assert _rel(r["out"][name], r["jout"][name]) <= 1e-10, name
    vol = r["out"]["ice_thickness"].sum(axis=(1, 2))
    # more snow on the warmer members (exp(0.07 dT)) outweighs their melt
    assert np.corrcoef(r["dT"], vol)[0, 1] > 0.9


def test_one_host_sync_per_lockstep_step(paleo_runs):
    """The dt choice reads the device once a lockstep step, whatever the
    number of members: the segment's syncs are its lockstep steps, the
    largest member's count."""
    stats = paleo_runs["stats"]
    assert all(s.host_syncs == max(x.nsteps for x in stats) for s in stats)


@pytest.mark.parametrize("case", ["halfar", "paleo"])
def test_member_matches_its_solo_run(case, halfar_runs, paleo_runs):
    """Member b of the ensemble computes what the port's solo IceModel run
    of b computes: equal steps and dt-limit hits, H (and E) equal to the
    bit."""
    if case == "halfar":
        r = halfar_runs
        model, t0 = r["model"], r["sol"].t0
        solos = r["members"]
        H = r["out"].geometry.ice_thickness.numpy()
        E = None
    else:
        r = paleo_runs
        model, t0 = r["model"], 0.0
        batched = state_from_numpy(r["d"], device="cpu")
        solos = [member(batched, b) for b in range(PALEO_MEMBERS)]
        H, E = r["out"]["ice_thickness"], r["out"]["enthalpy"]
    for b, st0 in enumerate(solos):
        out, t, stats = model.step_once(st0, t0, r["t_end"] - t0)
        assert stats.nsteps == r["stats"][b].nsteps
        assert stats.limit_hits == r["stats"][b].limit_hits
        assert stats.dt_min == r["stats"][b].dt_min
        np.testing.assert_array_equal(out.geometry.ice_thickness.numpy(), H[b])
        if E is not None:
            np.testing.assert_array_equal(out.enthalpy.numpy(), E[b])


def test_frozen_member_keeps_its_state():
    """Members with different step counts: a member that reached its step
    bound is frozen (its state and clock stop) while the others step."""
    model, members, sol = _t_halfar(Mx=21)
    cfg = pt.Config(dict(_halfar_cfg(),
                         **{"time_stepping.max_steps_per_segment": 2}))
    model = dataclasses.replace(model, config=cfg)
    batched = stack_states(members)
    out, stats = EnsembleRunner(model).run_segment(batched, sol.t0,
                                                  sol.t0 + 1000 * SPY)
    assert [s.nsteps for s in stats] == [2, 2, 2]
    # a member that starts at its end takes no step and keeps its state
    quiet = dataclasses.replace(model, config=pt.Config(_halfar_cfg()))
    runner = EnsembleRunner(quiet)
    out, stats = runner.run_segment(batched, sol.t0, sol.t0 + 1e-7)
    assert [s.nsteps for s in stats] == [0, 0, 0]
    assert torch.equal(out.geometry.ice_thickness,
                       batched.geometry.ice_thickness)


def test_paleo_members_freeze_apart():
    """At 40 km the paleo members take different step counts (each its own
    dt); the ones done early are frozen and still match their solo runs."""
    model, batched, grid, _ = setups.paleo_ensemble_model(
        3, 40.0, device="cpu", dtype="float32")
    out, stats = EnsembleRunner(model).run_segment(batched, 0.0, 50 * SPY)
    counts = [s.nsteps for s in stats]
    assert len(set(counts)) > 1
    for b in range(3):
        solo, _, st_ = model.step_once(member(batched, b), 0.0, 50 * SPY)
        assert st_.nsteps == counts[b]
        assert torch.equal(solo.geometry.ice_thickness,
                           out.geometry.ice_thickness[b])


# -- the kernels' plain versions on a member axis ----------------------------

def _dome_members(B, My, Mx, Mz, seed):
    rng = np.random.default_rng(seed)
    Y, X = np.meshgrid(np.linspace(-1, 1, My), np.linspace(-1, 1, Mx),
                       indexing="ij")
    H = np.stack([np.maximum((2500.0 + 300.0 * b) * (1 - X ** 2 - Y ** 2), 0.0)
                  for b in range(B)])
    s = H + rng.uniform(0.0, 5.0, size=H.shape) * (H > 0)
    E = 1.0e5 + rng.uniform(0.0, 8e4, size=(B, My, Mx, Mz))
    return H, s, E


@pytest.mark.parametrize("layout", ["contiguous", "level-major"])
def test_plain_K3_on_a_member_axis_equals_member_calls(layout):
    B, My, Mx, Mz = 3, 13, 11, 7
    H, s, E = (torch.tensor(a) for a in _dome_members(B, My, Mx, Mz, 5))
    if layout == "level-major":
        E = E.movedim(-1, 0).contiguous().movedim(0, -1)
    z = torch.as_tensor(pt.Grid(Mx=Mx, My=My, Lx=1e5, Ly=1e5, Mz=Mz,
                                Lz=4000.0).z)
    EC = EnthalpyConverter()
    kw = dict(dx=20e3, dy=25e3, EC=EC, pb_law=GPBLD(EC=EC), d_cap=50.0)
    got = K3.sia_flux_thermo(H, s, E, z, **kw)
    assert got[4].shape == (B,)
    for b in range(B):
        one = K3.sia_flux_thermo(H[b], s[b], E[b], z, **kw)
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)
    faces = K3.sia_flux_thermo_faces(H, s, E, z, **kw)
    for f, g in zip(faces, (got[2], got[3], got[0], got[1])):
        assert torch.equal(f, g)


@pytest.mark.parametrize("d_cap", [None, 0.5])
def test_plain_K4_on_a_member_axis_equals_member_calls(d_cap):
    B, My, Mx = 4, 17, 19
    H, s, _ = (torch.tensor(a) for a in _dome_members(B, My, Mx, 1, 6))
    kw = dict(A=halfar.A_SOFTNESS, dx=3e3, dy=3e3, d_cap=d_cap)
    got = K4.sia_flux(H, s, **kw)
    assert got[4].shape == (B,)
    for b in range(B):
        one = K4.sia_flux(H[b], s[b], **kw)
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)
    with pytest.raises(ValueError):
        K4.sia_flux(H, s[:-1], **kw)


def test_kernel_routes_take_the_member_axis():
    """``diffusivity`` on a member axis routes as one member does, and each
    member's flux is its own."""
    from pism_tpu_torch.ops import sia as t_sia
    from pism_tpu_torch.physics.rheology import IsothermalGlen
    B, My, Mx = 3, 15, 13
    H, s, _ = (torch.tensor(a) for a in _dome_members(B, My, Mx, 1, 7))
    grid = pt.Grid(Mx=Mx, My=My, Lx=900e3, Ly=900e3)
    law = IsothermalGlen(A=halfar.A_SOFTNESS)
    geom = S.new_geometry(H, s - H)
    for pallas in (True, False):
        got = t_sia.diffusivity(law, geom, None, grid, st.Shifter(grid, 1),
                                pallas=pallas, gradient_method="mahaffy")
        assert got.max_D.shape == (B,)
        for b in range(B):
            one = t_sia.diffusivity(law, S.new_geometry(H[b], s[b] - H[b]),
                                    None, grid, st.Shifter(grid),
                                    pallas=pallas, gradient_method="mahaffy")
            for g, o in zip(got, one):
                assert torch.equal(g[b], o)


# -- stencils, state and surface on a member axis -----------------------------

@pytest.mark.parametrize("periodic", [False, True])
def test_shifts_and_ghosts_take_the_member_dims(periodic):
    rng = np.random.default_rng(8)
    a = torch.tensor(rng.normal(size=(3, 5, 4, 6)))   # (B, My, Mx, Mz)
    for jy, ix in ((1, 0), (-1, 1), (0, -2)):
        got = st.shift(a, jy, ix, periodic, periodic, lead=1)
        for b in range(3):
            assert torch.equal(got[b], st.shift(a[b], jy, ix, periodic,
                                                periodic))
    got = st.pad_ghosts(a, 2, periodic, periodic, lead=1)
    for b in range(3):
        assert torch.equal(got[b], st.pad_ghosts(a[b], 2, periodic, periodic))


def test_ensure_consistency_per_member():
    rng = np.random.default_rng(9)
    H = torch.tensor(rng.uniform(0.0, 800.0, size=(3, 9, 8)))
    b = torch.tensor(rng.uniform(-900.0, 300.0, size=(3, 9, 8)))
    g = S.ensure_consistency(S.new_geometry(H, b), 910.0, 1028.0, 0.01,
                             True, lead=1)
    for m in range(3):
        one = S.ensure_consistency(S.new_geometry(H[m], b[m]), 910.0, 1028.0,
                                   0.01, True)
        for f in dataclasses.fields(S.Geometry):
            assert torch.equal(getattr(g, f.name)[m], getattr(one, f.name))
    assert torch.equal(S.member_sum(H, 1), torch.stack([x.sum() for x in H]))
    assert torch.equal(S.member_max(H, 1), torch.stack([x.max() for x in H]))


def test_surface_members_see_one_member_each():
    H = torch.rand(3, 6, 5, dtype=torch.float64) * 2000.0
    g = S.new_geometry(H, torch.zeros_like(H)).replace(
        ice_area_specific_volume=torch.tensor([-8.0, -2.0, 4.0],
                                              dtype=torch.float64)[:, None, None]
        .expand(3, 6, 5).contiguous())
    t = torch.tensor([0.0, 1e9, 2e9], dtype=torch.float64)
    out = FunctionSurface(setups.paleo_smb).members(g, t)
    for b in range(3):
        one = FunctionSurface(setups.paleo_smb)(member(S.ModelState(g), b)
                                                .geometry, float(t[b]))
        assert torch.equal(out.smb[b], one.smb)
        assert torch.equal(out.temperature[b], one.temperature)
    assert torch.equal(Uniform(smb=1e-9).members(g, t).smb,
                       torch.full_like(H, 1e-9))


# -- the ensemble mesh and what an ensemble refuses ---------------------------

def test_ensemble_sharded_over_mesh():
    """The JAX test: identical members on an ensemble axis of 8 devices
    stay identical; one device (the CPU, here eight times) is one batch."""
    model, members, sol = _t_halfar(Mx=16)
    model = dataclasses.replace(model, surface=Uniform(smb=0.0))
    batched = broadcast_state(members[0], 8)
    mesh = make_mesh(["cpu"] * 8, ensemble=8)
    assert mesh.axis_names == ("e", "y", "x")
    assert mesh.shape == {"e": 8, "y": 1, "x": 1}
    runner = EnsembleRunner(model)
    sharded = runner.shard(batched, mesh)
    assert isinstance(sharded, S.ModelState)
    out, stats = runner.run_segment(sharded, sol.t0, sol.t0 + 20 * SPY)
    H = out.geometry.ice_thickness
    assert H.shape[0] == 8
    for b in range(1, 8):
        assert torch.equal(H[0], H[b])
    with pytest.raises(NotImplementedError):
        make_mesh(["cpu"] * 8, (2, 2), ensemble=2)
    with pytest.raises(NotImplementedError):
        runner.shard(batched, make_mesh(["cpu"] * 4, (2, 2)))


_REFUSED = ({"mesh": (2, 2)},
            {"sea_level": 0.0},
            {"bed_deformation.model": "iso"},
            {"calving.methods": "vonmises_calving,thickness_calving"},
            {"calving.methods": "hayhurst_calving"},
            {"calving.float_kill.enabled": True})


@pytest.mark.parametrize("chain, extra", [
    pytest.param(chain, extra,
                 id=f"extra{i}" if chain == "hybrid" else f"pik-extra{i}")
    for chain in ("hybrid", "pik") for i, extra in enumerate(_REFUSED)])
def test_ensemble_refuses_what_it_cannot_run(chain, extra):
    """The hybrid and the PISM-PIK chains' ensembles take their own
    components (the next test; PICO, the PIK ocean, eigen calving and
    Lingle-Clark are tests/test_torch_pik_ensemble.py's); a mesh, sea level,
    pointwise isostasy, von Mises and Hayhurst calving and float kill are
    not ported to the member axis and raise, on either chain (the PIK one
    from its data file at 200 km)."""
    from pism_tpu_torch.coupler import sealevel
    from pism_tpu_torch.parallel import make_mesh
    extra = dict(extra)
    mesh = extra.pop("mesh", None)
    mesh = None if mesh is None else make_mesh(["cpu"] * 4, mesh)
    cfg = {k: v for k, v in extra.items() if "." in k}
    if chain == "hybrid":
        model, _, _ = setups.hybrid_greenland_model(
            "float64", km=100, device="cpu", mesh=mesh, extra_cfg=cfg)
    else:
        model, _, _, _ = setups.antarctica_pik_ensemble_model(
            1, 200.0, "float64", device="cpu", Mz=11, extra_cfg=cfg)
        model = dataclasses.replace(model, mesh=mesh)
    if "sea_level" in extra:
        model = dataclasses.replace(
            model, sea_level=sealevel.Constant(extra["sea_level"]))
    what = {"mesh": "a mesh", "sea_level": "sea-level",
            "bed_deformation.model": "bed deformation",
            "calving.methods": "calving.methods",
            "calving.float_kill.enabled": "float kill True"}
    with pytest.raises(NotImplementedError, match=what[next(iter(
            {"mesh": 0} if mesh is not None else extra))]):
        EnsembleRunner(model)


def test_ensemble_takes_the_hybrid_chain():
    """SSA+SIA, the PDD, the constant ocean, thickness calving, iceberg
    removal and part-grid run on the member axis: the twin's components
    take its member dims."""
    model, _, _ = setups.hybrid_greenland_model("float64", km=100,
                                                device="cpu")
    twin = EnsembleRunner(model).twin("cpu")
    assert twin.ssa.lead == 1 and twin.calving.lead == 1
    assert twin.stress_balance.lead == 1 and twin.calving.remove_bergs
    assert model.ssa.lead == 0 and model.calving.lead == 0


def test_jax_package_is_the_reference():
    """The JAX twin's helpers stack and broadcast as the port's do."""
    a = np.arange(12.0).reshape(3, 4)
    js = j_ens.broadcast_state(JS.ModelState(geometry=JS.new_geometry(
        jnp.asarray(a), jnp.zeros((3, 4)))), 2)
    ts = broadcast_state(S.ModelState(geometry=S.new_geometry(
        torch.tensor(a), torch.zeros(3, 4, dtype=torch.float64))), 2)
    np.testing.assert_array_equal(ts.geometry.ice_thickness.numpy(),
                                  np.asarray(js.geometry.ice_thickness))
    assert jax.devices()[0].platform == "cpu"


def test_member_groups_on_distinct_devices_run_as_batches():
    """An ensemble axis over two distinct devices (here the CPU under two
    names) places each half of the members on its device as a batch of its
    own; the groups' run equals one batch's, member for member."""
    from pism_tpu_torch.parallel.ensemble import EnsembleGroups
    model, members, sol = _t_halfar(Mx=16)
    batched = stack_states(members + members[:1])
    runner = EnsembleRunner(model)
    mesh = make_mesh(["cpu", "cpu:0"], ensemble=2)
    groups = runner.shard(batched, mesh)
    assert isinstance(groups, EnsembleGroups) and len(groups.states) == 2
    assert [g.geometry.ice_thickness.shape[0] for g in groups.states] == [2, 2]
    t_end = sol.t0 + 20 * SPY
    out, stats = runner.run_segment(groups, sol.t0, t_end)
    ref, ref_stats = runner.run_segment(batched, sol.t0, t_end)
    H = torch.cat([g.geometry.ice_thickness for g in out.states])
    assert torch.equal(H, ref.geometry.ice_thickness)
    assert [s.nsteps for s in stats] == [s.nsteps for s in ref_stats]
