"""The ssa+sia ensemble, pism_tpu_torch against pism_tpu on the CPU: the
hybrid chain's members on a leading axis, differing in their till friction
angle, against ``jax.vmap`` of the JAX package (its SSA solve, its PDD, its
iceberg removal and its ``EnsembleRunner`` over ``_advance_device``); each
member against the port's unbatched run of it; the plain member-axis
kernels against per-member calls; the Krylov loop's frozen members.

Inputs: the 100 km synthetic-Greenland chain (16x29x41, float64) of both
packages, members with till_phi = 15, 27.5 and 40 degrees everywhere;
random fields from numpy seeds.

Tolerances. The batched solve against ``jax.vmap`` of the JAX solve:
equal Newton sweep counts per member, Krylov totals within 20% and
velocities within 5e-4 of the member's max|u|. That is looser than
``tests/test_torch_ssa_solve.py`` holds one solve (10%, 1e-4), because the
JAX package's own batched solve rounds apart from its single solve: XLA
reduces the vmapped dot products in another order, and the solve amplifies
rounding. Measured on these members: JAX's vmap against its own single
solves 3.1e-4 of max|u| and Krylov totals 75/72 and 84/74 (13.5%); the
port against the vmap 2.3e-4 and 70/75, 72/84 (14.3%); the port against
JAX's single solves 7.9e-5 and 70/72, 72/74. The
PDD and iceberg removal at 1e-10 relative (``tests/test_torch_modules.py``);
the 2 a ensemble against JAX's ``EnsembleRunner``: equal steps and
dt-limit hits per member, as ``tests/test_torch_hybrid_chain.py`` holds
the solo chain (enthalpies tied at the pressure-melting value moved 1 J/kg
below it first, for the reason given there), and the volume within 5e-8
relative, not that file's 1e-9: with till_phi = 27.5 the JAX package's
ensemble ends 5.9e-9 from its own single run of the member, and the port
1.3e-8 from the ensemble and 7.5e-9 from the single run (the other members
agree to 8e-13 and 8e-10). Against the port's own unbatched
runs and per-member calls: equal to the bit (the same operations on the
same values in float64; a member's dot products are its own).
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

from pism_tpu import Grid as JGrid, state as JS  # noqa: E402
from pism_tpu.coupler import atmosphere as j_atm, pdd as j_pdd  # noqa: E402
from pism_tpu.coupler.surface import SurfaceCarry as JCarry  # noqa: E402
from pism_tpu.model import calving as j_calv  # noqa: E402
from pism_tpu.ops.stencils import Shifter as JShifter  # noqa: E402
from pism_tpu.parallel import ensemble as j_ens  # noqa: E402
import pism_tpu_torch as pt  # noqa: E402
from pism_tpu_torch import setups  # noqa: E402
from pism_tpu_torch import state as S  # noqa: E402
from pism_tpu_torch.convert import state_from_numpy, state_to_numpy  # noqa: E402
from pism_tpu_torch.coupler.surface import SurfaceCarry  # noqa: E402
from pism_tpu_torch.model import calving as t_calv  # noqa: E402
from pism_tpu_torch.ops import ssa as ssa_ops  # noqa: E402
from pism_tpu_torch.ops.kernels import member_dot as KD  # noqa: E402
from pism_tpu_torch.ops.kernels import pcr as K2  # noqa: E402
from pism_tpu_torch.ops.kernels import ssa_matvec as K1  # noqa: E402
from pism_tpu_torch.ops.stencils import Shifter  # noqa: E402
from pism_tpu_torch.parallel.ensemble import (  # noqa: E402
    EnsembleRunner, broadcast_state, member, stack_states)
from pism_tpu_torch.physics.basal import MohrCoulombYieldStress  # noqa: E402

SPY = 3.15569259747e7
PHIS = (15.0, 27.5, 40.0)
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
    return JS.ModelState(geometry=geom, **{k: jnp.asarray(v)
                                           for k, v in d.items()
                                           if k not in names})


def break_pressure_melting_ties(d, grid, EC):
    """Move enthalpies that sit exactly at E_s(p) 1 J/kg below it."""
    H = torch.tensor(d["ice_thickness"])
    z = torch.as_tensor(grid.z)
    Es = EC.enthalpy_cts(EC.pressure(torch.clamp(H[..., None] - z, min=0.0)))
    E = d["enthalpy"]
    tie = np.abs(E - Es.numpy()) <= 1e-9 * np.abs(Es.numpy())
    return dict(d, enthalpy=np.where(tie, E - 1.0, E))


def _members_numpy(d):
    """The members' numpy states stacked on a leading axis (the layout
    ``jax.vmap`` takes): ``d`` with till_phi = PHIS[b] everywhere."""
    ds = [dict(d, till_phi=np.full(d["ice_thickness"].shape, p))
          for p in PHIS]
    return {k: np.stack([x[k] for x in ds]) for k in ds[0]}


@pytest.fixture(scope="module")
def runs():
    """Both packages at 100 km, three members: one SSA solve batched (JAX:
    ``jax.vmap`` of ``SSAFD.solve``) and the 2 a ensemble (JAX's
    ``EnsembleRunner``); in the port also each member's unbatched solve
    and its run alone."""
    jm, js, _ = bench.hybrid_greenland_model("float64", km=100)
    tm, _, grid = setups.hybrid_greenland_model("float64", km=100,
                                                device="cpu")
    d = break_pressure_melting_ties(jax_to_numpy(js), grid, tm.EC)
    dB = _members_numpy(d)
    jB = numpy_to_jax(dB)
    tB = state_from_numpy(dB, device="cpu")

    ju, jv, jinfo = jax.vmap(lambda st: jm.ssa.solve(
        st, jm.yield_stress.compute(st), diagnostics=True))(jB)
    jout, jstats = j_ens.EnsembleRunner(model=jm).run_segment(
        jB, 0.0, YEARS * SPY)

    runner = EnsembleRunner(tm)
    twin = runner.twin("cpu")
    tu, tv, tinfo = twin.ssa.solve(tB, twin.yield_stress.compute(tB),
                                   diagnostics=True)
    solo = [tm.ssa.solve(member(tB, b), tm.yield_stress.compute(
        member(tB, b)), diagnostics=True) for b in range(len(PHIS))]
    tout, tstats = runner.run_segment(tB, 0.0, YEARS * SPY)
    solo_runs = [tm.step_once(member(tB, b), 0.0, YEARS * SPY)
                 for b in range(len(PHIS))]
    return dict(jsolve=(np.asarray(ju), np.asarray(jv), jinfo),
                tsolve=(tu.numpy(), tv.numpy(), tinfo), solo=solo,
                jout=jax_to_numpy(jout), jstats=jstats,
                tout=state_to_numpy(tout), tstats=tstats,
                solo_runs=solo_runs, tB=tB, model=tm, grid=grid)


# -- the SSA solve on the member axis -----------------------------------------

def test_ssa_solve_members_match_jax_vmap(runs):
    ju, jv, ji = runs["jsolve"]
    tu, tv, ti = runs["tsolve"]
    for b in range(len(PHIS)):
        assert ti["newton_iters"][b] == int(ji["newton_iters"][b])
        assert bool(ti["warmup_skipped"][b]) == bool(ji["warmup_skipped"][b])
        kj = int(ji["krylov_iters"][b])
        assert abs(ti["krylov_iters"][b] - kj) <= 0.20 * kj
        scale = max(np.abs(ju[b]).max(), np.abs(jv[b]).max())
        assert np.abs(tu[b] - ju[b]).max() <= 5e-4 * scale
        assert np.abs(tv[b] - jv[b]).max() <= 5e-4 * scale
    # the members differ: the till angle sets the sliding
    assert len({int(n) for n in ji["newton_iters"]}) > 1


def test_ssa_solve_member_equals_unbatched(runs):
    tu, tv, ti = runs["tsolve"]
    for b, (u, v, info) in enumerate(runs["solo"]):
        assert np.array_equal(tu[b], u.numpy())
        assert np.array_equal(tv[b], v.numpy())
        assert ti["newton_iters"][b] == info["newton_iters"]
        assert ti["krylov_iters"][b] == info["krylov_iters"]
    # the lockstep ran the longest member's sweeps, and at least its
    # Krylov iterations
    assert ti["lockstep_newton"] == max(ti["newton_iters"])
    assert ti["lockstep_krylov"] >= max(ti["krylov_iters"])


def test_identical_members_take_one_members_host_reads(runs):
    """Host reads per lockstep decision, not per member: three copies of a
    member solve with exactly the host syncs of the member alone."""
    from pism_tpu_torch.util import hostsync
    tm, tB = runs["model"], runs["tB"]
    one = member(tB, 1)
    twin = EnsembleRunner(tm).twin("cpu")
    n0 = hostsync.COUNT
    tm.ssa.solve(one, tm.yield_stress.compute(one))
    n1 = hostsync.COUNT
    three = broadcast_state(one, 3)
    u, _ = twin.ssa.solve(three, twin.yield_stress.compute(three))
    assert hostsync.COUNT - n1 == n1 - n0
    assert torch.equal(u[0], u[2])


# -- the Krylov loop's frozen members -----------------------------------------

def _operator(shift):
    """A diagonally dominant 5-point operator with the diagonal shift
    ``shift`` ((B, 1, 1) per member, or one member's (1, 1))."""
    def matvec(x):
        return tuple((4.0 + shift) * c
                     - (torch.roll(c, 1, -1) + torch.roll(c, -1, -1)
                        + torch.roll(c, 1, -2) + torch.roll(c, -1, -2))
                     for c in x)
    return matvec


def _solve(matvec, b, rtol, max_iter, members):
    x0 = (torch.zeros_like(b[0]), torch.zeros_like(b[1]))
    return ssa_ops.bicgstab_solve(matvec, b, x0, lambda r: r, rtol=rtol,
                                  max_iter=max_iter,
                                  lead=1 if members else 0)


def test_bicgstab_member_converged_early_is_frozen():
    """Member 0 stops at a loose tolerance after a few iterations while the
    others go on; member 2 may not iterate at all. Each member's x, |r|^2
    and count equal its unbatched solve's, so member 0 was frozen."""
    B = 3
    rng = np.random.default_rng(3)
    shift = torch.tensor(rng.uniform(0.5, 3.0, size=B))[:, None, None]
    b = tuple(torch.tensor(rng.normal(size=(B, 9, 7))) for _ in range(2))
    rtol = torch.tensor([0.3, 1e-10, 1e-10], dtype=torch.float64)
    cap = [50, 50, 0]
    x, its, r2 = _solve(_operator(shift), b, rtol, cap, True)
    assert its[0] < its[1] and its[2] == 0
    for m in range(B):
        xs, it, r2s = _solve(_operator(shift[m]), (b[0][m], b[1][m]),
                             rtol[m], cap[m], False)
        assert it == its[m]
        assert torch.equal(x[0][m], xs[0]) and torch.equal(x[1][m], xs[1])
        assert torch.equal(r2[m], r2s)
    assert torch.equal(x[0][2], torch.zeros_like(x[0][2]))


# -- the PDD and iceberg removal on the member axis ---------------------------

@pytest.fixture(scope="module")
def climate():
    tm, state, grid = setups.hybrid_greenland_model("float64", km=100,
                                                    device="cpu")
    jm, _, _ = bench.hybrid_greenland_model("float64", km=100)
    return tm, jm, state, grid


def test_pdd_members_match_per_member_and_jax(climate):
    """Members whose steps give 3, 11 and 26 intervals, the last two
    crossing a balance-year start (day 274) at different intervals."""
    tm, jm, state, grid = climate
    surf, jsurf = tm.surface, jm.surface
    t = [0.1 * SPY, 0.6 * SPY, 1.5 * SPY]
    dt = [0.05 * SPY, 0.2 * SPY, 1.0 * SPY]
    rng = np.random.default_rng(8)
    snow = rng.uniform(0.0, 0.5, size=(3, *grid.shape2))
    firn = rng.uniform(0.0, 0.5, size=(3, *grid.shape2))
    geom = stack_states([state] * 3).geometry
    out, carry = surf.members_update(geom, t, dt, SurfaceCarry(
        torch.tensor(snow), torch.tensor(firn)))
    counts = [surf._intervals(d, np.float64)[0] for d in dt]
    assert counts == [3, 11, 26]
    jgeom = JS.Geometry(**{f.name: jnp.asarray(getattr(geom, f.name).numpy())
                           for f in dataclasses.fields(JS.Geometry)})
    jout, jcarry = jax.vmap(lambda g, t_, d_, s_, f_: jsurf.update(
        g, t_, d_, JCarry(s_, f_, None)))(
        jgeom, jnp.asarray(t), jnp.asarray(dt), jnp.asarray(snow),
        jnp.asarray(firn))
    for b in range(3):
        one, c1 = surf.update(member(S.ModelState(geometry=geom), b).geometry,
                              t[b], dt[b], SurfaceCarry(torch.tensor(snow[b]),
                                                        torch.tensor(firn[b])))
        for name in ("smb", "temperature", "melt", "runoff", "accumulation"):
            assert torch.equal(getattr(out, name)[b], getattr(one, name))
            ref = np.asarray(getattr(jout, name)[b])
            assert np.abs(getattr(out, name)[b].numpy() - ref).max() \
                <= 1e-10 * np.abs(ref).max()
        for name in ("snow", "firn"):
            assert torch.equal(getattr(carry, name)[b], getattr(c1, name))
            ref = np.asarray(getattr(jcarry, name)[b])
            assert np.abs(getattr(carry, name)[b].numpy() - ref).max() \
                <= 1e-10 * np.abs(ref).max()


def test_remove_icebergs_members(climate):
    """Floating patches cut off from grounded ice in some members only."""
    _, _, state, grid = climate
    rng = np.random.default_rng(9)
    H = np.stack([state.geometry.ice_thickness.numpy()] * 3)
    bed = np.stack([state.geometry.bed_elevation.numpy()] * 3)
    sl = np.zeros_like(H)
    for b in range(1, 3):   # deep ocean with thin floating islands
        patch = rng.uniform(size=grid.shape2) < 0.3 * b
        sea = bed[b] < -200.0
        H[b] = np.where(sea & patch, 50.0, H[b])
    geom = S.ensure_consistency(S.new_geometry(torch.tensor(H),
                                               torch.tensor(bed),
                                               torch.tensor(sl)).replace(
        ice_area_specific_volume=torch.tensor(rng.uniform(0, 10, H.shape))),
        910.0, 1028.0, 0.01, lead=1)
    out = t_calv.remove_icebergs(geom, Shifter(grid, lead=1))
    removed = 0
    for b in range(3):
        g1 = S.Geometry(**{f.name: getattr(geom, f.name)[b]
                           for f in dataclasses.fields(S.Geometry)})
        one = t_calv.remove_icebergs(g1, Shifter(grid))
        assert torch.equal(out.ice_thickness[b], one.ice_thickness)
        assert torch.equal(out.ice_area_specific_volume[b],
                           one.ice_area_specific_volume)
        removed += int((one.ice_thickness != g1.ice_thickness).sum())
    assert removed > 0
    jgeom = JS.Geometry(**{f.name: jnp.asarray(getattr(geom, f.name).numpy())
                           for f in dataclasses.fields(JS.Geometry)})
    jg = JGrid(Mx=grid.Mx, My=grid.My, Lx=grid.Lx, Ly=grid.Ly)
    jout = jax.vmap(lambda g: j_calv.remove_icebergs(g, JShifter(jg)))(jgeom)
    np.testing.assert_array_equal(out.ice_thickness.numpy(),
                                  np.asarray(jout.ice_thickness))


def test_slippery_grounding_lines_per_member(climate):
    """Mohr-Coulomb with slippery grounding lines on three members equals
    the single-member call on each (the rolls find y and x as the last two
    axes)."""
    tm, _, state, grid = climate
    cfg = pt.Config({"basal_yield_stress.model": "mohr_coulomb",
                     "basal_yield_stress.slippery_grounding_lines": True})
    mc = MohrCoulombYieldStress(cfg)
    rng = np.random.default_rng(10)
    members = []
    for b in range(3):
        sl = rng.uniform(-100.0, 400.0)
        g = S.ensure_consistency(state.geometry.replace(
            sea_level=torch.full_like(state.geometry.sea_level, sl)),
            910.0, 1028.0, 0.01)
        members.append(state.replace(geometry=g, till_phi=torch.tensor(
            rng.uniform(10.0, 40.0, size=grid.shape2))))
    tau = mc.compute(stack_states(members))
    slid = 0
    for b, st in enumerate(members):
        one = mc.compute(st)
        assert torch.equal(tau[b], one)
        off = MohrCoulombYieldStress(pt.Config({
            "basal_yield_stress.model": "mohr_coulomb"})).compute(st)
        slid += int(((one == 0) & (off > 0)).sum())
    assert slid > 0


# -- the plain member-axis kernels against per-member calls -------------------

def _fields(rng, B, My, Mx, n, scale=1.0):
    return [torch.tensor(rng.normal(size=(B, My, Mx)) * scale)
            for _ in range(n)]


@pytest.mark.parametrize("kernel", ["ssa_matvec", "ssa_newton_matvec",
                                    "pcr_lines", "pcr_lines_sub",
                                    "member_dot"])
def test_plain_member_kernels_equal_per_member_calls(kernel):
    rng = np.random.default_rng(11)
    B, My, Mx, dx, dy = 3, 29, 16, 100e3, 100e3
    if kernel == "ssa_matvec":
        u, v = _fields(rng, B, My, Mx, 2, 1e-5)
        ne, nn, beta = (torch.tensor(rng.uniform(1e13, 1e16, (B, My, Mx)))
                        for _ in range(3))
        got = K1.ssa_matvec(u, v, ne, nn, beta, dx, dy)
        ones = [K1.ssa_matvec(u[b], v[b], ne[b], nn[b], beta[b], dx, dy)
                for b in range(B)]
    elif kernel == "ssa_newton_matvec":
        u, v, du, dv = _fields(rng, B, My, Mx, 4, 1e-5)
        ne, nn, beta = (torch.tensor(rng.uniform(1e13, 1e16, (B, My, Mx)))
                        for _ in range(3))
        ce, cn = (torch.tensor(rng.normal(size=(B, My, Mx, 4)) * 1e10)
                  for _ in range(2))
        bc = torch.tensor(rng.uniform(size=(B, My, Mx)) < 0.1)
        got = K1.ssa_newton_matvec(u, v, du, dv, ne, nn, ce, cn, beta, bc,
                                   dx, dy)
        ones = [K1.ssa_newton_matvec(u[b], v[b], du[b], dv[b], ne[b], nn[b],
                                     ce[b], cn[b], beta[b], bc[b], dx, dy)
                for b in range(B)]
    elif kernel in ("pcr_lines", "pcr_lines_sub"):
        a, c = _fields(rng, B, My, Mx, 2, 0.2)
        r = _fields(rng, B, My, Mx, 1)[0]
        scale = torch.tensor(rng.uniform(1.0, 2.0, size=(B, My, Mx)))
        factor = K2.pcr_factor_lines_sub if kernel.endswith("sub") \
            else K2.pcr_factor_lines
        f = factor(a, None, c)
        got = (K2.pcr_apply(f, r, scale), *f.coefficients())
        ones = []
        for b in range(B):
            f1 = factor(a[b], None, c[b])
            ones.append((K2.pcr_apply(f1, r[b], scale[b]),
                         *f1.coefficients()))
        got = (got[0], *(x.movedim(-3, 0) if x.dim() == 4 else x
                         for x in got[1:]))
    else:
        a = tuple(_fields(rng, B, My, Mx, 2))
        bb = tuple(_fields(rng, B, My, Mx, 2))
        got = (KD.member_dot(a, bb),)
        ones = [(ssa_ops._dot((a[0][b], a[1][b]), (bb[0][b], bb[1][b])),)
                for b in range(B)]
    for b, one in enumerate(ones):
        for g, o in zip(got, one):
            assert torch.equal(g[b], o)


#: the member kernels' precisions: field dtype, dot or sum dtype
PRECISIONS = {"f32": (torch.float32, None), "f64": (torch.float64, None),
              "f32_f64": (torch.float32, torch.float64)}


@pytest.mark.parametrize("prec", sorted(PRECISIONS))
def test_plain_member_dots_equal_member_dot_calls(prec):
    """``member_dots(x, y)`` (on the CPU its plain version) is x.x, x.y and
    y.y, each equal to the bit to ``member_dot_plain`` of its pair (and
    x.y to y.x), so the CPU solve's iterates are those of separate dots."""
    dtype, dd = PRECISIONS[prec]
    rng = np.random.default_rng(17)
    x = tuple(t.to(dtype) for t in _fields(rng, 3, 29, 16, 2))
    y = tuple(t.to(dtype) for t in _fields(rng, 3, 29, 16, 2))
    got = KD.member_dots(x, y, dd)
    plain = KD.member_dots_plain(x, y, dd)
    want = (KD.member_dot_plain(x, x, dd), KD.member_dot_plain(x, y, dd),
            KD.member_dot_plain(y, y, dd))
    for g, p, w in zip(got, plain, want):
        assert g.dtype == (dd or dtype) and g.shape == (3,)
        assert torch.equal(g, w) and torch.equal(p, w)
    assert torch.equal(got[1], KD.member_dot_plain(y, x, dd))
    assert torch.equal(KD.member_dot(x, y, dd), want[1])
    # the dots asked for, in the order xx, xy, yy
    for which, idx in ((("xx", "xy"), (0, 1)), (("yy", "xx"), (0, 2)),
                       (("xy",), (1,))):
        sub = KD.member_dots(x, y, dd, which)
        assert len(sub) == len(idx)
        assert all(torch.equal(g, want[i]) for g, i in zip(sub, idx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_member_sum_equals_each_members_sum(dtype):
    """``member_sum`` (on the CPU its plain version) is each member's
    ``torch.sum``, in the field's dtype."""
    rng = np.random.default_rng(19)
    x = _fields(rng, 5, 31, 23, 1)[0].to(dtype)
    got = KD.member_sum(x)
    assert got.dtype == dtype and got.shape == (5,)
    want = torch.stack([torch.sum(x[b]) for b in range(5)])
    assert torch.equal(got, want)
    assert torch.equal(KD.member_sum_plain(x), want)


@pytest.mark.parametrize("which", [("xx", "xy", "yy"), ("xx", "xy"),
                                   ("yy", "xx"), ("xy",)])
def test_member_dot_pairs_in_the_order_xx_xy_yy(which):
    """``pairs`` gives the field pairs of the dots ``which`` names in the
    order xx, xy, yy, whatever order ``which`` lists them in; the
    unbatched solve's ``_dots`` takes its dots of them."""
    x, y = (torch.zeros(1), torch.zeros(1)), (torch.ones(1), torch.ones(1))
    want = [p for w, p in zip(("xx", "xy", "yy"), ((x, x), (x, y), (y, y)))
            if w in which]
    got = KD.pairs(x, y, which)
    assert len(got) == len(want)
    assert all(g[0] is w[0] and g[1] is w[1] for g, w in zip(got, want))
    rng = np.random.default_rng(23)
    u = tuple(_fields(rng, 1, 7, 5, 2))
    v = tuple(_fields(rng, 1, 7, 5, 2))
    dots = ssa_ops._dots((u[0][0], u[1][0]), (v[0][0], v[1][0]), which)
    plain = KD.member_dots_plain(u, v, None, which)
    assert len(dots) == len(plain) == len(want)
    assert all(torch.equal(d, p[0]) for d, p in zip(dots, plain))


def test_member_kernels_refuse_what_they_do_not_take():
    x = torch.zeros(2, 5, 4)
    with pytest.raises(ValueError, match="one shape"):
        KD.member_dots((x, x), (x, torch.zeros(2, 4, 5)))
    with pytest.raises(ValueError, match=r"\(B, My, Mx\)"):
        KD.member_sum(torch.zeros(5, 4))
    with pytest.raises(TypeError, match="float32 or float64"):
        KD.member_sum(torch.zeros(2, 5, 4, dtype=torch.int32))
    with pytest.raises(TypeError, match="float64, not"):
        KD.member_dot((x, x), (x, x), torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        KD.member_sum(torch.zeros(2, 4, 5).transpose(1, 2))
    for which in (("xx", "zz"), ("xy", "xy")):
        with pytest.raises(ValueError, match="distinct names"):
            KD.member_dots((x, x), (x, x), None, which)


def test_bicgstab_members_take_three_dot_calls_an_iteration(monkeypatch):
    """The lockstep loop takes its dots as one ``member_dot`` (rhat.v) and
    two ``member_dots`` (r.r with rhat.r at the head, t.s with t.t) an
    iteration, besides a fixed few a solve; its iterates stay those of the
    unbatched solves (``test_bicgstab_member_converged_early_is_frozen``)."""
    calls = {"member_dot": 0, "member_dots": 0}

    def counted(name):
        fn = getattr(ssa_ops, name)

        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    for name in calls:
        monkeypatch.setattr(ssa_ops, name, counted(name))
    B = 3
    rng = np.random.default_rng(5)
    shift = torch.tensor(rng.uniform(0.5, 3.0, size=B))[:, None, None]
    b = tuple(torch.tensor(rng.normal(size=(B, 9, 7))) for _ in range(2))
    cap = [6, 6, 6]
    _, its, _ = _solve(_operator(shift), b, 1e-30, cap, True)
    assert its == cap
    # a solve: b.b through member_dot and the final r.r with r0.r0 through
    # member_dots; the loop: its iterations' three, no head past the bound
    assert calls == {"member_dot": 1 + 6, "member_dots": 1 + 2 * 6}


# -- the hybrid chain as a 3-member ensemble ----------------------------------

def test_hybrid_ensemble_matches_jax_vmap(runs):
    js, ts = runs["jstats"], runs["tstats"]
    from pism_tpu.model.icemodel import DT_LIMITS as J_LIMITS
    for b in range(len(PHIS)):
        assert ts[b].nsteps == int(js.nsteps[b]) > 0
        jhits = {n: int(c) for n, c in zip(J_LIMITS, js.limit_hits[b])
                 if int(c) > 0}
        assert ts[b].limit_hits_dict() == jhits
        vj = runs["jout"]["ice_thickness"][b].sum()
        vt = runs["tout"]["ice_thickness"][b].sum()
        assert abs(vt - vj) <= 5e-8 * vj


def test_hybrid_ensemble_members_equal_their_runs_alone(runs):
    ts, tout = runs["tstats"], runs["tout"]
    for b, (st, t, solo) in enumerate(runs["solo_runs"]):
        assert t == pytest.approx(YEARS * SPY, abs=1e-6)
        assert ts[b].nsteps == solo.nsteps
        assert ts[b].limit_hits_dict() == solo.limit_hits_dict()
        assert ts[b].ssa_newton_iters == solo.ssa_newton_iters
        assert ts[b].ssa_krylov_iters == solo.ssa_krylov_iters
        one = state_to_numpy(st)
        for name in ("ice_thickness", "enthalpy", "u_ssa", "v_ssa",
                     "snow_depth", "firn_depth", "tillwat",
                     "ice_area_specific_volume"):
            np.testing.assert_array_equal(tout[name][b], one[name],
                                          err_msg=name)
        assert float(ts[b].sum_discharge) == float(solo.sum_discharge)
    assert ts[0].ssa_lockstep_newton >= max(s.ssa_newton_iters for s in ts)


def test_batched_numpy_state_converts_per_member(runs):
    """A dict of stacked arrays (JAX's batched state) converts to the
    stack of the members' conversions."""
    tB = runs["tB"]
    d = state_to_numpy(tB)
    again = state_from_numpy(d, device="cpu")
    per = stack_states([state_from_numpy({k: v[b] for k, v in d.items()},
                                         device="cpu")
                        for b in range(len(PHIS))])
    for k, v in state_to_numpy(again).items():
        np.testing.assert_array_equal(v, state_to_numpy(per)[k])
    assert again.till_phi.shape == (len(PHIS), *runs["grid"].shape2)
