"""The Q1 finite-element kit and the SSAFEM stress balance, pism_tpu_torch
against pism_tpu on the CPU in float64 (``tests/test_ssafem.py``'s
problems):

- the kit (``ops/fem.py``) on seeded random fields within 1e-14;
- SSAFEM's residual and its Newton matvec (the Jacobian written out, beta
  frozen) against the JAX residual and ``jax.jvp`` of it within 1e-10;
- test I at 11 x 31: the port's solve against the JAX package's (called
  as its command line calls it) within 1e-5 of max|u| (the SSA's
  amplification envelope) and under the JAX test's bounds; the Newton sweeps and Krylov iterations against the JAX
  solve run op by op (``jax.disable_jit``), over a warm-up of 1 Picard
  iteration and 2 Newton sweeps: the JAX package's compiled loops round otherwise, and this
  Jacobi-preconditioned solve's Krylov totals move with the rounding
  (``scripts/fem_krylov_rounding.py``: 10,347 iterations and 75 sweeps
  compiled, 3,656 and 74 in the port, 16,360 under a 1e-15 relative
  perturbation of its matvec);
- FEM against FD under the JAX test's 0.08;
- ``stress_balance.ssa.method = fem`` in ``IceModel`` (the JAX test's
  24 x 24 dome), one stress-balance update within 1e-5 of max speed.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pism_tpu import Config as JConfig, Grid as JGrid
from pism_tpu.model.ssafem import SSAFEM as JSSAFEM
from pism_tpu.ops import fem as jfem
from pism_tpu.physics.rheology import IsothermalGlen as JGlen
from pism_tpu.state import ModelState as JState, new_geometry as j_geom
from pism_tpu.verification.ssa_exact import ExactI

import pism_tpu_torch as pt
from pism_tpu_torch.model.ssa import SSAFD
from pism_tpu_torch.model.ssafem import SSAFEM
from pism_tpu_torch.ops import fem
from pism_tpu_torch.physics.rheology import IsothermalGlen
from pism_tpu_torch.state import ModelState, new_geometry

SPY = 3.15569259747e7


def _f(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


# -- the kit ---------------------------------------------------------------

def test_fem_kit_matches():
    """``corners``, ``scatter_to_nodes`` and ``element_validity`` against
    their twins; ``quad_stacked`` against ``quad_values`` and
    ``quad_gradients``, ``integrate_stacked`` against ``integrate``."""
    rng = np.random.default_rng(0)
    u = rng.normal(size=(7, 9))
    cj, ct = jfem.corners(jnp.asarray(u)), fem.corners(_f(u))
    for a, b in zip(cj, ct):
        assert _rel(a, b) == 0.0
    assert torch.equal(fem.corners_stacked(_f(u)), torch.stack(ct))
    tables = fem.basis_tables(1e3, 2e3)
    G = fem.quad_stacked(tables, fem.corners_stacked(_f(u)))
    gj = jfem.quad_gradients(cj, 1e3, 2e3)
    for a, b in zip(jfem.quad_values(cj) + gj[0] + gj[1], G):
        assert _rel(a, b) <= 1e-14
    terms = [rng.normal(size=(7, 9)) for _ in range(4)]
    assert _rel(jfem.scatter_to_nodes([jnp.asarray(t) for t in terms]),
                fem.scatter_to_nodes([_f(t) for t in terms])) <= 1e-14
    f0, fx, fy = ([rng.normal(size=(7, 9)) for _ in range(4)]
                  for _ in range(3))
    for use in ((1, 1, 1), (0, 1, 1), (1, 0, 0)):
        pick = [x if k else None for k, x in zip(use, (f0, fx, fy))]
        a = jfem.integrate(tuple(None if p is None else [jnp.asarray(t)
                                                          for t in p]
                                 for p in pick), 1e3, 2e3)
        b = fem.integrate_stacked(
            tables, *(torch.zeros(4, 7, 9, dtype=torch.float64)
                      if p is None else torch.stack([_f(t) for t in p])
                      for p in pick), 1e3, 2e3)
        assert _rel(a, b) <= 1e-14
    for px, py in ((False, False), (True, False), (False, True)):
        np.testing.assert_array_equal(
            np.asarray(jfem.element_validity((7, 9), px, py)),
            fem.element_validity((7, 9), px, py).numpy())
    assert fem.N_TAB == jfem.N_TAB and fem.DNDXI_TAB == jfem.DNDXI_TAB \
        and fem.DNDETA_TAB == jfem.DNDETA_TAB


# -- test I ------------------------------------------------------------------

def _test_I(My, Mx=11, over=None):
    """``tests/test_ssafem.py``'s test I problem in both packages:
    (exact, JAX grid, port grid, JAX kwargs, port kwargs, JAX state, port
    state, JAX tau_c, port tau_c)."""
    ti = ExactI()
    cfg = {"stress_balance.ssa.fd.newton_rtol": 3e-5, **(over or {})}
    gj = JGrid(Mx=Mx, My=My, Lx=10e3, Ly=60e3, periodicity="x")
    gt = pt.Grid(Mx=Mx, My=My, Lx=10e3, Ly=60e3, periodicity="x")
    tau = np.tile(ti.tau_c(gj.y)[:, None], (1, Mx))
    bc = np.zeros(gj.shape2, bool)
    bc[0, :] = bc[-1, :] = True
    z = np.zeros(gj.shape2)
    A = float(ti.B) ** -3.0
    kj = dict(grid=gj, config=JConfig(cfg), flow_law=JGlen(A=A),
              bc_mask=jnp.asarray(bc), bc_u=jnp.asarray(z),
              bc_v=jnp.asarray(z), taud_x=jnp.full(gj.shape2, ti.f),
              taud_y=jnp.asarray(z))
    kt = dict(grid=gt, config=pt.Config(cfg), flow_law=IsothermalGlen(A=A),
              bc_mask=torch.as_tensor(bc), bc_u=_f(z), bc_v=_f(z),
              taud_x=_f(np.full(gj.shape2, ti.f)), taud_y=_f(z))
    H = np.full(gj.shape2, ti.H0)
    sj = JState(geometry=j_geom(jnp.asarray(H), jnp.asarray(z)))
    st = ModelState(geometry=new_geometry(_f(H), _f(z)))
    return ti, gj, gt, kj, kt, sj, st, jnp.asarray(tau), _f(tau)


@pytest.fixture(scope="module")
def test_I():
    ti, gj, gt, kj, kt, sj, st, tj, tt = _test_I(31)
    # called as the JAX command line calls it: the solve stops on
    # stagnation, and the JAX package's own jit-wrapped call stops 3.6e-6
    # of max|u| from this one (the port: 6.5e-6 from this, 1.02e-5 from
    # that)
    u_j, v_j = JSSAFEM(**kj).solve(sj, tj)
    u_t, v_t, info = SSAFEM(**kt).solve(st, tt, diagnostics=True)
    return dict(ti=ti, grid=gt, kt=kt, st=st, tt=tt, u_j=np.asarray(u_j),
                v_j=np.asarray(v_j), u_t=u_t.numpy(), v_t=v_t.numpy(),
                info=info)


def test_residual_and_matvec_match():
    """The weak-form residual and its Newton matvec at a seeded iterate
    and direction."""
    ti, gj, gt, kj, kt, sj, st, tj, tt = _test_I(31)
    rng = np.random.default_rng(1)
    u0, v0 = (rng.normal(size=gj.shape2) * s / SPY for s in (300.0, 30.0))
    du, dv = (rng.normal(size=gj.shape2) / SPY for _ in range(2))
    Pj = JSSAFEM(**kj).build_problem(sj, tj)
    Pt = SSAFEM(**kt).build_problem(st, tt)
    uvj = Pj["free"]((jnp.asarray(u0), jnp.asarray(v0)))
    uvt = Pt["free"]((_f(u0), _f(v0)))
    for a, b in zip(Pj["residual"](uvj), Pt["residual"](uvt)):
        assert _rel(a, b) <= 1e-10
    _, Jj = jax.jvp(Pj["residual"], (uvj,),
                    (Pj["free"]((jnp.asarray(du), jnp.asarray(dv))),))
    u, v = Pt["full"](uvt)
    Jt = Pt["linearized"](u, v, Pt["beta_fn"](u, v))(
        *Pt["free"]((_f(du), _f(dv))))
    for a, b in zip(Jj, Jt):
        assert _rel(a, b) <= 1e-10


def test_I_matches_jax_and_exact(test_I):
    """The whole solve: within 1e-5 of max|u| of the JAX package's, and
    the JAX test's bounds against Schoof's exact stream."""
    r = test_I
    assert _rel(r["u_j"], r["u_t"]) <= 1e-5
    assert _rel(r["v_j"], r["v_t"]) <= 1e-5 * np.abs(r["u_j"]).max() \
        / max(np.abs(r["v_j"]).max(), 1e-300)
    err = np.abs(r["u_t"][:, 5] - r["ti"].velocity(r["grid"].y)).max() * SPY
    assert err < 40.0
    assert np.abs(r["v_t"]).max() * SPY < 0.01
    assert r["info"]["newton_iters"] > 10 and r["info"]["krylov_iters"] > 0


def test_I_counts_match_jax_op_by_op():
    """Newton sweeps equal and Krylov iterations within 10% of the JAX
    solve run op by op, over a Picard warm-up of 1 and 2 Newton sweeps."""
    ti, gj, gt, kj, kt, sj, st, tj, tt = _test_I(
        31, over={"stress_balance.ssa.fd.newton_max_iterations": 2,
                  "stress_balance.ssa.fd.picard_warmup": 1})
    import pism_tpu.model.ssafem as j_ssafem
    counts = []
    orig = j_ssafem.ssa_ops.bicgstab_solve

    def counting(*a, **k):
        out = orig(*a, **k)
        counts.append(int(out[1]))
        return out

    j_ssafem.ssa_ops.bicgstab_solve = counting
    try:
        with jax.disable_jit():
            _, _, info_j = JSSAFEM(**kj).solve(sj, tj, diagnostics=True)
    finally:
        j_ssafem.ssa_ops.bicgstab_solve = orig
    _, _, info_t = SSAFEM(**kt).solve(st, tt, diagnostics=True)
    assert int(info_j["iterations"]) == info_t["newton_iters"] == 2
    assert abs(info_t["krylov_iters"] - sum(counts)) <= 0.1 * sum(counts)


def test_fem_matches_fd(test_I):
    """FD and FEM discretize one PDE: centerline velocities agree within
    their (larger, FEM) discretization error."""
    r = test_I
    u_fd, _ = SSAFD(**r["kt"]).solve(r["st"], r["tt"])
    u_fd = u_fd.numpy()
    rel = np.abs(r["u_t"][:, 5] - u_fd[:, 5]).max() / np.abs(u_fd).max()
    assert rel < 0.08


def test_fem_in_icemodel_matches():
    """``stress_balance.ssa.method = fem`` builds SSAFEM in ``IceModel``;
    one stress-balance update of the JAX test's dome within 1e-5 of max
    speed of the JAX package's, finite and sliding."""
    from pism_tpu.coupler.surface import Uniform as JUniform
    from pism_tpu.model.icemodel import IceModel as JIceModel
    from pism_tpu_torch.coupler.surface import Uniform
    from pism_tpu_torch.model.icemodel import IceModel

    over = {"stress_balance.model": "ssa+sia",
            "stress_balance.ssa.method": "fem",
            "stress_balance.sia.flow_law": "isothermal_glen",
            "stress_balance.ssa.flow_law": "isothermal_glen",
            "energy.model": "none",
            "basal_yield_stress.model": "constant",
            "basal_yield_stress.constant.value": 20e3}
    kw = dict(Mx=24, My=24, Lx=100e3, Ly=100e3, Mz=5, Lz=4000.0)
    gj, gt = JGrid(**kw), pt.Grid(**kw)
    r = np.asarray(gj.radius)
    H = np.maximum(2500.0 * (1.0 - (r / 90e3) ** 2), 0.0)
    mj = JIceModel(grid=gj, config=JConfig(over),
                   surface=JUniform(smb=0.1 / SPY))
    mt = IceModel(grid=gt, config=pt.Config(over),
                  surface=Uniform(smb=0.1 / SPY), device="cpu")
    assert isinstance(mt.ssa, SSAFEM)
    sj = mj.prepare_state(JState(geometry=j_geom(jnp.asarray(H),
                                                 jnp.zeros(gj.shape2))))
    st = mt.prepare_state(ModelState(geometry=new_geometry(
        _f(H), _f(np.zeros(gt.shape2)))))
    bj = mj.stress_balance.update(sj, mj.yield_stress.compute(sj))
    bt = mt.stress_balance.update(st, mt.yield_stress.compute(st, t=0.0))
    sp_j = np.hypot(np.asarray(bj.u_ssa), np.asarray(bj.v_ssa))
    sp_t = np.hypot(bt.u_ssa.numpy(), bt.v_ssa.numpy())
    assert np.isfinite(sp_t).all() and np.isfinite(bt.qe.numpy()).all()
    assert sp_t.max() * SPY > 0.5
    assert _rel(sp_j, sp_t) <= 1e-5
    assert bt.ssa_newton_iters > 0 and bt.ssa_krylov_iters > 0


def test_fem_refused_on_member_axis_and_mesh():
    """SSAFEM on an ensemble's member axis and under a mesh raises, naming
    ROADMAP Queue 1 items 3 and 10."""
    from pism_tpu_torch.parallel import make_mesh

    kt = _test_I(31)[4]
    with pytest.raises(NotImplementedError, match="item 3"):
        SSAFEM(**kt, lead=1)
    with pytest.raises(NotImplementedError, match="item 10"):
        SSAFEM(**kt, mesh=make_mesh(["cpu"] * 4, (2, 2)))
