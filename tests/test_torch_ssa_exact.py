"""The SSA verification suite (tests I, J, M, V, N) of pism_tpu_torch
against pism_tpu's, on the CPU in float64.

- The exact solutions (``verification/ssa_exact.py``,
  ``ssa_manufactured.py``) equal the twin's: I, V and N to 1e-14, M's RK4
  shooting profile (partials by hand here, autodiff there) to 1e-10, the
  manufactured compensatory stress (``torch.func`` here, nested
  ``jax.grad`` there) to 1e-12.
- The exact drag Jacobian: the solve's Newton matvec with the drag tangent
  equals ``jax.jvp`` of the twin's residual with ``differentiable_beta`` to
  1e-12, on a clamped and a periodic grid, plastic and pseudo-plastic.
- The multigrid preconditioner (``ops/mg.py``) equals the twin's to 1e-12.
- The five tests solved by both packages at small sizes: equal Newton
  sweeps, velocities within 1e-5 of max|u| (the solve's rounding envelope:
  the packages sum their dot products in different orders), and the JAX
  tests' own physical bounds. The Krylov totals are held within 10% of the
  range the JAX solve itself gives when its thickness is scaled by 1 +
  k 1e-15, k = 0..3: these solves amplify rounding, so that test V at 51
  points takes 36 to 46 Krylov iterations in JAX alone (the port takes
  51), and 52 to 81 at 101 points.
"""

import contextlib
import io
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pism_tpu as pj
from pism_tpu.model.ssa import SSAFD as JSSAFD
from pism_tpu.ops import mg as jmg
from pism_tpu.ops import ssa as jssa_ops
from pism_tpu.ops.stencils import Shifter as JShifter
from pism_tpu.physics.rheology import IsothermalGlen as JGlen
from pism_tpu.state import ModelState as JState
from pism_tpu.state import new_geometry as jgeometry
from pism_tpu.verification import ssa_exact as jexact
from pism_tpu.verification import ssa_manufactured as jman

import pism_tpu_torch as pt
from pism_tpu_torch import cli as t_cli
from pism_tpu_torch.model.ssa import SSAFD as TSSAFD
from pism_tpu_torch.ops import mg as tmg
from pism_tpu_torch.ops import ssa as tssa_ops
from pism_tpu_torch.ops.kernels import ssa_matvec as K
from pism_tpu_torch.physics.rheology import IsothermalGlen as TGlen
from pism_tpu_torch.state import ModelState as TState
from pism_tpu_torch.state import new_geometry as tgeometry
from pism_tpu_torch.verification import ssa_exact as texact
from pism_tpu_torch.verification import ssa_manufactured as tman

torch.set_num_threads(2)
SPY = 3.15569259747e7


def T(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


# ---------------------------------------------------------------------------
# exact solutions
# ---------------------------------------------------------------------------

def test_exact_I_equals_twin():
    j, t = jexact.ExactI(), texact.ExactI()
    y = np.linspace(-60e3, 60e3, 97)
    assert t.f == j.f and t.y0 == j.y0
    for name in ("velocity", "tau_c"):
        assert rel(getattr(t, name)(y), getattr(j, name)(y)) <= 1e-14


def test_exact_V_equals_twin():
    j, t = jexact.ExactV(), texact.ExactV()
    x = np.linspace(0.0, 300e3, 101)
    for name in ("velocity", "thickness"):
        assert rel(getattr(t, name)(x), getattr(j, name)(x)) <= 1e-14


def test_exact_N_equals_twin():
    j, t = jexact.ExactN(), texact.ExactN()
    x = np.linspace(-440e3, 440e3, 221)
    assert t.gamma == j.gamma
    for name in ("velocity", "thickness", "tau_c", "smb"):
        assert rel(getattr(t, name)(x), getattr(j, name)(x)) <= 1e-14


def test_exact_M_profile_equals_twin():
    """The RK4 shooting (2000 steps, 80 bisections) with the partials of
    T_rr written out, against the twin's jax.grad ones."""
    r = np.linspace(0.0, 750e3, 301)
    t, j = texact.ExactM().velocity(r), jexact.ExactM().velocity(r)
    assert rel(t, j) <= 1e-10
    # the front condition holds at the exact solution's front
    assert texact.ExactM().velocity(600e3) * SPY == pytest.approx(3494.68,
                                                                  abs=0.01)


@pytest.mark.parametrize("Mx", [33, 61])
def test_manufactured_taud_equals_twin(Mx):
    grid = pt.Grid(Mx=Mx, My=Mx, Lx=400e3, Ly=400e3, periodicity="xy")
    t, j = tman.ManufacturedSSA(), jman.ManufacturedSSA()
    for m in (t, j):
        m.eps_reg2 = (100.0 / SPY / 100e3) ** 2
        m.epsilon_nuH = 1e12
        m.k = 4.0 * math.pi / (Mx * grid.dx)
    X, Y = np.meshgrid(grid.x, grid.y)
    fx, fy = t.taud(X, Y)
    jt = jax.vmap(jax.vmap(lambda a, b: jnp.stack(j.taud(a, b))))(
        jnp.asarray(X), jnp.asarray(Y))
    assert rel(fx, jt[:, :, 0]) <= 1e-12
    assert rel(fy, jt[:, :, 1]) <= 1e-12


# ---------------------------------------------------------------------------
# the drag tangent of the exact drag Jacobian
# ---------------------------------------------------------------------------

def _drag_problem(periodic, pseudo_plastic, seed=7, My=13, Mx=17):
    """A grounded stream with a Dirichlet ring (nonzero values on one
    side), an ice-free patch, seeded velocities, tau_c and a direction; the
    config under both packages."""
    rng = np.random.default_rng(seed)
    per = "y" if periodic else "none"
    kw = dict(Mx=Mx, My=My, Lx=40e3, Ly=30e3, periodicity=per)
    H = rng.uniform(300.0, 900.0, (My, Mx))
    H[2:4, 3:5] = 0.0
    bed = rng.uniform(-50.0, 100.0, (My, Mx))
    tau = rng.uniform(2e4, 9e4, (My, Mx))
    uv = [rng.normal(size=(My, Mx)) * 200.0 / SPY for _ in range(2)]
    uv[0][5, 7] = 0.0               # a cell at rest: beta at u_reg
    uv[1][5, 7] = 0.0
    d = [rng.normal(size=(My, Mx)) * 50.0 / SPY for _ in range(2)]
    bc = np.zeros((My, Mx), bool)
    bc[:, 0] = bc[:, -1] = True
    bcu = np.where(bc, 100.0 / SPY, 0.0)
    cfg = {"stress_balance.ssa.fd.drag_jacobian": "exact",
           "basal_resistance.pseudo_plastic.enabled": pseudo_plastic,
           "basal_resistance.pseudo_plastic.q": 0.25}
    return kw, H, bed, tau, uv, d, bc, bcu, cfg


@pytest.mark.parametrize("pseudo_plastic", [False, True],
                         ids=["plastic", "pseudo_plastic"])
@pytest.mark.parametrize("periodic", [False, True],
                         ids=["clamped", "periodic"])
def test_drag_tangent_equals_jax_jvp(periodic, pseudo_plastic):
    kw, H, bed, tau, uv, d, bc, bcu, cfg = _drag_problem(periodic,
                                                         pseudo_plastic)
    zero = np.zeros_like(H)
    jg = pj.Grid(**kw)
    js = JSSAFD(grid=jg, config=pj.Config(cfg), flow_law=JGlen(A=1e-24),
                bc_mask=jnp.asarray(bc), bc_u=jnp.asarray(bcu),
                bc_v=jnp.asarray(zero))
    jst = JState(geometry=jgeometry(jnp.asarray(H), jnp.asarray(bed)))
    P = js.build_problem(jst, jnp.asarray(tau), differentiable_beta=True)
    x = tuple(jnp.asarray(a) for a in uv)
    dj = tuple(jnp.asarray(a) for a in d)
    _, Jd = jax.jvp(P["residual"], (x,), (P["free"](dj),))
    bcm = np.asarray(P["bc_mask"])
    want = [np.asarray(Jd[k]) + np.where(bcm, d[k], 0.0) for k in range(2)]

    tg = pt.Grid(**kw)
    ts = TSSAFD(grid=tg, config=pt.Config(cfg), flow_law=TGlen(A=1e-24),
                bc_mask=torch.as_tensor(bc), bc_u=T(bcu), bc_v=T(zero))
    tst = TState(geometry=tgeometry(T(H), T(bed)))
    Q = ts.build_problem(tst, T(tau))
    u, v = Q["full"]((T(uv[0]), T(uv[1])))
    nuH, coefs = Q["linearize_nuH"](u, v)
    got = Q["newton_matvec"](u, v, nuH, coefs, Q["beta_fn"](u, v))(
        (T(d[0]), T(d[1])))
    assert np.array_equal(Q["bc_mask"].numpy(), bcm)
    for k in range(2):
        assert rel(got[k].numpy(), want[k]) <= 1e-12
    # the drag term is a real part of it: the frozen-beta matvec differs
    frozen = JSSAFD(grid=jg, config=pj.Config(), flow_law=JGlen(A=1e-24),
                    bc_mask=jnp.asarray(bc), bc_u=jnp.asarray(bcu),
                    bc_v=jnp.asarray(zero))
    Pf = frozen.build_problem(jst, jnp.asarray(tau))
    _, Jf = jax.jvp(Pf["residual"], (x,), (Pf["free"](dj),))
    assert rel(np.asarray(Jf[0]), want[0]) > 1e-6


@pytest.mark.parametrize("halo", [False, True], ids=["whole", "halo"])
def test_without_drag_plane_the_matvec_keeps_its_bits(halo):
    """Without a plane the Newton matvec is the frozen-beta one, bit for
    bit: equal to the launch with a zero plane, and on the whole field to
    the composition of its parts as it was formed before the drag
    tangent."""
    rng = np.random.default_rng(3)
    My, Mx = 9, 12
    f = lambda *s: T(rng.normal(size=s))              # noqa: E731
    u, v, du, dv = (f(My, Mx) * 1e-5 for _ in range(4))
    nuH_e, nuH_n = (T(rng.uniform(1e13, 1e16, (My, Mx))) for _ in range(2))
    coef_e, coef_n = f(My, Mx, 4) * 1e10, f(My, Mx, 4) * 1e10
    beta = T(rng.uniform(0.0, 1e10, (My, Mx)))
    bc = torch.as_tensor(rng.uniform(size=(My, Mx)) < 0.2)
    if not halo:
        args = (u, v, du, dv, nuH_e, nuH_n, coef_e, coef_n, beta, bc,
                20e3, 20e3)
        got = K.ssa_newton_matvec(*args)
        fu, fv = torch.where(bc, 0.0, du), torch.where(bc, 0.0, dv)
        dn = K._tangent(K._neighbours(K._pad_edge(fu), 1, My, Mx),
                        K._neighbours(K._pad_edge(fv), 1, My, Mx),
                        coef_e, coef_n, 20e3, 20e3)
        t1 = K.ssa_matvec_plain(fu, fv, nuH_e, nuH_n, beta, 20e3, 20e3)
        m2 = K._minus_div(u, v, *dn, 20e3, 20e3)
        old = (torch.where(bc, du, t1[0] + m2[0]),
               torch.where(bc, dv, t1[1] + m2[1]))
        zero = K.ssa_newton_matvec(*args, torch.zeros_like(beta))
    else:
        mv = tssa_ops.ssa_newton_matvec_periodic(
            u, v, nuH_e, nuH_n, coef_e, coef_n, beta, bc, 20e3, 20e3,
            (True, False))
        got = old = mv(du, dv)
        zero = tssa_ops.ssa_newton_matvec_periodic(
            u, v, nuH_e, nuH_n, coef_e, coef_n, beta, bc, 20e3, 20e3,
            (True, False), torch.zeros_like(beta))(du, dv)
    for a, b, c in zip(got, old, zero):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_dbeta_coef_is_the_derivative_of_beta():
    """c = 2 dbeta/d|u|^2 against torch.func.jvp of the sliding law's beta,
    with sliding_scale, and 0 where tau_c is 0."""
    from pism_tpu_torch.physics.basal import SlidingLaw
    rng = np.random.default_rng(5)
    tau = T(rng.uniform(0.0, 1e5, (6, 7)))
    tau[0] = 0.0
    u, v, du, dv = (T(rng.normal(size=(6, 7)) * 1e-5) for _ in range(4))
    for law in (SlidingLaw(), SlidingLaw(pseudo_plastic=True, q=0.25),
                SlidingLaw(pseudo_plastic=True, q=0.5, sliding_scale=3.0)):
        _, db = torch.func.jvp(lambda a, b: law.beta(tau, a, b), (u, v),
                               (du, dv))
        c = law.dbeta_coef(tau, u, v)
        assert rel((c * (u * du + v * dv)).numpy(), db.numpy()) <= 1e-13
        assert torch.all(c[0] == 0)


# ---------------------------------------------------------------------------
# the multigrid preconditioner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periodicity", ["none", "xy", "y"])
def test_mg_preconditioner_equals_twin(periodicity):
    n = 33
    rng = np.random.default_rng(11)
    kw = dict(Mx=n, My=n, Lx=400e3, Ly=400e3, periodicity=periodicity)
    jg, tg = pj.Grid(**kw), pt.Grid(**kw)
    nuH = [rng.uniform(1e14, 1e16, (n, n)) for _ in range(2)]
    beta = rng.uniform(0.0, 1e9, (n, n))
    bc = np.zeros((n, n), bool)
    if periodicity == "none":
        bc[0, :] = bc[:, -1] = True
    r = [rng.normal(size=(n, n)) for _ in range(2)]
    jp = jmg.make_preconditioner(
        jssa_ops.NuH(jnp.asarray(nuH[0]), jnp.asarray(nuH[1])),
        jnp.asarray(beta), jnp.asarray(bc), jg.dx, jg.dy, JShifter(jg))
    tp = tmg.make_preconditioner(
        tssa_ops.NuH(T(nuH[0]), T(nuH[1])), T(beta), torch.as_tensor(bc),
        tg.dx, tg.dy, (tg.periodic_y, tg.periodic_x))
    want = jp((jnp.asarray(r[0]), jnp.asarray(r[1])))
    got = tp((T(r[0]), T(r[1])))
    for k in range(2):
        assert rel(got[k].numpy(), np.asarray(want[k])) <= 1e-12


def test_mg_levels_and_launches():
    """The hierarchy's sizes (the twin's rule: halve while the smaller side
    exceeds 12, at most 5 levels) and one V-cycle's operator applications,
    PRE + POST + 1 per level above the coarsest and COARSE_SWEEPS on it."""
    for n, sizes in ((33, [33, 17, 9]), (61, [61, 31, 16, 8]),
                     (121, [121, 61, 31, 16, 8])):
        g = pt.Grid(Mx=n, My=n, Lx=400e3, Ly=400e3)
        one = torch.ones(n, n, dtype=torch.float64)
        lv = tmg.build_levels(tssa_ops.NuH(one, one), one, g.dx, g.dy,
                              (False, False))
        assert [x["shape"][0] for x in lv] == sizes
    calls = []
    orig = tssa_ops.apply_operator
    tssa_ops.apply_operator = lambda *a: (calls.append(1), orig(*a))[1]
    try:
        tmg.vcycle(lv, (one, one))
    finally:
        tssa_ops.apply_operator = orig
    assert len(calls) == ((tmg.PRE + tmg.POST + 1) * (len(lv) - 1)
                          + tmg.COARSE_SWEEPS)


def test_exact_solution_is_discrete_solution_N():
    """The exact (H, u, tau_c) triple of test N satisfies the port's
    discrete SSA residual to < 0.05 Pa on the interior."""
    tn = texact.ExactN()
    Mx, My = 111, 5
    grid = pt.Grid(Mx=Mx, My=My, Lx=440e3, Ly=50e3, periodicity="y")
    x = np.asarray(grid.x)
    H = np.tile(tn.thickness(x)[None, :], (My, 1))
    tau = np.tile(tn.tau_c(x)[None, :], (My, 1))
    bc = np.zeros(grid.shape2, bool)
    bc[:, Mx // 2] = True
    z = T(np.zeros(grid.shape2))
    ssa = TSSAFD(grid=grid, config=pt.Config(),
                 flow_law=TGlen(A=float(tn.B) ** -3.0),
                 bc_mask=torch.as_tensor(bc), bc_u=z, bc_v=z)
    P = ssa.build_problem(TState(geometry=tgeometry(
        T(H), T(np.full(grid.shape2, -tn.depth)))), T(tau))
    uex = T(np.tile(tn.velocity(x)[None, :], (My, 1)))
    ru, _ = P["residual"]((uex, torch.zeros_like(uex)))
    interior = np.abs(x) <= tn.xc - 2 * grid.dx
    assert np.abs(ru.numpy()[2][interior]).max() < 0.05


# ---------------------------------------------------------------------------
# test J through both packages
# ---------------------------------------------------------------------------

PERTURBATIONS = 4


def _jax_solve(grid, cfg, B, H, bed, tau_c=None, bc=None, bc_u=None,
               bc_v=None, taud=None):
    """The JAX solve: (u, v, Newton sweeps, Krylov total, the Krylov totals
    with the thickness scaled by 1 + k 1e-15, k = 0 .. PERTURBATIONS-1)."""
    j = lambda a: None if a is None else jnp.asarray(a)   # noqa: E731
    ssa = JSSAFD(grid=grid, config=pj.Config(cfg),
                 flow_law=JGlen(A=float(B) ** -3.0), bc_mask=j(bc),
                 bc_u=j(bc_u), bc_v=j(bc_v),
                 taud_x=None if taud is None else j(taud[0]),
                 taud_y=None if taud is None else j(taud[1]))
    solve = jax.jit(lambda s: ssa.solve(s, j(tau_c), diagnostics=True))
    runs = [solve(JState(geometry=jgeometry(j(H) * (1.0 + k * 1e-15),
                                            j(bed))))
            for k in range(PERTURBATIONS)]
    u, v, info = runs[0]
    return (np.asarray(u), np.asarray(v), int(info["newton_iters"]),
            int(info["krylov_iters"]),
            [int(r[2]["krylov_iters"]) for r in runs])


def _krylov_within(port, jax_totals):
    return 0.9 * min(jax_totals) <= port <= 1.1 * max(jax_totals)


def _jax_J(Mx):
    m = jman.ManufacturedSSA()
    g = pj.Grid(Mx=Mx, My=Mx, Lx=m.L, Ly=m.L, periodicity="xy")
    m.eps_reg2 = (100.0 / SPY / 100e3) ** 2
    m.epsilon_nuH = pj.Config().get_number("stress_balance.ssa.epsilon")
    m.k = 4.0 * np.pi / (Mx * g.dx)
    X, Y = (jnp.asarray(a) for a in np.meshgrid(g.x, g.y))
    td = jax.vmap(jax.vmap(lambda a, b: jnp.stack(m.taud(a, b))))(X, Y)
    H = jax.vmap(jax.vmap(m.H))(X, Y)
    cfg = {"basal_resistance.pseudo_plastic.enabled": True,
           "basal_resistance.pseudo_plastic.q": 1.0,
           "basal_resistance.pseudo_plastic.u_threshold": 100.0,
           "stress_balance.ssa.fd.preconditioner": "mg",
           "stress_balance.ssa.Schoof_regularizing_velocity": 100.0,
           "stress_balance.ssa.Schoof_regularizing_length": 100.0}
    u, v, nw, nk, env = _jax_solve(g, cfg, m.B, H, np.zeros(g.shape2),
                                   np.full(g.shape2, m.tau_c),
                                   taud=(td[:, :, 0], td[:, :, 1]))
    uex = np.asarray(jax.vmap(jax.vmap(m.u))(X, Y))
    vex = np.asarray(jax.vmap(jax.vmap(m.v))(X, Y))
    return u, v, nw, env, max(np.abs(u - uex).max(), np.abs(v - vex).max())


def test_J_matches_twin():
    """The manufactured shelf at 33 points: equal sweeps, Krylov within
    the envelope, the error within 1e-5 of max|u|; then the port's
    second-order convergence to 65 (the JAX test's bounds)."""
    ju, jv, jn, env, jerr = _jax_J(33)
    err, grid, info = tman.ManufacturedSSA().solve_on(33, "cpu",
                                                      diagnostics=True)
    assert info["newton_iters"] == jn
    assert _krylov_within(info["krylov_iters"], env), \
        (info["krylov_iters"], env)
    assert abs(err - jerr) <= 1e-5 * 300.0 / SPY
    e65, _ = tman.ManufacturedSSA().solve_on(65, "cpu")
    assert err * SPY < 2.0
    assert math.log2(err / e65) > 1.5


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

# the JAX command line's report at its defaults (pism_tpu cli.main on the
# CPU, float64): the numbers each port run must reproduce within 1%
JAX_REPORT = {"I": (780.61, 777.54, 3.441, 2.264),
              "V": (827.30, 824.80, 2.498, 1.493),
              "N": (5889.1, 5654.3, 219.08, 84.70, 6)}


@pytest.mark.parametrize("letter", ["I", "V", "N"])
def test_cli_report(letter):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert t_cli.main(["-test", letter, "-platform", "cpu"]) == 0
    line = out.getvalue().strip().splitlines()[-1]
    assert line.startswith(f"test {letter} (SSAFD")
    nums = [float(s) for s in
            line.replace("(", " ").replace(")", " ").replace(";", " ")
            .replace(",", " ").split() if s.replace(".", "").isdigit()]
    for got, want in zip(nums, JAX_REPORT[letter]):
        assert got == pytest.approx(want, rel=0.01)
    assert len(nums) == len(JAX_REPORT[letter])


@pytest.mark.parametrize("override,where", [
    ({"stress_balance.ssa.fd.drag_jacobian": "exact"}, "members"),
    ({"stress_balance.ssa.fd.preconditioner": "mg"}, "members"),
    ({"stress_balance.ssa.fd.drag_jacobian": "exact"}, "mesh"),
    ({"stress_balance.ssa.fd.preconditioner": "linemg"}, "grid"),
])
def test_unported_branches_raise(override, where):
    """The exact drag Jacobian and mg on an ensemble's member axis, the
    exact drag Jacobian under a mesh, and linemg anywhere raise."""
    from pism_tpu_torch.parallel import make_mesh
    grid = pt.Grid(Mx=9, My=9, Lx=1e5, Ly=1e5)
    kw = {"members": dict(lead=1),
          "mesh": dict(mesh=make_mesh(["cpu"] * 4, (2, 2))),
          "grid": {}}[where]
    with pytest.raises(NotImplementedError):
        TSSAFD(grid=grid, config=pt.Config(override), flow_law=TGlen(), **kw)
    # the same SSA builds without the override
    TSSAFD(grid=grid, config=pt.Config(), flow_law=TGlen(), **kw)
