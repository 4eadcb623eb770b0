"""The SSA verification tests I, V, N and M solved by pism_tpu_torch and
by pism_tpu at small sizes, on the CPU in float64 (test J and the
command line are in ``test_torch_ssa_exact.py``, whose JAX solve helper
this file shares).

Each case holds the port to its twin: equal Newton sweeps, velocities
within 1e-5 of max|u| (the solve's rounding envelope: the packages sum
their dot products in different orders), and the Krylov total within 10%
of the range the JAX solve gives when its thickness is scaled by 1 +
k 1e-15, k = 0..3. These solves amplify rounding: test V at 51 points
takes 36 to 46 Krylov iterations in JAX under those scalings, the port 51
unscaled and 36 to 43 scaled. Where the port's unscaled total falls
outside, each of its scaled totals must lie within that widened range,
and the mean of its four totals within 10% of JAX's mean. Then the JAX
tests' own physical bounds (``tests/test_ssa.py``) hold for the port.
"""

import numpy as np
import pytest
import torch

import pism_tpu as pj
from pism_tpu.verification import ssa_exact as jexact

import pism_tpu_torch as pt
from pism_tpu_torch.verification import ssa_exact as texact
from pism_tpu_torch.verification import ssa_tests
from test_torch_ssa_exact import PERTURBATIONS, _jax_solve, _krylov_within

torch.set_num_threads(2)
SPY = 3.15569259747e7


def _jax_I(Mx, My):
    ti = jexact.ExactI()
    g = pj.Grid(Mx=Mx, My=My, Lx=10e3, Ly=60e3, periodicity="x")
    z = np.zeros(g.shape2)
    bc = z.astype(bool)
    bc[0, :] = bc[-1, :] = True
    return _jax_solve(g, {"stress_balance.ssa.fd.velocity_change_rtol": 0.0,
                          "stress_balance.ssa.fd.drag_jacobian": "exact"},
                      ti.B, np.full(g.shape2, ti.H0), z,
                      np.tile(ti.tau_c(g.y)[:, None], (1, Mx)), bc, z, z,
                      (np.full(g.shape2, ti.f), z))


def _jax_V(Mx, My):
    tv = jexact.ExactV()
    g = pj.Grid(Mx=Mx, My=My, Lx=150e3, Ly=50e3, periodicity="y")
    x = np.asarray(g.x) + 150e3
    jf = int(0.85 * Mx)
    H = np.zeros(g.shape2)
    H[:, :jf] = np.tile(tv.thickness(x[:jf])[None, :], (My, 1))
    bc = np.zeros(g.shape2, bool)
    bc[:, 0] = True
    u_in = np.zeros(g.shape2)
    u_in[:, 0] = tv.velocity(x[0])
    return _jax_solve(g, {"stress_balance.ssa.fd.velocity_change_rtol": 0.0},
                      tv.B, H, np.full(g.shape2, -3000.0), None, bc, u_in,
                      np.zeros(g.shape2))


def _jax_N(Mx, My):
    tn = jexact.ExactN()
    g = pj.Grid(Mx=Mx, My=My, Lx=440e3, Ly=50e3, periodicity="y")
    x = np.asarray(g.x)
    bc = np.zeros(g.shape2, bool)
    bc[:, Mx // 2] = True
    z = np.zeros(g.shape2)
    return _jax_solve(g, {"stress_balance.ssa.fd.drag_jacobian": "exact"},
                      tn.B, np.tile(tn.thickness(x)[None, :], (My, 1)),
                      np.full(g.shape2, -tn.depth),
                      np.tile(tn.tau_c(x)[None, :], (My, 1)), bc, z, z)


def _M_fields(tm, g, outer):
    """Test M's thickness, Dirichlet mask and values on grid ``g``: the
    command line's staircase front with the CFBC ("cfbc"), or the JAX
    tests' exact-profile ring inside the front ("dirichlet")."""
    X, Y = np.meshgrid(np.asarray(g.x), np.asarray(g.y))
    R = np.hypot(X, Y)
    Rs = np.maximum(R, 1.0)
    u_ex = tm.velocity(R)
    bc = R <= tm.Rg + g.dx
    if outer == "dirichlet":
        H = np.full(g.shape2, tm.H0m)
        bc = bc | (R >= tm.Rc - 1.5 * g.dx)
    else:
        H = np.where(R <= tm.Rc, tm.H0m, 0.0)
    return (H, np.full(g.shape2, -3000.0), bc,
            np.where(bc, u_ex * X / Rs, 0.0), np.where(bc, u_ex * Y / Rs, 0.0))


def _jax_M(Mx, outer):
    tm = jexact.ExactM()
    g = pj.Grid(Mx=Mx, My=Mx, Lx=750e3, Ly=750e3)
    H, bed, bc, bc_u, bc_v = _M_fields(tm, g, outer)
    return _jax_solve(g, {"stress_balance.ssa.fd.velocity_change_rtol": 0.0},
                      tm.B, H, bed, None, bc, bc_u, bc_v)


def _port_M_dirichlet(Mx):
    """The port's test M with the JAX tests' Dirichlet ring, through
    ``ssa_tests._solve`` as ``ssa_test_M`` solves the command line's."""
    tm = texact.ExactM()
    g = pt.Grid(Mx=Mx, My=Mx, Lx=750e3, Ly=750e3)
    H, bed, bc, bc_u, bc_v = _M_fields(tm, g, "dirichlet")
    u, v, info = ssa_tests._solve(
        g, pt.Config({"stress_balance.ssa.fd.velocity_change_rtol": 0.0}),
        tm.B, H, bed, "cpu", bc=bc, bc_u=bc_u, bc_v=bc_v)
    return ssa_tests.SSATestResult("M", "", g, u, v, info)


CASES = {
    "I": (lambda: _jax_I(11, 31),
          lambda: ssa_tests.ssa_test_I(11, 31, device="cpu")),
    "V": (lambda: _jax_V(51, 5),
          lambda: ssa_tests.ssa_test_V(51, 5, device="cpu")),
    "N": (lambda: _jax_N(111, 5),
          lambda: ssa_tests.ssa_test_N(111, 5, device="cpu")),
    "M_dirichlet": (lambda: _jax_M(41, "dirichlet"),
                    lambda: _port_M_dirichlet(41)),
    "M_cfbc": (lambda: _jax_M(41, "cfbc"),
               lambda: ssa_tests.ssa_test_M(41, device="cpu")),
}


@pytest.fixture(scope="module")
def solved():
    """Every case solved by both packages once: {case: (jax, port)}."""
    return {k: (j(), t()) for k, (j, t) in CASES.items()}


def _port_scaled(case):
    """The port's Krylov totals with the thickness scaled by 1 + k 1e-15,
    k = 1 .. PERTURBATIONS-1 (as ``_jax_solve`` scales JAX's)."""
    solve, totals = ssa_tests._solve, []
    for k in range(1, PERTURBATIONS):
        def scaled(grid, cfg, B, H, *a, k=k, **kw):
            return solve(grid, cfg, B, np.asarray(H) * (1.0 + k * 1e-15),
                         *a, **kw)
        ssa_tests._solve = scaled
        try:
            totals.append(CASES[case][1]().info["krylov_iters"])
        finally:
            ssa_tests._solve = solve
    return totals


@pytest.mark.parametrize("case", list(CASES))
def test_solve_matches_twin(solved, case):
    (ju, jv, jn, jk, env), res = solved[case]
    tu, tv = res.u.numpy(), res.v.numpy()
    assert res.info["newton_iters"] == jn
    kt = res.info["krylov_iters"]
    if not _krylov_within(kt, env):
        # the port's totals under the same scalings each within JAX's
        # widened range, and the means of the four within 10%
        port = _port_scaled(case)
        assert all(_krylov_within(k, env) for k in port), (kt, port, env)
        mean = sum(env) / len(env)
        assert abs((kt + sum(port)) / PERTURBATIONS - mean) <= 0.1 * mean, \
            (kt, port, env)
    scale = max(np.abs(ju).max(), np.abs(jv).max())
    assert np.abs(tu - ju).max() <= 1e-5 * scale
    assert np.abs(tv - jv).max() <= 1e-5 * scale


def test_I_physics(solved):
    """At the JAX test's 11x61: error < 10 m/a on a ~780 m/a stream, and
    the error falls from 31 to 61 points."""
    ti = texact.ExactI()
    res = ssa_tests.ssa_test_I(11, 61, device="cpu")
    u = res.u.numpy()
    err = np.abs(u[:, 5] - ti.velocity(res.grid.y)) * SPY
    assert u[:, 5].max() * SPY == pytest.approx(777.5, rel=0.02)
    assert err.max() < 10.0
    assert np.abs(res.v.numpy()).max() * SPY < 0.05
    coarse = solved["I"][1]
    err31 = np.abs(coarse.u.numpy()[:, 5] - ti.velocity(coarse.grid.y)) * SPY
    assert err.max() < 0.7 * err31.max()


def test_V_physics(solved):
    res = solved["V"][1]
    tv = texact.ExactV()
    x = np.asarray(res.grid.x) + 150e3
    jf = int(0.85 * res.grid.Mx)
    uex = tv.velocity(x[:jf]) * SPY
    uc = res.u.numpy()[2, :jf] * SPY
    assert (np.abs(uc - uex) / uex)[: jf - 1].max() < 0.03
    assert np.abs(res.v.numpy()[2, :jf]).max() * SPY < 1.0
    assert np.all(np.diff(uc[: jf - 1]) > 0)


def test_N_physics(solved):
    res = solved["N"][1]
    tn = texact.ExactN()
    x = np.asarray(res.grid.x)
    u = res.u.numpy()
    assert res.info["newton_iters"] < 20
    uex = tn.velocity(x)
    sel = np.abs(x) <= tn.xc - 2 * res.grid.dx
    assert np.abs(u[2] - uex)[sel].max() / uex.max() < 0.08
    assert np.abs(res.v.numpy()).max() * SPY < 1.0
    np.testing.assert_allclose(u[2], -u[2, ::-1], atol=1e-4 * uex.max())


@pytest.mark.parametrize("outer", ["dirichlet", "cfbc"])
def test_M_physics(solved, outer):
    res = solved[f"M_{outer}"][1]
    tm = texact.ExactM()
    c = res.grid.My // 2
    x = np.asarray(res.grid.x)
    if outer == "cfbc":
        sel = (x > tm.Rg + 50e3) & (x < tm.Rc - 30e3)
        r = res.u.numpy()[c, sel] / tm.velocity(x[sel]) - 1.0
        assert r.max() < 0.18 and r.min() > -0.05
    else:
        sel = (x > tm.Rg + 50e3) & (x < tm.Rc - 60e3)
        u_ex = tm.velocity(x[sel])
        assert (np.abs(res.u.numpy()[c, sel] - u_ex) / u_ex).max() < 0.03


