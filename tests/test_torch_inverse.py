"""The SSA inversion (``pism_tpu_torch/inverse/``) against the JAX package's
``pism_tpu/inverse/`` on the CPU, on the problems of
``tests/test_inverse.py``: the plastic-till stream (24x8, periodic in x,
the tau_c design) and the confined shelf (11x31, periodic in y, the
hardness design). Both packages get the same numpy inputs, made from a
seed; each JAX result is computed once per module (a distinct JAX solve
compiles in seconds).

Tolerances and why:
- the plain VJP of the operator against ``jax.vjp`` of the JAX
  ``apply_operator`` (clamped and periodic): 1e-12 of the result's max in
  float64, K1's own tolerance (two orders of summation);
- the misfit gradients against ``jax.value_and_grad`` of the JAX misfit:
  1e-4 of the gradient's max-norm (two adjoint BiCGStab solves stopped at
  rtol 1e-8 on forward solutions that agree to their Newton tolerance);
  the finite-difference checks at JAX's rel 2e-2;
- the regularizers, the parameterizations and Adam against optax: 1e-12;
- the port's bounded L-BFGS against JAX's on a numpy objective: equal to
  the bit (the same numpy arithmetic);
- two L-BFGS iterates of the stream problem: the objective per iterate to
  1e-6 (each iterate's line search compares objectives that agree to the
  gradient's tolerance).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(2)

from pism_tpu import Config as JConfig, Grid as JGrid  # noqa: E402
from pism_tpu.inverse import ssa_inverse as jinv  # noqa: E402
from pism_tpu.inverse.lbfgs import BoundedLBFGS as JLBFGS  # noqa: E402
from pism_tpu.inverse.parameterizations import (  # noqa: E402
    Parameterization as JParam, from_config as jfrom_config)
from pism_tpu.model.ssa import SSAFD as JSSAFD  # noqa: E402
from pism_tpu.ops import ssa as jssa_ops  # noqa: E402
from pism_tpu.ops.stencils import Shifter as JShifter  # noqa: E402
from pism_tpu.physics.rheology import IsothermalGlen as JGlen  # noqa: E402
from pism_tpu.state import ModelState as JState, new_geometry as jgeom  # noqa: E402

from pism_tpu_torch import Config, Grid  # noqa: E402
from pism_tpu_torch.inverse import ssa_inverse as tinv  # noqa: E402
from pism_tpu_torch.inverse.lbfgs import BoundedLBFGS  # noqa: E402
from pism_tpu_torch.inverse.parameterizations import (  # noqa: E402
    Parameterization, from_config)
from pism_tpu_torch.model.ssa import SSAFD  # noqa: E402
from pism_tpu_torch.ops import ssa as ssa_ops  # noqa: E402
from pism_tpu_torch.ops.kernels import ssa_matvec as K  # noqa: E402
from pism_tpu_torch.physics.rheology import IsothermalGlen  # noqa: E402
from pism_tpu_torch.state import ModelState, new_geometry  # noqa: E402

SPY = 3.15569259747e7
F_DRIVE = 910.0 * 9.81 * 2000.0 * 0.001
GRAD_TOL = 1e-4
#: the exact drag Jacobian in both packages: with beta frozen in the Newton
#: matvec (the default) the stream's plastic till takes 51-100 Newton
#: sweeps per full-convergence solve in both, with it 4-5
CONFIG = {"stress_balance.ssa.fd.drag_jacobian": "exact"}


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


def _stream(pkg):
    """tests/test_inverse.py's stream: uniform thickness, prescribed driving
    stress, Dirichlet side walls, periodic in x; its "true" till. With
    ``CONFIG``."""
    My, Mx = 24, 8
    bc = np.zeros((My, Mx), bool)
    bc[0, :] = bc[-1, :] = True
    z = np.zeros((My, Mx))
    if pkg == "jax":
        grid = JGrid(Mx=Mx, My=My, Lx=8e3, Ly=48e3, periodicity="x")
        arr = jnp.asarray
        ssa = JSSAFD(grid=grid, config=JConfig(CONFIG),
                     flow_law=JGlen(A=(3.7e8) ** -3.0), bc_mask=arr(bc),
                     bc_u=arr(z), bc_v=arr(z), taud_x=arr(z + F_DRIVE),
                     taud_y=arr(z))
        state = JState(geometry=jgeom(arr(z + 2000.0), arr(z)))
    else:
        grid = Grid(Mx=Mx, My=My, Lx=8e3, Ly=48e3, periodicity="x")
        arr = _t
        ssa = SSAFD(grid=grid, config=Config(CONFIG),
                    flow_law=IsothermalGlen(A=(3.7e8) ** -3.0),
                    bc_mask=torch.tensor(bc), bc_u=arr(z), bc_v=arr(z),
                    taud_x=arr(z + F_DRIVE), taud_y=arr(z))
        state = ModelState(geometry=new_geometry(arr(z + 2000.0), arr(z)))
    y = grid.y
    tau = 0.6 * F_DRIVE + 1.2 * F_DRIVE * (np.abs(y) / 40e3) ** 4
    return grid, ssa, state, arr(np.tile(tau[:, None], (1, Mx)))


def _shelf(pkg):
    """tests/test_inverse.py's confined shelf: thickness ramp, inflow
    Dirichlet BC, periodic in y; its soft band. With ``CONFIG``."""
    My, Mx = 11, 31
    H = np.tile(np.linspace(600.0, 250.0, Mx)[None, :], (My, 1))
    bc = np.zeros((My, Mx), bool)
    bc[:, 0] = True
    u_in = np.zeros((My, Mx))
    u_in[:, 0] = 150.0 / SPY
    z = np.zeros((My, Mx))
    if pkg == "jax":
        grid = JGrid(Mx=Mx, My=My, Lx=75e3, Ly=25e3, periodicity="y")
        arr, law = jnp.asarray, JGlen(A=1e-25)
        ssa = JSSAFD(grid=grid, config=JConfig(CONFIG), flow_law=law,
                     bc_mask=arr(bc), bc_u=arr(u_in), bc_v=arr(z))
        state = JState(geometry=jgeom(arr(H), arr(z - 2000.0)))
    else:
        grid = Grid(Mx=Mx, My=My, Lx=75e3, Ly=25e3, periodicity="y")
        arr, law = _t, IsothermalGlen(A=1e-25)
        ssa = SSAFD(grid=grid, config=Config(CONFIG), flow_law=law,
                    bc_mask=torch.tensor(bc), bc_u=arr(u_in), bc_v=arr(z))
        state = ModelState(geometry=new_geometry(arr(H), arr(z - 2000.0)))
    B0 = 1e-25 ** (-1.0 / 3.0)
    Bx = np.full(Mx, B0)
    Bx[12:19] = 0.55 * B0
    return grid, ssa, state, arr(np.tile(Bx[None, :], (My, 1))), B0


def _direction(seed, shape, scale):
    return np.random.default_rng(seed).normal(size=shape) * scale


def _warm(state, u, v, pkg):
    """``state`` with the SSA's initial guess (u, v)."""
    arr = jnp.asarray if pkg == "jax" else _t
    return state.replace(u_ssa=arr(u), v_ssa=arr(v))


def _observed(u, v, seed):
    """Observations made from a solution: each component times a random
    factor in [0.8, 1.4] per cell, from ``seed`` (no forward solve)."""
    f = np.random.default_rng(seed).uniform(0.8, 1.4, size=(2,) + u.shape)
    return np.asarray(u) * f[0], np.asarray(v) * f[1]


@pytest.fixture(scope="module")
def stream_jax():
    """The JAX stream inversion at tau0 = 1e4: the full-convergence solve
    there (the port's, the state's initial guess for both packages, so that
    their solves near tau0 take few Newton sweeps), observations made from
    it, J and its gradient in the design variable theta = log(tau), and two
    bounded L-BFGS iterates of JAX's driver on that objective, with the
    bounds of ``run_lbfgs``."""
    grid, ssa, state, _ = _stream("jax")
    tau0 = jnp.full(grid.shape2, 1.0e4)
    u0, v0 = _port_start(_stream("torch"), tau=1.0e4)
    u_obs, v_obs = _observed(u0, v0, 21)
    inv = jinv.TaucInversion(ssa=ssa, state=_warm(state, u0, v0, "jax"),
                             u_obs=jnp.asarray(u_obs),
                             v_obs=jnp.asarray(v_obs), reg_weight=0.0)
    vg = jax.jit(jax.value_and_grad(inv.objective))
    theta0 = inv.param.design(tau0)
    J0, g = vg(theta0)
    lo = float(inv.param.design(jnp.asarray(1.0)))
    hi = float(inv.param.design(jnp.asarray(10 * F_DRIVE)))
    opt = JLBFGS(value_and_grad=lambda x: vg(jnp.asarray(x)),
                 lower=np.full(grid.shape2, lo), upper=np.full(grid.shape2, hi),
                 max_iterations=2, grtol=1e-5, steptol=1e-12)
    res = opt.run(np.asarray(theta0))
    return dict(u_obs=u_obs, v_obs=v_obs, u0=np.asarray(u0),
                v0=np.asarray(v0), J0=float(J0),
                g=np.asarray(g) / np.asarray(tau0),
                lbfgs=[r.J for r in res.log], reason=res.reason,
                tau=np.exp(res.x))


def _port_start(problem, tau=None, hardness=None):
    """The port's full-convergence solve at a uniform tau_c or hardness:
    both packages' initial guess, as numpy."""
    grid, ssa, state = problem[:3]
    full = _t(np.ones(grid.shape2))
    kw = {} if hardness is None else {"hardness": hardness * full}
    u, v = tinv.inverse_solver(ssa).solve(
        state, None if tau is None else tau * full, **kw)
    return u.numpy(), v.numpy()


def _port_tauc(ref, reg_weight):
    """The port's TaucInversion on JAX's observations and warm state."""
    grid, ssa, state, _ = _stream("torch")
    state = _warm(state, ref["u0"], ref["v0"], "torch")
    inv = tinv.TaucInversion(ssa=ssa, state=state, u_obs=_t(ref["u_obs"]),
                             v_obs=_t(ref["v_obs"]), reg_weight=reg_weight)
    return grid, inv


@pytest.fixture(scope="module")
def shelf_jax():
    """The JAX shelf at B0: the full-convergence solve there (both
    packages' initial guess), observations made from it, J and dJ/dB."""
    grid, ssa, state, _, B0 = _shelf("jax")
    Bi = jnp.full(grid.shape2, B0)
    u0, v0 = _port_start(_shelf("torch")[:3], hardness=B0)
    u_obs, v_obs = _observed(u0, v0, 22)
    inv = jinv.HardnessInversion(ssa=ssa, state=_warm(state, u0, v0, "jax"),
                                 u_obs=jnp.asarray(u_obs),
                                 v_obs=jnp.asarray(v_obs), reg_weight=0.0)
    J0, g = jax.jit(jax.value_and_grad(inv.misfit))(Bi)
    return dict(u_obs=u_obs, v_obs=v_obs, u0=np.asarray(u0),
                v0=np.asarray(v0), J0=float(J0), g=np.asarray(g))


@pytest.fixture(scope="module")
def shelf_port(shelf_jax):
    ref = shelf_jax
    grid, ssa, state, B_true, B0 = _shelf("torch")
    inv = tinv.HardnessInversion(
        ssa=ssa, state=_warm(state, ref["u0"], ref["v0"], "torch"),
        u_obs=_t(ref["u_obs"]), v_obs=_t(ref["v_obs"]), reg_weight=0.0)
    return grid, inv, B0


# ---------------------------------------------------------------------------
# the operator's reverse mode
# ---------------------------------------------------------------------------

def _operator_inputs(shape, seed):
    rng = np.random.default_rng(seed)
    a = [rng.normal(size=shape) * 1e-5, rng.normal(size=shape) * 1e-5,
         rng.uniform(1e13, 1e16, size=shape), rng.uniform(1e13, 1e16, shape),
         rng.uniform(0.0, 1e10, size=shape)]
    g = [rng.normal(size=shape), rng.normal(size=shape)]
    return a, g


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("shape,periodicity", [
    ((7, 9), "none"), ((7, 9), "x"), ((7, 9), "y"), ((7, 9), "xy"),
    ((2, 5), "none"), ((2, 5), "xy"), ((9, 2), "none"), ((9, 2), "xy")])
def test_plain_vjp_matches_jax(shape, periodicity):
    """The port's operator under autograd (the plain VJP on the CPU; on a
    periodic grid the padded-block route and its padding's transpose)
    against ``jax.vjp`` of the JAX ``apply_operator``, 1e-12."""
    dx, dy = 2e4, 2.5e4
    a, g = _operator_inputs(shape, 11)
    jgrid = JGrid(Mx=shape[1], My=shape[0], Lx=1e5, Ly=1e5,
                  periodicity=periodicity)
    sh = JShifter(jgrid)

    def jop(u, v, ne, nn, b):
        return jssa_ops.apply_operator(u, v, jssa_ops.NuH(ne, nn), b, dx, dy,
                                       sh)

    _, jvjp = jax.vjp(jop, *map(jnp.asarray, a))
    ref = jvjp(tuple(map(jnp.asarray, g)))
    per = (periodicity in ("y", "xy"), periodicity in ("x", "xy"))
    x = [_t(c).requires_grad_() for c in a]
    out = ssa_ops.apply_operator(x[0], x[1], ssa_ops.NuH(x[2], x[3]), x[4],
                                 dx, dy, per)
    got = torch.autograd.grad(out, x, grad_outputs=tuple(map(_t, g)))
    for name, r, t in zip(("u", "v", "nuH_e", "nuH_n", "beta"), ref, got):
        assert _rel(t, r) <= 1e-12, name


def test_vjp_wrappers_compute_what_is_asked():
    """``ssa_matvec_vjp`` (and its halo twin) returns None for the outputs
    not asked for and the plain VJP's values for the others; the wrapper
    counts its plain calls."""
    a, g = _operator_inputs((5, 6), 3)
    a, g = list(map(_t, a)), list(map(_t, g))
    full = K.ssa_matvec_vjp(*a, *g, 2e4, 2e4)
    for need in ((True, False, False), (False, True, False),
                 (False, False, True)):
        n0 = K.PLAIN_VJP_CALLS
        part = K.ssa_matvec_vjp(*a, *g, 2e4, 2e4, need)
        assert K.PLAIN_VJP_CALLS == n0 + 1
        want = (need[0], need[0], need[1], need[1], need[2])
        for w, p, f in zip(want, part, full):
            assert (p is None) == (not w)
            if w:
                assert torch.equal(p, f)


def test_gradcheck_ssa_matvec():
    """``torch.autograd.gradcheck`` of ``SSAMatvec`` and ``SSAMatvecHalo``
    in float64 at 7x9, on inputs of order one (gradcheck's finite
    differences take a fixed step)."""
    rng = np.random.default_rng(5)
    a = [rng.normal(size=(7, 9)), rng.normal(size=(7, 9)),
         rng.uniform(1.0, 3.0, (7, 9)), rng.uniform(1.0, 3.0, (7, 9)),
         rng.uniform(0.0, 2.0, (7, 9))]
    x = [_t(c).requires_grad_() for c in a]
    assert torch.autograd.gradcheck(
        lambda *t: K.SSAMatvec.apply(*t, 1.5, 2.0), x)
    from pism_tpu_torch.ops.stencils import pad_ghosts
    assert torch.autograd.gradcheck(
        lambda u, v, ne, nn, b: K.SSAMatvecHalo.apply(
            False, True, pad_ghosts(u, 2, False, True),
            pad_ghosts(v, 2, False, True), pad_ghosts(ne, 1, False, True),
            pad_ghosts(nn, 1, False, True), b, 1.5, 2.0), x)


@pytest.mark.parametrize("periodic", [(False, False), (True, False),
                                      (False, True)])
def test_adjoint_identity(periodic):
    """<g, A w> = <A^T g, w> for the linear part of the operator (nuH and
    beta fixed), 1e-12 relative to |<g, A w>|."""
    a, g = _operator_inputs((8, 10), 9)
    u, v, ne, nn, b = map(_t, a)
    gu, gv = map(_t, g)
    x = [u.clone().requires_grad_(), v.clone().requires_grad_()]
    Au, Av = ssa_ops.apply_operator(x[0], x[1], ssa_ops.NuH(ne, nn), b,
                                    2e4, 2.5e4, periodic)
    lhs = float(torch.sum(gu * Au.detach()) + torch.sum(gv * Av.detach()))
    ub, vb = torch.autograd.grad((Au, Av), x, grad_outputs=(gu, gv))
    rhs = float(torch.sum(ub * u) + torch.sum(vb * v))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


# ---------------------------------------------------------------------------
# the misfit gradients
# ---------------------------------------------------------------------------

def test_tauc_gradient_matches_jax(stream_jax):
    ref = stream_jax
    grid, inv = _port_tauc(ref, 0.0)
    # JAX's gradient in theta = log(tau), divided by tau
    J0, g = tinv.value_and_grad(inv.misfit, _t(np.full(grid.shape2, 1e4)))
    assert float(J0) == pytest.approx(ref["J0"], rel=1e-8)
    gmax = np.abs(ref["g"]).max()
    assert gmax > 0
    assert np.abs(g.numpy() - ref["g"]).max() <= GRAD_TOL * gmax
    # JAX's directional finite-difference check, rel 2e-2
    tau0 = _t(np.full(grid.shape2, 1.0e4))
    d = _t(_direction(7, grid.shape2, 100.0))
    with torch.no_grad():
        fd = (float(inv.misfit(tau0 + d)) - float(inv.misfit(tau0 - d))) / 2
    assert float(torch.sum(g * d)) == pytest.approx(fd, rel=2e-2)


def test_hardness_gradient_matches_jax(shelf_jax, shelf_port):
    grid, inv, B0 = shelf_port
    ref = shelf_jax
    B = _t(np.full(grid.shape2, B0))
    J0, g = tinv.value_and_grad(inv.misfit, B)
    assert float(J0) == pytest.approx(ref["J0"], rel=1e-8)
    gmax = np.abs(ref["g"]).max()
    assert gmax > 0
    assert np.abs(g.numpy() - ref["g"]).max() <= GRAD_TOL * gmax
    # JAX's directional finite-difference check, rel 2e-2
    d = _t(_direction(3, grid.shape2, 1e4))
    with torch.no_grad():
        fd = (float(inv.misfit(B + d)) - float(inv.misfit(B - d))) / 2
    assert float(torch.sum(g * d)) == pytest.approx(fd, rel=2e-2)


def test_lbfgs_iterates_match_jax(stream_jax):
    """Two bounded L-BFGS iterates of the stream problem from tau0 through
    ``run_lbfgs``: the objective of every logged iterate and the stop
    reason as JAX's driver on the JAX objective."""
    grid, inv = _port_tauc(stream_jax, 0.0)
    res, opt = inv.run_lbfgs(_t(np.full(grid.shape2, 1.0e4)),
                             max_iterations=2, tauc_max=10 * F_DRIVE)
    Js = [r.J for r in opt.log]
    assert opt.reason == stream_jax["reason"]
    assert len(Js) == len(stream_jax["lbfgs"]) >= 2
    np.testing.assert_allclose(Js, stream_jax["lbfgs"], rtol=1e-6)
    assert Js[-1] < Js[0]
    assert [r.J_misfit for r in opt.log] == Js   # no regularization
    np.testing.assert_allclose(res.tau_c.numpy(), stream_jax["tau"],
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# the pieces without a solve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["h1", "l2", "tv"])
def test_regularization_matches_jax(kind):
    rng = np.random.default_rng(1)
    theta = rng.normal(size=(6, 9))
    prior = rng.normal(size=(6, 9))
    kw = dict(eps=0.1, grad_scale=2.5)
    for pr in (None, prior):
        ref = jinv.regularization_term(
            jnp.asarray(theta), kind, 0.7,
            prior=None if pr is None else jnp.asarray(pr), **kw)
        jg = jax.grad(lambda t: jinv.regularization_term(
            t, kind, 0.7, prior=None if pr is None else jnp.asarray(pr),
            **kw))(jnp.asarray(theta))
        J, g = tinv.value_and_grad(
            lambda t: tinv.regularization_term(
                t, kind, 0.7, prior=None if pr is None else _t(pr), **kw),
            _t(theta))
        assert float(J) == pytest.approx(float(ref), rel=1e-12)
        assert _rel(g, jg) <= 1e-12
    with pytest.raises(ValueError):
        tinv.regularization_term(_t(theta), "nope", 1.0)


@pytest.mark.parametrize("kind", ["ident", "square", "exp", "trunc"])
def test_parameterizations_match_jax(kind):
    vals = np.asarray([1.0e3, 5.0e4, 2.0e5])
    jp, tp = JParam(kind=kind, scale=1.0e5), Parameterization(kind=kind,
                                                              scale=1.0e5)
    z = tp.design(_t(vals))
    assert _rel(z, jp.design(jnp.asarray(vals))) <= 1e-12
    assert _rel(tp.value(z), jp.value(jnp.asarray(z.numpy()))) <= 1e-12
    _, g = tinv.value_and_grad(lambda t: torch.sum(tp.value(t)), z)
    jg = jax.grad(lambda t: jnp.sum(jp.value(t)))(jnp.asarray(z.numpy()))
    assert _rel(g, jg) <= 1e-12
    for design in ("tauc", "hardav"):
        over = {"inverse.design.param": kind}
        assert from_config(Config(over), design) == \
            Parameterization(**vars(jfrom_config(JConfig(over), design)))


def _bounded_quadratic():
    A = np.diag([1.0, 10.0, 100.0, 3.0])
    A[0, 3] = A[3, 0] = 0.5
    b = np.array([1.0, -2.0, 3.0, 0.5])

    def vg(x):
        x = np.asarray(x)
        return 0.5 * x @ A @ x - b @ x + 0.1 * np.sum(x ** 4), \
            A @ x - b + 0.4 * x ** 3

    return vg


@pytest.mark.parametrize("history,target", [(10, False), (2, False),
                                            (10, True)])
def test_lbfgs_matches_jax_to_the_bit(history, target):
    """The port's driver against JAX's on a bounded numpy objective: every
    log record and the stop reason, to the bit (with ``target``, the
    Morozov stop at the objective of JAX's fourth iterate)."""
    vg = _bounded_quadratic()
    kw = dict(value_and_grad=vg, lower=np.full(4, -1.0),
              upper=np.array([0.5, 1.0, 1.0, 2.0]), history=history,
              max_iterations=60, grtol=1e-12, gatol=1e-12,
              breakdown=lambda x: (vg(x)[0], 0.0))
    if target:
        kw["misfit_target"] = JLBFGS(**kw).run(np.zeros(4)).log[3].J
    ref = JLBFGS(**kw).run(np.zeros(4))
    got = BoundedLBFGS(**kw).run(np.zeros(4))
    assert got.reason == ref.reason and got.converged == ref.converged
    assert (got.reason == "target_misfit") == target
    assert len(got.log) == len(ref.log) >= 4
    for a, b in zip(got.log, ref.log):
        assert all(x == y or (x != x and y != y) for x, y in zip(a, b))
    assert np.array_equal(got.x, ref.x)


def test_lbfgs_takes_torch_values():
    """``value_and_grad`` may hand back torch tensors."""
    vg = _bounded_quadratic()

    def vg_torch(x):
        J, g = vg(x)
        return torch.tensor(J), torch.tensor(g)

    kw = dict(lower=np.full(4, -1.0), upper=np.full(4, 1.0),
              max_iterations=20)
    a = BoundedLBFGS(value_and_grad=vg, **kw).run(np.zeros(4))
    b = BoundedLBFGS(value_and_grad=vg_torch, **kw).run(np.zeros(4))
    assert np.array_equal(a.x, b.x) and a.reason == b.reason


def test_adam_matches_optax():
    """Five Adam steps against ``optax.adam`` on the same gradients,
    1e-12."""
    import optax
    rng = np.random.default_rng(4)
    p = rng.normal(size=(5, 4))
    grads = [rng.normal(size=(5, 4)) * 10.0 ** k for k in range(-2, 3)]
    opt = optax.adam(0.3)
    st = opt.init(jnp.asarray(p))
    jp = jnp.asarray(p)
    tp = _t(p)
    adam = tinv.Adam(0.3)
    tst = adam.init(tp)
    for g in grads:
        upd, st = opt.update(jnp.asarray(g), st)
        jp = optax.apply_updates(jp, upd)
        tupd, tst = adam.update(_t(g), tst)
        tp = tp + tupd
        assert _rel(tp, jp) <= 1e-12


# ---------------------------------------------------------------------------
# what the port's inverse refuses
# ---------------------------------------------------------------------------

def test_refusals():
    grid, ssa, state, tau_true = _stream("torch")
    geom32 = new_geometry(state.geometry.ice_thickness.float(),
                          state.geometry.bed_elevation.float())
    with pytest.raises(NotImplementedError, match="item 6"):
        tinv.make_differentiable_solve(ssa, ModelState(geometry=geom32))
    from pism_tpu_torch.parallel import make_mesh
    g2 = Grid(Mx=8, My=24, Lx=8e3, Ly=48e3)
    meshed = SSAFD(grid=g2, config=Config(), flow_law=IsothermalGlen(),
                   mesh=make_mesh(["cpu"] * 4, (2, 2)))
    with pytest.raises(NotImplementedError, match="item 10"):
        tinv.make_differentiable_solve(meshed, state)
    members = SSAFD(grid=g2, config=Config(), flow_law=IsothermalGlen(),
                    lead=1)
    with pytest.raises(NotImplementedError, match="item 3"):
        tinv.make_differentiable_solve(members, state)
