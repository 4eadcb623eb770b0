"""The Blatter-Pattyn solver, pism_tpu_torch against pism_tpu on the CPU in
float64:

- the residual with metric terms and the calving-front stress condition on
  a mask of grounded, floating, ice-free land and open-ocean cells within
  1e-10; the Newton matvec (the Jacobian written out, beta frozen) against
  ``jax.jvp`` of the JAX residual within 1e-10; the vertical-line
  preconditioner's a, b and c within 1e-12 (the JAX solve's batched
  Thomas call's arguments captured);
- ``vertical_average`` and ``regrid_to_z`` within 1e-14;
- ``tests/test_blatter.py``'s slab (SIA limit), plug (SSA limit), floating
  shelf (van der Veen strain rate and SSAFD) and wavy bed (metric terms)
  under that file's bounds, each against the JAX solve: equal Newton
  sweeps and velocities within 1e-6 of max|u|;
- the Glen exponent's inheritance from the SSA's, and the refusals on an
  ensemble's member axis and under a mesh.

The XZ problems, the composite model and ISMIP-HOM are
``tests/test_torch_ismip_hom.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pism_tpu import Config as JConfig, Grid as JGrid
from pism_tpu.model.blatter import BlatterSolver as JBlatter
from pism_tpu.physics.rheology import IsothermalGlen as JGlen
from pism_tpu.state import ModelState as JState, new_geometry as j_geom

import pism_tpu_torch as pt
from pism_tpu_torch.model.blatter import BlatterSolver
from pism_tpu_torch.physics.rheology import IsothermalGlen
from pism_tpu_torch.state import ModelState, new_geometry

SPY = 3.15569259747e7
A = 1e-16 / SPY
RHO, G = 910.0, 9.81


def _f(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-300)


def _pair(grid_kw, cfg, H, bed, law_kw=None, **solver_kw):
    """The JAX and port solvers and states of one problem; ``solver_kw``
    values are numpy arrays (or None)."""
    gj, gt = JGrid(**grid_kw), pt.Grid(**grid_kw)
    law_kw = law_kw or {"A": A}
    sj = JBlatter(grid=gj, config=JConfig(cfg), flow_law=JGlen(**law_kw),
                  **{k: None if v is None else jnp.asarray(v)
                     for k, v in solver_kw.items()})
    st = BlatterSolver(grid=gt, config=pt.Config(cfg),
                       flow_law=IsothermalGlen(**law_kw),
                       **{k: None if v is None else (
                           torch.as_tensor(v) if v.dtype == bool else _f(v))
                          for k, v in solver_kw.items()})
    return (sj, JState(geometry=j_geom(jnp.asarray(H), jnp.asarray(bed)))), \
        (st, ModelState(geometry=new_geometry(_f(H), _f(bed))))


def _solve_both(pair, tau_c):
    (sj, xj), (st, xt) = pair
    uj, vj, ij = sj.solve(xj, jnp.asarray(tau_c), diagnostics=True)
    ut, vt, it = st.solve(xt, _f(tau_c), diagnostics=True)
    return (np.asarray(uj), np.asarray(vj), int(ij["newton_iters"])), \
        (ut.numpy(), vt.numpy(), it["newton_iters"], it)


def _agree(rj, rt):
    assert rt[2] == rj[2]
    scale = np.abs(rj[0]).max()
    assert np.abs(rj[0] - rt[0]).max() <= 1e-6 * scale
    assert np.abs(rj[1] - rt[1]).max() <= 1e-6 * scale


# -- the residual, its Jacobian and the preconditioner -----------------------

@pytest.fixture(scope="module")
def mixed():
    """An 8 x 9 x 6 grid with grounded ice on a sloping bed, a floating
    tongue, ice-free land and open ocean; metric terms and the
    calving-front condition on. The JAX solve runs one sweep of 3 Krylov
    iterations, its preconditioner's arguments captured."""
    import pism_tpu.model.blatter as j_blatter

    My, Mx = 8, 9
    x = np.arange(Mx)[None, :] * np.ones((My, 1))
    y = np.arange(My)[:, None] * np.ones((1, Mx))
    bed = 300.0 - 150.0 * x + 20.0 * np.sin(y)
    H = 900.0 - 60.0 * x + 15.0 * np.cos(1.3 * y)
    H[:, 6:] = 120.0              # floats over the deep bed
    H[:, 8:] = 0.0                # open ocean
    H[:2, :2] = 0.0               # ice-free land
    cfg = {"stress_balance.ssa.fd.ksp_max_it": 3,
           "stress_balance.blatter.newton_max_iterations": 1}
    rng = np.random.default_rng(2)
    tau_c = 5e4 + 5e4 * rng.random((My, Mx))
    pair = _pair(dict(Mx=Mx, My=My, Lx=40e3, Ly=35e3, Mz=6, Lz=1500.0),
                 cfg, H, bed)
    (sj, xj), (st, xt) = pair
    captured = []
    orig = j_blatter.solve_batched

    def capture(a, b, c, d):
        # a host callback, so that the solve runs compiled
        jax.debug.callback(lambda *abc: captured.append(
            tuple(np.asarray(x) for x in abc)), a, b, c)
        return orig(a, b, c, d)

    j_blatter.solve_batched = capture
    try:
        _, _, ij = sj.solve(xj, jnp.asarray(tau_c), diagnostics=True)
        jax.effects_barrier()
    finally:
        j_blatter.solve_batched = orig
    _, _, it = st.solve(xt, _f(tau_c), diagnostics=True)
    mask = np.asarray(xj.geometry.cell_type)
    assert set(np.unique(mask)) == {0, 2, 3, 4}
    return dict(ij=ij, it=it, abc=captured[0], shape=(My, Mx, 6), rng=rng)


def test_residual_matches(mixed):
    rng, shape = mixed["rng"], mixed["shape"]
    for scale in (0.0, 100.0):
        uv = tuple(rng.normal(size=shape) * scale / SPY for _ in range(2))
        Fj = mixed["ij"]["residual_fn"](tuple(jnp.asarray(a) for a in uv))
        Ft = mixed["it"]["residual_fn"](tuple(_f(a) for a in uv))
        for a, b in zip(Fj, Ft):
            assert _rel(a, b) <= 1e-10


def test_jacobian_matches_jvp(mixed):
    rng, shape = mixed["rng"], mixed["shape"]
    uv = tuple(rng.normal(size=shape) * 100.0 / SPY for _ in range(2))
    d = tuple(rng.normal(size=shape) / SPY for _ in range(2))
    _, Jj = jax.jvp(mixed["ij"]["residual_fn"],
                    (tuple(jnp.asarray(a) for a in uv),),
                    (tuple(jnp.asarray(a) for a in d),))
    Jt = mixed["it"]["jacobian_fn"](tuple(_f(a) for a in uv),
                                    tuple(_f(a) for a in d))
    for a, b in zip(Jj, Jt):
        assert _rel(a, b) <= 1e-10


def test_preconditioner_matches(mixed):
    """a, b, c of the first sweep (at the zero iterate)."""
    zero = torch.zeros(mixed["shape"], dtype=torch.float64)
    for a, b in zip(mixed["abc"], mixed["it"]["precond_fn"]((zero, zero))):
        assert _rel(a, b) <= 1e-12


def test_column_helpers_match():
    kw = dict(Mx=5, My=4, Lx=10e3, Ly=10e3, Mz=9, Lz=3000.0)
    sj = JBlatter(JGrid(**kw), JConfig(), JGlen(A=A))
    st = BlatterSolver(pt.Grid(**kw), pt.Config(), IsothermalGlen(A=A))
    rng = np.random.default_rng(3)
    f3 = rng.normal(size=(4, 5, 9))
    H = rng.random((4, 5)) * 3500.0
    H[0, 0] = 0.0
    assert _rel(sj.vertical_average(jnp.asarray(f3)),
                st.vertical_average(_f(f3))) <= 1e-14
    assert _rel(sj.regrid_to_z(jnp.asarray(f3), jnp.asarray(H)),
                st.regrid_to_z(_f(f3), _f(H))) <= 1e-14


# -- tests/test_blatter.py's problems ---------------------------------------

def _slab(Mz, H0=1000.0):
    return dict(Mx=8, My=8, Lx=40e3, Ly=40e3, Mz=Mz, Lz=H0,
                vertical_spacing="equal", periodicity="xy")


def test_sia_limit_shear_profile():
    H0, slope = 1000.0, 0.02
    taud = RHO * G * H0 * slope
    kw = _slab(25, H0)
    rj, rt = _solve_both(_pair(
        kw, {"basal_resistance.plastic.regularization": 1e-4},
        np.full((8, 8), H0), np.zeros((8, 8)), taud_x=np.full((8, 8), taud),
        taud_y=np.zeros((8, 8))), np.full((8, 8), 1e8))
    _agree(rj, rt)
    z = np.asarray(pt.Grid(**kw).z)
    exact = (A / 2.0) * (RHO * G * slope) ** 3 * (H0 ** 4 - (H0 - z) ** 4)
    got = rt[0][4, 4]
    assert got[-1] * SPY == pytest.approx(exact[-1] * SPY, rel=0.08)
    assert got[0] * SPY < 0.05 * got[-1] * SPY
    assert np.all(np.diff(got) >= -1e-12)
    assert got[12] * SPY == pytest.approx(exact[12] * SPY, rel=0.12)
    assert np.abs(rt[1]).max() * SPY < 1e-3


def test_ssa_limit_plug_flow():
    H0, slope = 1000.0, 0.002
    taud = RHO * G * H0 * slope
    tau_c = 2.0 * taud
    rj, rt = _solve_both(_pair(
        _slab(15, H0), {"basal_resistance.plastic.regularization": 100.0},
        np.full((8, 8), H0), np.zeros((8, 8)), taud_x=np.full((8, 8), taud),
        taud_y=np.zeros((8, 8))), np.full((8, 8), tau_c))
    _agree(rj, rt)
    got = rt[0][4, 4]
    u_expect = 100.0 / SPY * taud / np.sqrt(tau_c ** 2 - taud ** 2)
    assert got[0] * SPY == pytest.approx(u_expect * SPY, rel=0.05)
    assert (got[-1] - got[0]) / got[0] < 0.25


def test_cfbc_floating_shelf_van_der_veen():
    from pism_tpu_torch.model.ssa import SSAFD

    H0, Mx, My = 500.0, 24, 6
    kw = dict(Mx=Mx, My=My, Lx=60e3, Ly=15e3, Mz=13, Lz=H0,
              vertical_spacing="equal", periodicity="y")
    H = np.full((My, Mx), H0)
    H[:, -6:] = 0.0
    bed = np.full((My, Mx), -2000.0)
    bc = np.zeros((My, Mx), bool)
    bc[:, :3] = True
    pair = _pair(kw, {}, H, bed, bc_mask=bc)
    rj, rt = _solve_both(pair, np.zeros((My, Mx)))
    _agree(rj, rt)
    u = rt[0]
    ux_exact = A * (RHO * G * (1.0 - RHO / 1028.0) * H0 / 4.0) ** 3
    front = Mx - 7
    got_ux = (u[3, front - 5, 6] - u[3, front - 6, 6]) / pt.Grid(**kw).dx
    assert got_ux == pytest.approx(ux_exact, rel=0.15)
    st, xt = pair[1]
    z = torch.zeros((My, Mx), dtype=torch.float64)
    ssa = SSAFD(grid=st.grid, config=pt.Config(), flow_law=IsothermalGlen(A=A),
                bc_mask=torch.as_tensor(bc), bc_u=z, bc_v=z)
    us = ssa.solve(xt, z)[0].numpy()
    cols = slice(4, front + 1)
    assert (np.abs(u[3, cols, 6] - us[3, cols]) * SPY).max() \
        < 0.10 * np.abs(us[3, cols]).max() * SPY


def test_metric_terms_wavy_bed():
    H0, amp, slope, Mx = 1000.0, 250.0, 0.01, 32
    kw = dict(Mx=Mx, My=6, Lx=80e3, Ly=15e3, Mz=21, Lz=2 * H0,
              vertical_spacing="equal", periodicity="xy")
    x = np.asarray(pt.Grid(**kw).x)
    H = np.tile(H0 + amp * np.sin(2 * np.pi * x / 80e3), (6, 1))
    taud = RHO * G * H * slope

    def pair(metric):
        return _pair(kw, {"basal_resistance.plastic.regularization": 1e-4,
                          "stress_balance.blatter.metric_terms": metric},
                     H, 2 * H0 - H, taud_x=taud, taud_y=np.zeros((6, Mx)))

    rj, rt = _solve_both(pair(True), np.full((6, Mx), 1e8))
    _agree(rj, rt)
    us = rt[0][3, :, -1] * SPY
    k_thick, k_thin = int(np.argmax(H[3])), int(np.argmin(H[3]))
    assert us[k_thick] > 0.99 * us.max()
    assert 1.5 < us[k_thick] / us[k_thin] < (H[3, k_thick] / H[3, k_thin]) ** 4
    (st, xt) = pair(False)[1]
    u_off = st.solve(xt, _f(np.full((6, Mx), 1e8)))[0].numpy()
    rel = np.abs(rt[0] - u_off).max() / np.abs(rt[0]).max()
    assert 0.005 < rel < 0.5


def test_glen_exponent_inherits_ssa_value():
    grid = pt.Grid(**_slab(5))
    flow = IsothermalGlen(A=A, n=1.0)
    cfg = pt.Config({"stress_balance.ssa.Glen_exponent": 1.0})
    assert BlatterSolver(grid, cfg, flow).n_glen == 1.0
    cfg2 = pt.Config({"stress_balance.ssa.Glen_exponent": 1.0,
                      "stress_balance.blatter.Glen_exponent": 2.0})
    assert BlatterSolver(grid, cfg2, flow).n_glen == 2.0
    assert BlatterSolver(grid, pt.Config.from_json(cfg.to_json()),
                         flow).n_glen == 1.0
    assert BlatterSolver(grid, pt.Config(), flow).n_glen == 3.0
    for c in (cfg, cfg2, pt.Config()):
        assert BlatterSolver(grid, c, flow).n_glen == JBlatter(
            JGrid(**_slab(5)), JConfig(c.non_default()), JGlen(A=A)).n_glen


@pytest.mark.parametrize("where", ["member axis", "mesh"])
def test_blatter_refused_on_member_axis_and_mesh(where):
    """``stress_balance.model = blatter`` in an ensemble and under a mesh
    raises, naming ROADMAP Queue 1 items 3 and 10."""
    from pism_tpu_torch.coupler.surface import Uniform
    from pism_tpu_torch.model.icemodel import IceModel
    from pism_tpu_torch.parallel import make_mesh

    cfg = pt.Config({"stress_balance.model": "blatter",
                     "energy.model": "enthalpy"})
    kw = {"member_axis": True} if where == "member axis" \
        else {"mesh": make_mesh(["cpu"] * 4, (2, 2))}
    with pytest.raises(NotImplementedError,
                       match="item 3" if where == "member axis" else "item 10"):
        IceModel(grid=pt.Grid(Mx=8, My=8, Lx=1e5, Ly=1e5, Mz=5, Lz=3000.0),
                 config=cfg, surface=Uniform(smb=0.0), device="cpu", **kw)
