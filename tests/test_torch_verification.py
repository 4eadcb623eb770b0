"""The SIA verification path (path C), pism_tpu_torch against pism_tpu:
the exact solutions (Halfar B/C, and tests A, D, E, H, L of
``exact_steady``), Halfar test B through both packages' ``step_once``, and
the runner letters A, D, E, F, G, H, K, L and O (their report lines equal
but for the digits).

Tolerances. The exact solutions are numpy in both packages (test D's
compensatory accumulation, and test E's sliding flux divergence, are
automatic differentiation, ``torch.func`` against ``jax.grad``): equal to
1e-12 relative. The float64 Halfar run takes
the plain SIA path in both packages: equal steps and dt-limit hits, H within
1e-10 of max H (the SIA is a diffusion, so rounding differences do not
grow). The float32 run takes the fused kernel route in both packages
(``sia.pallas = on``: the TPU kernel in interpret mode, the port's K4 plain
version; see ``_HostGlen`` for how the JAX package is made to reach its
kernel inside its jitted step loop): equal steps, H within 1e-5 of max H, about 80 float32 ulps of the
dome after 30 steps. The runner letters run the plain path (Haseloff
gradients, bed smoother) in float64: H, and for test H the bed, within
1e-10 of max H; their error tables within 1e-6 relative (1e-9 absolute
for K's errors, which are at rounding level).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu import Config as JConfig, Grid as JGrid  # noqa: E402
from pism_tpu.coupler.surface import FunctionSurface as JFunctionSurface  # noqa: E402
from pism_tpu.model.icemodel import IceModel as JIceModel  # noqa: E402
from pism_tpu.physics.rheology import IsothermalGlen as JIsothermalGlen  # noqa: E402
from pism_tpu.state import ModelState as JModelState, new_geometry as j_new_geometry  # noqa: E402
from pism_tpu.verification import exact_steady as j_es  # noqa: E402
from pism_tpu.verification import halfar as j_halfar  # noqa: E402
from pism_tpu.verification import runner as j_runner  # noqa: E402
from pism_tpu_torch import setups  # noqa: E402
from pism_tpu_torch.verification import exact_steady as t_es  # noqa: E402
from pism_tpu_torch.verification import halfar as t_halfar  # noqa: E402
from pism_tpu_torch.verification import runner as t_runner  # noqa: E402

SPY = 3.15569259747e7
RADII = np.linspace(0.0, 900e3, 181).reshape(1, -1) * np.ones((2, 1))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("test", ["B", "C"])
def test_halfar_solution_matches(test):
    js, ts = getattr(j_halfar, f"test_{test}")(), getattr(t_halfar, f"test_{test}")()
    assert (ts.t0, ts.lam, ts.alpha, ts.beta) == (js.t0, js.lam, js.alpha, js.beta)
    for f in (0.6, 1.0, 1.7):
        He = js.thickness(f * js.t0, RADII)
        np.testing.assert_array_equal(ts.thickness(f * ts.t0, RADII), He)
    H = js.thickness(js.t0, RADII) * 1.01
    assert t_halfar.error_norms(H, He) == j_halfar.error_norms(H, He)


def test_exact_steady_solutions_match():
    for name in ("test_A", "test_L"):
        jc, tc = getattr(j_es, name)(), getattr(t_es, name)()
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    jA, tA = j_es.test_A(), t_es.test_A()
    np.testing.assert_array_equal(tA.thickness(RADII), jA.thickness(RADII))
    np.testing.assert_array_equal(tA.accumulation(RADII), jA.accumulation(RADII))
    jH, tH = j_es.test_H(), t_es.test_H()
    for t in (0.6 * jH.flat.t0, jH.flat.t0):
        np.testing.assert_array_equal(tH.thickness(t, RADII), jH.thickness(t, RADII))
        np.testing.assert_array_equal(tH.bed(t, RADII), jH.bed(t, RADII))
    jL, tL = j_es.test_L(), t_es.test_L()
    np.testing.assert_array_equal(tL.bed(RADII), jL.bed(RADII))
    assert _rel(tL.solve(RADII), jL.solve(RADII)) <= 1e-12


def test_D_compensatory_accumulation_matches():
    (jH, jM), (tH, tM) = j_es.make_test_D(), t_es.make_test_D()
    r = RADII[0]
    for years in (0.0, 700.0, 2500.0):
        t = years * SPY
        assert _rel(tH(t, r), jH(t, r)) <= 1e-12
        got = tM(t, torch.from_numpy(r)).numpy()
        assert _rel(got, np.asarray(jM(t, jnp.asarray(r)))) <= 1e-12


def test_E_sliding_cap_matches():
    """Test E's sliding velocity and compensatory accumulation (the
    divergence of H u_b by automatic differentiation) on the runner's
    61x61 grid, the origin and the sector's edges among its points."""
    jE, tE = j_es.test_E(), t_es.test_E()
    assert dataclasses.asdict(tE) == dataclasses.asdict(jE)
    x = np.linspace(-900e3, 900e3, 61)
    X, Y = np.meshgrid(x, x)
    for a, b in zip(tE.sliding_velocity(X, Y), jE.sliding_velocity(X, Y)):
        assert _rel(a, b) <= 1e-12 and np.abs(b).max() > 0
    M = jE.accumulation(X, Y)
    assert _rel(tE.accumulation(X, Y), M) <= 1e-12
    np.testing.assert_array_equal(tE.thickness(RADII), jE.thickness(RADII))


class _HostGlen(JIsothermalGlen):
    """The JAX package's isothermal Glen law with its softness as a host
    constant of the field dtype. The JAX kernel route reads A as
    ``float(flow_law.softness(jnp.zeros((), H.dtype), ...))``
    (``pism_tpu/ops/sia.py:265``), which raises under the ``jit`` of
    ``IceModel.step_once`` (a traced value); the same A, rounded to the
    field dtype, given as a numpy value lets it reach the kernel there."""

    def softness(self, E, p):
        return np.asarray(self.A, dtype=np.dtype(E.dtype))


def _jax_halfar(Mx, dtype, extra=None):
    """The CLI's ``-test B`` run in the JAX package with the port's
    ``halfar_model`` config (Mahaffy gradients, ``HALFAR_CFG``)."""
    sol = j_halfar.test_B()
    grid = JGrid(Mx=Mx, My=Mx, Lx=900e3, Ly=900e3)
    cfg = JConfig({
        "stress_balance.model": "sia",
        "stress_balance.sia.flow_law": "isothermal_glen",
        "flow_law.isothermal_Glen.ice_softness": j_halfar.A_SOFTNESS,
        "stress_balance.sia.surface_gradient_method": "mahaffy",
        "energy.model": "none",
        "runtime.float_dtype": dtype,
        **setups.HALFAR_CFG, **(extra or {})})
    jdt = jnp.float32 if dtype == "float32" else jnp.float64
    H0 = jnp.asarray(sol.thickness(sol.t0, grid.radius), jdt)
    state = JModelState(geometry=j_new_geometry(H0, jnp.zeros(grid.shape2, jdt)))
    model = JIceModel(grid=grid, config=cfg, surface=JFunctionSurface(
        lambda g, t: (jnp.zeros_like(g.ice_thickness),
                      jnp.full(g.ice_thickness.shape, 263.15))))
    law = model.stress_balance.sia_flow_law
    model.stress_balance.sia_flow_law = _HostGlen(n=law.n, EC=law.EC, A=law.A)
    return model, state, sol


@pytest.mark.parametrize("Mx,dtype,years,pallas,tol", [
    (31, "float64", 300.0, "auto", 1e-10),
    (21, "float32", 300.0, "on", 1e-5),
])
def test_halfar_B_chain_matches(Mx, dtype, years, pallas, tol):
    extra = {"stress_balance.sia.pallas": pallas}
    jm, js, sol = _jax_halfar(Mx, dtype, extra)
    js, tj, sj = jm.step_once(js, sol.t0, years * SPY)
    tm, ts, grid, tsol = setups.halfar_model("B", Mx=Mx, dtype=dtype,
                                             device="cpu", extra_cfg=extra)
    assert tsol.t0 == sol.t0
    ts, tt, st = tm.step_once(ts, tsol.t0, years * SPY)
    Hj = np.asarray(js.geometry.ice_thickness, np.float64)
    Ht = ts.geometry.ice_thickness.double().numpy()
    assert ts.geometry.ice_thickness.dtype == getattr(torch, dtype)
    assert st.nsteps == int(sj.nsteps) > 10
    assert st.limit_hits_dict() == {k: int(v) for k, v in
                                    sj.limit_hits_dict().items() if int(v)}
    assert abs(tt - float(tj)) <= 1e-6
    assert np.abs(Ht - Hj).max() <= tol * Hj.max()
    # zero SMB: the flux form conserves volume to rounding
    H0 = tsol.thickness(tsol.t0, grid.radius)
    assert abs(Ht.sum() - H0.sum()) <= (1e-12 if dtype == "float64" else 1e-5) \
        * H0.sum()
    # the report's norms are the JAX package's on the port's H (avg_H counts
    # the icy cells, so H within 1e-12 of 0 in one package and 0 in the
    # other changes it: the two packages' H are compared above)
    errs = setups.halfar_report(tsol, ts, grid, tt)
    assert errs == j_halfar.error_norms(Ht, sol.thickness(tt, grid.radius))


def _capture(monkeypatch, cls):
    """Record (state, stats) of each ``step_once`` and ``run`` of the
    IceModel class ``cls``: the runner letters' final states."""
    out = []
    for name in ("step_once", "run"):
        def wrap(self, *a, _real=getattr(cls, name), **k):
            res = _real(self, *a, **k)
            out.append((res[0], res[-1]))
            return res
        monkeypatch.setattr(cls, name, wrap)
    return out


def _jit_jax_btu(monkeypatch):
    """The JAX package's BTUFull.step under ``jax.jit``, one compile per
    unit: its runner's K loop calls it eagerly 200 times, ~0.3 s a call
    on the CPU."""
    import jax
    from pism_tpu.model.btu import BTUFull

    real, cache = BTUFull.step, {}

    def step(self, *a):
        if id(self) not in cache:
            cache[id(self)] = (self, jax.jit(lambda *x: real(self, *x)))
        return cache[id(self)][1](*a)
    monkeypatch.setattr(BTUFull, "step", step)


#: runner letters with their sizes: the isothermal letters and E at 21x21
#: for 100 a, F and G at 21x21x11 for 100 a, K and O on 11 levels at the
#: JAX runner's 300,000 a
LETTERS = [("A", {"Mx": 21, "years": 100.0}), ("D", {"Mx": 21, "years": 100.0}),
           ("H", {"Mx": 21, "years": 100.0}), ("L", {"Mx": 21, "years": 100.0}),
           ("E", {"Mx": 21, "years": 100.0}),
           ("F", {"Mx": 21, "Mz": 11, "years": 100.0}),
           ("G", {"Mx": 21, "Mz": 11, "years": 100.0}),
           ("K", {"Mz": 11}), ("O", {"Mz": 11})]


@pytest.mark.parametrize("letter,kw", LETTERS, ids=[x for x, _ in LETTERS])
def test_runner_letters_match(letter, kw, monkeypatch, capsys):
    """Equal error tables (1e-6 relative) and report lines (but for the
    digits); where the letter runs the model, equal steps and H (for test
    H the bed too) within 1e-10 of max H."""
    import re
    from pism_tpu_torch.model.icemodel import IceModel

    jout, tout = _capture(monkeypatch, JIceModel), _capture(monkeypatch,
                                                           IceModel)
    if letter == "K":
        _jit_jax_btu(monkeypatch)
    je = j_runner.run_test(letter, **kw)
    jtext = capsys.readouterr().out
    te = t_runner.run_test(letter, device="cpu", **kw)
    ttext = capsys.readouterr().out
    digits = re.compile(r"[-+]?\d+\.\d+(e[-+]?\d+)?")
    assert digits.sub("#", ttext) == digits.sub("#", jtext)
    assert ttext.startswith(f"NUMERICAL ERRORS in test {letter} ")
    assert te == pytest.approx(je, rel=1e-6, abs=1e-9)
    assert len(tout) == (0 if letter in "KO" else 1)
    if not tout:
        return
    (js, jst), (ts, tst) = jout[-1], tout[0]
    assert tst.nsteps == int(jst.nsteps) > 0
    Hj = np.asarray(js.geometry.ice_thickness)
    Ht = ts.geometry.ice_thickness.numpy()
    assert np.abs(Ht - Hj).max() <= 1e-10 * Hj.max()
    if letter == "H":
        bj = np.asarray(js.geometry.bed_elevation)
        bt = ts.geometry.bed_elevation.numpy()
        assert np.abs(bt - bj).max() <= 1e-10 * Hj.max()


def test_unported_letters_raise():
    """B and C are ``setups.halfar_model``, not runner letters (P, the
    routing hydrology, is one: ``tests/test_torch_hydrology.py``)."""
    for letter in ("B", "C"):
        with pytest.raises(NotImplementedError):
            t_runner.run_test(letter, Mx=21, years=1.0, device="cpu")
    with pytest.raises(NotImplementedError):
        setups.halfar_model("A", Mx=21, device="cpu")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_uniform_surface_matches(dtype):
    from pism_tpu.coupler.surface import Uniform as JUniform
    from pism_tpu_torch.coupler.surface import Uniform
    from pism_tpu_torch.state import new_geometry

    H = np.linspace(0.0, 3000.0, 12, dtype=dtype).reshape(3, 4)
    kw = dict(smb=0.3 / SPY, temperature=250.5)
    ref = JUniform(**kw)(j_new_geometry(jnp.asarray(H), jnp.zeros_like(H)), 0.0)
    Ht = torch.from_numpy(H)
    got = Uniform(**kw)(new_geometry(Ht, torch.zeros_like(Ht)), 0.0)
    for g, r in ((got.smb, ref.smb), (got.temperature, ref.temperature)):
        assert g.dtype == Ht.dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
