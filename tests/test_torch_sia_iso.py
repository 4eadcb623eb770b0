"""K4, the fused isothermal SIA kernel: its plain version in pism_tpu_torch
against the TPU kernel ``sia_flux_pallas`` run in interpret mode, on the
setup of tests/test_pallas.py (the Halfar test-B dome at t0 on 61x61 over
the 1800 km square), with and without a diffusivity cap; the isothermal
branch of ``ops.sia.diffusivity`` against the JAX package's; the
wrapper's max of D; the routing of K4 under ``stress_balance.sia.pallas``;
and the ``IsothermalGlen`` law.

Tolerances: 1e-12 of the largest value in float64 (rounding only); 2e-5 in
float32, the reference's own tolerance for this kernel
(tests/test_pallas.py:76-89).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu import Config as JConfig, Grid as JGrid  # noqa: E402
from pism_tpu.ops import sia as j_sia  # noqa: E402
from pism_tpu.ops.pallas_kernels import sia_flux_pallas  # noqa: E402
from pism_tpu.ops.stencils import Shifter as JShifter  # noqa: E402
from pism_tpu.physics import rheology as j_rh  # noqa: E402
from pism_tpu.state import new_geometry as j_new_geometry  # noqa: E402
from pism_tpu.verification import halfar  # noqa: E402
import pism_tpu_torch as pt  # noqa: E402
from pism_tpu_torch.ops import sia as t_sia  # noqa: E402
from pism_tpu_torch.ops.kernels import sia_iso as K4  # noqa: E402
from pism_tpu_torch.ops.stencils import Shifter  # noqa: E402
from pism_tpu_torch.physics import rheology as t_rh  # noqa: E402
from pism_tpu_torch.state import new_geometry  # noqa: E402

TOL = {np.float64: 1e-12, np.float32: 2e-5}
GRID = dict(Mx=61, My=61, Lx=900e3, Ly=900e3)


def _inputs(dtype, seed=4):
    """The Halfar dome at t0 plus surface noise on the ice (an irregular
    surface exercises both gradient components on every face)."""
    grid = JGrid(**GRID)
    sol = halfar.test_B()
    H = sol.thickness(sol.t0, grid.radius)
    rng = np.random.default_rng(seed)
    s = H + rng.uniform(0.0, 5.0, size=H.shape) * (H > 0)
    return grid, H.astype(dtype), s.astype(dtype)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("d_cap", [None, 1.0])
def test_plain_matches_tpu_kernel(d_cap, dtype):
    grid, H, s = _inputs(dtype)
    kw = dict(A=halfar.A_SOFTNESS, n=3.0, enhancement=1.5, rho=910.0,
              g=9.81, dx=grid.dx, dy=grid.dy, d_cap=d_cap)
    ref = sia_flux_pallas(jnp.asarray(H), jnp.asarray(s), interpret=True, **kw)
    got = K4.sia_flux(torch.from_numpy(H), torch.from_numpy(s), **kw)
    for g, r in zip(got, ref):     # De, Dn, qe, qn, max_D
        assert g.dtype == torch.from_numpy(H).dtype
        assert _rel(g, r) <= TOL[dtype]
    if d_cap is not None:
        assert float(got[4]) == pytest.approx(d_cap)   # the cap binds
    else:
        assert float(got[4]) > 2.0
    # the plain version itself, in the kernel's output order
    gam = K4.gamma(halfar.A_SOFTNESS, 3.0, 1.5, 910.0, 9.81)
    plain = K4.sia_flux_plain(torch.from_numpy(H), torch.from_numpy(s),
                              gamma=gam, n=3.0, dx=grid.dx, dy=grid.dy,
                              d_cap=d_cap)
    for g, r in zip(plain, (ref[2], ref[3], ref[0], ref[1])):
        assert _rel(g, r) <= TOL[dtype]


@pytest.mark.parametrize("n", [3.0, 1.0])
def test_ice_free_faces(n):
    """H = 0 faces give D = 0 and q = 0 (0^(n+2) = 0), and a flat surface
    gives D = 0 for n > 1 (0^((n-1)/2) = 0) and finite D for n = 1."""
    H = torch.zeros(6, 7, dtype=torch.float64)
    H[2:4, 2:5] = 1000.0
    s = H.clone()
    De, Dn, qe, qn, max_D = K4.sia_flux(H, s, A=1e-16, n=n, dx=1e3, dy=1e3)
    for x in (De, Dn, qe, qn):
        assert bool(torch.isfinite(x).all())
    assert float(De[0, 0]) == float(qe[0, 0]) == 0.0
    flat = K4.sia_flux(torch.full((4, 4), 500.0, dtype=torch.float64),
                       torch.full((4, 4), 500.0, dtype=torch.float64),
                       A=1e-16, n=n, dx=1e3, dy=1e3)
    assert float(flat[4]) == (0.0 if n > 1 else pytest.approx(
        K4.gamma(1e-16, n) * 500.0 ** (n + 2.0)))


def test_wrapper_checks_shapes_and_types():
    grid, H, s = _inputs(np.float64)
    H, s = torch.from_numpy(H), torch.from_numpy(s)
    kw = dict(A=halfar.A_SOFTNESS, dx=grid.dx, dy=grid.dy)
    with pytest.raises(ValueError):
        K4.sia_flux(H, s[:-1], **kw)
    with pytest.raises(TypeError):
        K4.sia_flux(H.float(), s, **kw)
    with pytest.raises(ValueError):
        K4.sia_flux(H.T, s, **kw)
    with pytest.raises(TypeError):
        K4.sia_flux(H.to(torch.int64), s.to(torch.int64), **kw)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("nan", [False, True])
def test_max_D_is_the_faces_max(nan, dtype):
    """``max_D`` is torch.maximum(torch.max(De), torch.max(Dn)): a NaN
    thickness makes it NaN; the per-shard entry point returns the faces
    only."""
    grid, H, s = _inputs(dtype)
    if nan:
        H[20, 30] = np.nan
    kw = dict(A=halfar.A_SOFTNESS, dx=grid.dx, dy=grid.dy)
    H, s = torch.from_numpy(H), torch.from_numpy(s)
    De, Dn, qe, qn, max_D = K4.sia_flux(H, s, **kw)
    assert max_D.shape == () and max_D.dtype == De.dtype
    assert bool(torch.isnan(max_D)) == nan
    if not nan:
        assert float(max_D) > 0.0
        assert torch.equal(max_D, torch.maximum(De.max(), Dn.max()))
    faces = K4.sia_flux_faces(H, s, **kw)
    assert len(faces) == 4
    for g, r in zip(faces, (qe, qn, De, Dn)):
        assert torch.equal(g.nan_to_num(), r.nan_to_num())


def _laws(A=halfar.A_SOFTNESS):
    return j_rh.IsothermalGlen(A=A), t_rh.IsothermalGlen(A=A)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("method", ["mahaffy", "haseloff"])
@pytest.mark.parametrize("extras", ["none", "theta+cap"])
def test_isothermal_diffusivity_matches_jax(dtype, method, extras):
    """The plain isothermal branch (K = e A H^(n+2) / (n+2)) against the
    JAX package's ``diffusivity(enthalpy=None)`` on its plain path."""
    jgrid, H, s = _inputs(dtype)
    grid = pt.Grid(**GRID)
    jlaw, tlaw = _laws()
    theta = (0.5 + 0.5 * np.random.default_rng(1).uniform(size=H.shape)
             ).astype(dtype) if extras != "none" else None
    d_limit = 1.0 if extras != "none" else None
    kw = dict(n=3.0, enhancement=1.5, gradient_method=method, d_limit=d_limit)
    ref = j_sia.diffusivity(
        jlaw, j_new_geometry(jnp.asarray(H), jnp.asarray(s - H)), None, jgrid,
        JShifter(jgrid), pallas=False,
        theta_e=None if theta is None else jnp.asarray(theta),
        theta_n=None if theta is None else jnp.asarray(theta), **kw)
    got = t_sia.diffusivity(
        tlaw, new_geometry(torch.from_numpy(H), torch.from_numpy(s - H)), None,
        grid, Shifter(grid), pallas=False,
        theta_e=None if theta is None else torch.from_numpy(theta),
        theta_n=None if theta is None else torch.from_numpy(theta), **kw)
    for name in ("De", "Dn", "qe", "qn", "max_D"):
        g, r = getattr(got, name), getattr(ref, name)
        assert g.dtype == torch.from_numpy(H).dtype
        assert _rel(g, r) <= TOL[dtype], name


@pytest.mark.parametrize("pallas", [None, True, False])
def test_routing_on_cpu(pallas, monkeypatch):
    """``auto`` (None) and ``off`` take the plain path on CPU tensors; ``on``
    takes K4's route, whose CPU path is K4's plain version, and drops the
    bed-smoother theta as the JAX package does."""
    _, H, s = _inputs(np.float64)
    grid = pt.Grid(**GRID)
    geom = new_geometry(torch.from_numpy(H), torch.from_numpy(s - H))
    _, law = _laws()
    calls = []
    real = K4.sia_flux
    monkeypatch.setattr(K4, "sia_flux",
                        lambda *a, **k: calls.append(k["A"]) or real(*a, **k))
    theta = torch.full(grid.shape2, 0.5, dtype=torch.float64)
    kw = dict(gradient_method="mahaffy", enhancement=1.5, d_limit=None)
    sh = Shifter(grid)
    with_theta = t_sia.diffusivity(law, geom, None, grid, sh, pallas=pallas,
                                   theta_e=theta, theta_n=theta, **kw)
    without = t_sia.diffusivity(law, geom, None, grid, sh, pallas=pallas, **kw)
    assert len(calls) == (2 if pallas else 0)
    if pallas:
        assert torch.equal(with_theta.De, without.De)
    else:
        torch.testing.assert_close(with_theta.De, 0.5 * without.De,
                                   rtol=1e-15, atol=0.0)
    gam = K4.gamma(halfar.A_SOFTNESS, enhancement=1.5)
    ref = K4.sia_flux_plain(geom.ice_thickness, geom.ice_surface_elevation,
                            gamma=gam, dx=grid.dx, dy=grid.dy)
    for g, r in zip((without.qe, without.qn, without.De, without.Dn), ref):
        assert _rel(g, r) <= 1e-12


def test_kernel_route_rounds_A_to_the_field_dtype(monkeypatch):
    """In float32 the JAX package reads A as a float32 value before it forms
    gamma in float64 (``pism_tpu/ops/sia.py:265-266``); so does the port."""
    _, H, s = _inputs(np.float32)
    grid = pt.Grid(**GRID)
    geom = new_geometry(torch.from_numpy(H), torch.from_numpy(s - H))
    seen = []
    real = K4.sia_flux
    monkeypatch.setattr(K4, "sia_flux",
                        lambda *a, **k: seen.append(k["A"]) or real(*a, **k))
    t_sia.diffusivity(_laws()[1], geom, None, grid, Shifter(grid), pallas=True)
    assert seen == [float(np.float32(halfar.A_SOFTNESS))]
    assert seen[0] != halfar.A_SOFTNESS


def _fake(device, dtype):
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype)


@pytest.mark.parametrize("case,eligible", [
    ({}, True),
    ({"H": _fake("cpu", torch.float32)}, False),
    ({"H": _fake("cuda", torch.float64)}, False),
    ({"gradient_method": "haseloff"}, False),
    ({"theta": True}, False),
    ({"enhancement": torch.ones(3)}, False),
    ({"periodicity": "y"}, False),
])
def test_iso_auto_rule(case, eligible):
    """``auto`` takes K4 exactly where the JAX package's ``_pallas_eligible``
    takes its isothermal kernel, with a CUDA card for the TPU and no
    cell-count limit: a 601x601 grid is eligible."""
    grid = pt.Grid(Mx=601, My=601, Lx=900e3, Ly=900e3,
                   periodicity=case.get("periodicity", "none"))
    theta = torch.ones(2) if case.get("theta") else None
    args = (grid, case.get("H", _fake("cuda", torch.float32)),
            case.get("gradient_method", "mahaffy"), theta, theta,
            case.get("enhancement", 1.0))
    assert t_sia._iso_kernel_eligible(*args) is eligible


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_isothermal_glen_matches_jax(dtype):
    jlaw, tlaw = _laws(2.5e-24)
    E = np.linspace(0.0, 1e5, 7).astype(dtype)
    for args in ((E, E), (np.zeros((), dtype), np.zeros((), dtype))):
        for fn in ("softness", "hardness"):
            r = np.array(getattr(jlaw, fn)(*(jnp.asarray(a) for a in args)))
            g = getattr(tlaw, fn)(*(torch.from_numpy(np.asarray(a))
                                    for a in args))
            assert g.dtype == torch.from_numpy(r).dtype
            np.testing.assert_array_equal(g.numpy(), r)
    # a Python number becomes float64, as jnp.result_type(E, 1.0) does
    assert tlaw.softness(0.0, 0.0).dtype == torch.float64


def test_isothermal_glen_from_config():
    over = {"stress_balance.sia.flow_law": "isothermal_glen",
            "flow_law.isothermal_Glen.ice_softness": 2.5e-24,
            "stress_balance.sia.Glen_exponent": 3.0}
    jl = j_rh.flow_law_from_config(JConfig(over), "sia")
    tl = t_rh.flow_law_from_config(pt.Config(over), "sia")
    assert isinstance(tl, t_rh.IsothermalGlen)
    assert (tl.A, tl.n) == (jl.A, jl.n)
    # the SSA takes it too (MISMIP); a law the port lacks raises
    over = {"stress_balance.ssa.flow_law": "isothermal_glen",
            "flow_law.isothermal_Glen.ice_softness": 1e-25}
    jl = j_rh.flow_law_from_config(JConfig(over), "ssa")
    tl = t_rh.flow_law_from_config(pt.Config(over), "ssa")
    assert isinstance(tl, t_rh.IsothermalGlen)
    assert (tl.A, tl.n) == (jl.A, jl.n)
    with pytest.raises(NotImplementedError):
        t_rh.flow_law_from_config(
            pt.Config({"stress_balance.ssa.flow_law": "hooke"}), "ssa")
