"""K3, the fused thermomechanical SIA kernel: its plain torch version in
pism_tpu_torch against the TPU kernel ``sia_flux_thermo_pallas`` run in
interpret mode, on the setup of tests/test_pallas.py (50x50x9, a cold dome
with temperate ice mixed into its lower levels), for the Paterson-Budd and
GPBLD laws with and without a diffusivity cap, with E contiguous and
level-major (the layout the energy step leaves); the wrapper's checks, its
max of D, and the routing of ``ops.sia.diffusivity`` under
``stress_balance.sia.pallas``, whose kernel route reads E in place.

Tolerances: 1e-12 of the largest value in float64 (rounding only); 1e-4 in
float32, the reference's own tolerance for this kernel
(tests/test_pallas.py:64-69).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu import Config as JConfig, Grid as JGrid  # noqa: E402
from pism_tpu.model.energy import bootstrap_enthalpy  # noqa: E402
from pism_tpu.ops.pallas_kernels import sia_flux_thermo_pallas  # noqa: E402
from pism_tpu.physics.enthalpy_converter import EnthalpyConverter as JEC  # noqa: E402
from pism_tpu.physics import rheology as j_rh  # noqa: E402
import pism_tpu_torch as pt  # noqa: E402
from pism_tpu_torch.ops import sia as t_sia  # noqa: E402
from pism_tpu_torch.ops.kernels import sia_thermo as K3  # noqa: E402
from pism_tpu_torch.ops.stencils import Shifter  # noqa: E402
from pism_tpu_torch.physics import rheology as t_rh  # noqa: E402
from pism_tpu_torch.physics.enthalpy_converter import EnthalpyConverter  # noqa: E402
from pism_tpu_torch.state import new_geometry  # noqa: E402

TOL = {np.float64: 1e-12, np.float32: 1e-4}
GRID = dict(Mx=50, My=50, Lx=750e3, Ly=750e3, Mz=9, Lz=5000.0)


def _inputs(dtype, seed=3):
    grid = JGrid(**GRID)
    EC = JEC.from_config(JConfig())
    r = np.asarray(grid.radius)
    H = np.maximum(3000.0 * (1 - (r / 700e3) ** 2), 0.0)
    rng = np.random.default_rng(seed)
    s = H + rng.uniform(0.0, 5.0, size=H.shape) * (H > 0)
    E = np.asarray(bootstrap_enthalpy(grid, EC, jnp.asarray(H),
                                      jnp.full(grid.shape2, 248.15)))
    # temperate and near-temperate ice in the lower levels
    E = E + rng.uniform(0.0, 6e4, size=E.shape) * (np.arange(grid.Mz) < 3)
    return grid, H.astype(dtype), s.astype(dtype), E.astype(dtype)


def _level_major(E):
    """E (My, Mx, Mz) as a view of a (Mz, My, Mx) array, the layout the
    energy step leaves."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(E, -1, 0))
                            ).movedim(0, -1)


def _laws(name):
    jlaw = {"pb": j_rh.PatersonBudd, "gpbld": j_rh.GPBLD}[name](
        EC=JEC.from_config(JConfig()))
    tlaw = {"pb": t_rh.PatersonBudd, "gpbld": t_rh.GPBLD}[name](
        EC=EnthalpyConverter.from_config(pt.Config()))
    return jlaw, tlaw


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("d_cap", [None, 2.0])
@pytest.mark.parametrize("law", ["pb", "gpbld"])
def test_plain_matches_tpu_kernel(law, d_cap, dtype):
    grid, H, s, E = _inputs(dtype)
    jlaw, tlaw = _laws(law)
    kw = dict(n=3.0, enhancement=1.5, rho=910.0, g=9.81, dx=grid.dx,
              dy=grid.dy, d_cap=d_cap)
    ref = sia_flux_thermo_pallas(jnp.asarray(H), jnp.asarray(s),
                                 jnp.asarray(E), grid=grid, EC=jlaw.EC,
                                 pb_law=jlaw, block_y=16, interpret=True,
                                 **kw)
    z = torch.as_tensor(grid.z, dtype=torch.from_numpy(H).dtype)
    got = K3.sia_flux_thermo(torch.from_numpy(H), torch.from_numpy(s),
                             torch.from_numpy(E), z, EC=tlaw.EC,
                             pb_law=tlaw, **kw)
    for g, r in zip(got, ref):     # De, Dn, qe, qn, max_D
        assert g.dtype == torch.from_numpy(H).dtype
        assert _rel(g, r) <= TOL[dtype]
    if d_cap is not None:
        assert float(got[4]) == pytest.approx(d_cap)   # the cap binds


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("d_cap", [None, 2.0])
@pytest.mark.parametrize("law", ["pb", "gpbld"])
def test_level_major_E_matches_tpu_kernel(law, d_cap, dtype):
    """E as a view of a (Mz, My, Mx) array, the layout the energy step
    leaves: the wrapper and the plain version against the TPU kernel (on
    the contiguous array) and against the contiguous case."""
    grid, H, s, E = _inputs(dtype)
    jlaw, tlaw = _laws(law)
    kw = dict(n=3.0, enhancement=1.5, rho=910.0, g=9.81, dx=grid.dx,
              dy=grid.dy, d_cap=d_cap)
    ref = sia_flux_thermo_pallas(jnp.asarray(H), jnp.asarray(s),
                                 jnp.asarray(E), grid=grid, EC=jlaw.EC,
                                 pb_law=jlaw, block_y=16, interpret=True,
                                 **kw)
    z = torch.as_tensor(grid.z, dtype=torch.from_numpy(H).dtype)
    Et = _level_major(E)
    assert not Et.is_contiguous()
    args = (torch.from_numpy(H), torch.from_numpy(s))
    got = K3.sia_flux_thermo(*args, Et, z, EC=tlaw.EC, pb_law=tlaw, **kw)
    same = K3.sia_flux_thermo(*args, torch.from_numpy(E), z, EC=tlaw.EC,
                              pb_law=tlaw, **kw)
    for g, r, c in zip(got, ref, same):     # De, Dn, qe, qn, max_D
        assert g.dtype == torch.from_numpy(H).dtype
        assert _rel(g, r) <= TOL[dtype]
        assert _rel(g, c) <= TOL[dtype]
    plain = K3.sia_flux_thermo_plain(*args, Et, z, EC=tlaw.EC, pb_law=tlaw,
                                     **kw)
    for g, r in zip(plain, (ref[2], ref[3], ref[0], ref[1])):
        assert _rel(g, r) <= TOL[dtype]


def test_wrapper_checks_shapes_and_types():
    grid, H, s, E = _inputs(np.float64)
    _, law = _laws("pb")
    args = [torch.from_numpy(a) for a in (H, s, E)]
    z = torch.as_tensor(grid.z)
    kw = dict(dx=grid.dx, dy=grid.dy, EC=law.EC, pb_law=law)
    with pytest.raises(ValueError):
        K3.sia_flux_thermo(args[0], args[1], args[2][..., :-1], z, **kw)
    with pytest.raises(TypeError):
        K3.sia_flux_thermo(args[0].float(), args[1], args[2], z, **kw)
    with pytest.raises(ValueError):
        K3.sia_flux_thermo(args[0].T, args[1], args[2], z, **kw)


@pytest.mark.parametrize("case", ["z short of a level", "E without levels",
                                  "E of another grid", "level-major E"])
def test_wrapper_checks_E_and_z(case):
    """Both entry points refuse a wrongly shaped E or z and take a
    level-major E as it is."""
    grid, H, s, E = _inputs(np.float64)
    _, law = _laws("pb")
    H, s, Et = (torch.from_numpy(a) for a in (H, s, E))
    z = torch.as_tensor(grid.z)
    kw = dict(dx=grid.dx, dy=grid.dy, EC=law.EC, pb_law=law)
    args = {"z short of a level": (H, s, Et, z[:-1]),
            "E without levels": (H, s, Et[..., 0], z),
            "E of another grid": (H, s, Et[:-1], z),
            "level-major E": (H, s, _level_major(E), z)}[case]
    for fn in (K3.sia_flux_thermo, K3.sia_flux_thermo_faces):
        if case == "level-major E":
            fn(*args, **kw)
        else:
            with pytest.raises(ValueError):
                fn(*args, **kw)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("nan", [False, True])
def test_max_D_is_the_faces_max(nan, dtype):
    """``max_D`` is torch.maximum(torch.max(De), torch.max(Dn)): a NaN
    thickness makes it NaN."""
    grid, H, s, E = _inputs(dtype)
    if nan:
        H[20, 30] = np.nan
    _, law = _laws("gpbld")
    De, Dn, _, _, max_D = K3.sia_flux_thermo(
        torch.from_numpy(H), torch.from_numpy(s), _level_major(E),
        torch.as_tensor(grid.z, dtype=torch.from_numpy(H).dtype), dx=grid.dx,
        dy=grid.dy, EC=law.EC, pb_law=law)
    assert max_D.shape == () and max_D.dtype == De.dtype
    assert bool(torch.isnan(max_D)) == nan
    if not nan:
        assert float(max_D) > 0.0
        assert torch.equal(max_D, torch.maximum(De.max(), Dn.max()))


def _diffusivity_case():
    jgrid, H, s, E = _inputs(np.float64)
    grid = pt.Grid(**GRID)
    _, law = _laws("pb")
    geom = new_geometry(torch.from_numpy(H), torch.from_numpy(s - H))
    return grid, geom, torch.from_numpy(E), law


@pytest.mark.parametrize("pallas", [None, True, False])
def test_routing_on_cpu(pallas, monkeypatch):
    """``auto`` (None) and ``off`` take the plain path on CPU tensors; ``on``
    takes K3's route, whose CPU path is K3's plain version, and drops the
    bed-smoother theta as the JAX package does."""
    grid, geom, E, law = _diffusivity_case()
    sh = Shifter(grid)
    calls = []
    real = K3.sia_flux_thermo
    monkeypatch.setattr(K3, "sia_flux_thermo",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    theta = torch.full(grid.shape2, 0.5, dtype=torch.float64)
    kw = dict(gradient_method="mahaffy", enhancement=1.5, d_limit=None)
    with_theta = t_sia.diffusivity(law, geom, E, grid, sh, pallas=pallas,
                                   theta_e=theta, theta_n=theta, **kw)
    without = t_sia.diffusivity(law, geom, E, grid, sh, pallas=pallas, **kw)
    assert len(calls) == (2 if pallas else 0)
    if pallas:
        assert torch.equal(with_theta.De, without.De)
    else:
        torch.testing.assert_close(with_theta.De, 0.5 * without.De,
                                   rtol=1e-15, atol=0.0)
    z = torch.as_tensor(grid.z)
    ref = K3.sia_flux_thermo_plain(geom.ice_thickness,
                                   geom.ice_surface_elevation, E, z,
                                   enhancement=1.5, dx=grid.dx, dy=grid.dy,
                                   EC=law.EC, pb_law=law)
    for g, r in zip((without.qe, without.qn, without.De, without.Dn), ref):
        assert _rel(g, r) <= 1e-12


@pytest.mark.parametrize("layout", ["contiguous", "level-major"])
def test_kernel_route_reads_E_in_place(layout, monkeypatch):
    """``sia.pallas = on`` hands the model's enthalpy to K3 as it is, level
    major or not: no copy of E."""
    grid, geom, E, law = _diffusivity_case()
    if layout == "level-major":
        E = _level_major(E.numpy())
    seen = []
    real = K3.sia_flux_thermo
    monkeypatch.setattr(K3, "sia_flux_thermo",
                        lambda *a, **k: seen.append(a[2]) or real(*a, **k))
    t_sia.diffusivity(law, geom, E, grid, Shifter(grid), pallas=True,
                      gradient_method="mahaffy", enhancement=1.5)
    assert len(seen) == 1 and seen[0] is E


def _fake(device, dtype):
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype)


@pytest.mark.parametrize("case,eligible", [
    ({}, True),
    ({"H": _fake("cpu", torch.float32)}, False),
    ({"H": _fake("cuda", torch.float64)}, False),
    ({"gradient_method": "haseloff"}, False),
    ({"theta": True}, False),
    ({"enthalpy": None}, False),
    ({"law": "isothermal"}, False),
    ({"enhancement": torch.ones(3)}, False),
    ({"periodicity": "x"}, False),
])
def test_auto_rule(case, eligible):
    """``auto`` takes K3 exactly where the JAX package's ``_pallas_eligible``
    takes its kernel, with a CUDA card for the TPU."""
    grid = pt.Grid(**GRID, periodicity=case.get("periodicity", "none"))
    _, law = _laws("gpbld")
    if case.get("law") == "isothermal":
        law = types.SimpleNamespace(n=3.0)
    theta = torch.ones(2) if case.get("theta") else None
    args = (law, case.get("enthalpy", torch.ones(1)), grid,
            case.get("H", _fake("cuda", torch.float32)),
            case.get("gradient_method", "mahaffy"), theta, theta,
            case.get("enhancement", 1.0))
    assert t_sia._kernel_eligible(*args) is eligible
