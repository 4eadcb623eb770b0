"""Fracture density (``model/fracture.py``) and the SSA's fracture
softening: ``pism_tpu_torch`` against ``pism_tpu`` on the CPU.

The five cases of the JAX package's ``tests/test_fracture.py`` run on the
port with their assertions, each result held to the JAX twin's: phi and
the fracture age within 1e-12 of their max in float64. Then one step of
every option (each criterion, the Borstad envelope, each healing option,
constant_fd, both transports, phi0) from a random state with random
velocities, in float64 (1e-12) and float32: the minmod limiter and the
threshold tests compare floats, so float32 is held at the envelope (phi
within 1e-5 of its max, the cells with phi > 0 equal but for a handful at
the thresholds), not pointwise. The SSA's hardness is softened by
max(1 - (1 - eps) phi, eps) in SSAFD as in JAX, and not in SSAFEM.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu import Config as JConfig, Grid as JGrid  # noqa: E402
from pism_tpu.model.fracture import FractureDensity as JFD  # noqa: E402
from pism_tpu.state import ModelState as JState  # noqa: E402
from pism_tpu.state import new_geometry as j_new_geometry  # noqa: E402
import pism_tpu_torch as pt  # noqa: E402
from pism_tpu_torch.model.fracture import FractureDensity  # noqa: E402
from pism_tpu_torch.state import ModelState, new_geometry  # noqa: E402

SPY = 3.15569259747e7


def _rel(a, b):
    a = (a.numpy() if torch.is_tensor(a) else np.asarray(a)).astype(float)
    b = np.asarray(b, float)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


class Pair:
    """The two packages' fracture models and states from numpy arrays."""

    def __init__(self, grid_kw, over=None, H=300.0, bed=-2000.0, bc=None,
                 dtype=np.float64):
        cfg = {"fracture_density.enabled": True, **(over or {})}
        self.jg, self.tg = JGrid(**grid_kw), pt.Grid(**grid_kw)
        self.dtype = dtype
        shape = self.jg.shape2
        H = np.broadcast_to(np.asarray(H, dtype), shape)
        bed = np.broadcast_to(np.asarray(bed, dtype), shape)
        self.j = JFD(grid=self.jg, config=JConfig(cfg),
                     bc_mask=None if bc is None else jnp.asarray(bc))
        self.t = FractureDensity(grid=self.tg, config=pt.Config(cfg),
                                 bc_mask=None if bc is None
                                 else torch.as_tensor(bc))
        self.js = JState(geometry=j_new_geometry(jnp.asarray(H),
                                                 jnp.asarray(bed)))
        self.ts = ModelState(geometry=new_geometry(
            torch.as_tensor(np.array(H)), torch.as_tensor(np.array(bed))))

    def step(self, phi, u, v, dt, age=None, hardness=None):
        c = lambda a: np.asarray(a, self.dtype)       # noqa: E731
        kw = {} if hardness is None else {"hardness": c(hardness)}
        jres = self.j.step(
            self.js.replace(fracture_density=jnp.asarray(c(phi)),
                            fracture_age=None if age is None
                            else jnp.asarray(c(age))),
            jnp.asarray(c(u)), jnp.asarray(c(v)),
            jnp.asarray(c(dt)), **{k: jnp.asarray(x) for k, x in kw.items()})
        tres = self.t.step(
            self.ts.replace(fracture_density=torch.as_tensor(c(phi)),
                            fracture_age=None if age is None
                            else torch.as_tensor(c(age))),
            torch.as_tensor(c(u)), torch.as_tensor(c(v)), float(c(dt)),
            **{k: torch.as_tensor(x) for k, x in kw.items()})
        return jres, tres


def _check(jres, tres, tol=1e-12):
    assert _rel(tres.density, jres.density) <= tol
    if jres.age is not None:
        assert _rel(tres.age, jres.age) <= tol


def test_crevasse_band_advects_with_prescribed_velocity():
    """A phi band in a uniform flow moves downstream at the flow speed;
    the limited scheme conserves the band's mass and keeps its peak better
    than donor cell (250 steps; the port against JAX after them)."""
    kw = dict(Mx=101, My=5, Lx=100e3, Ly=5e3, periodicity="xy")
    x = np.asarray(JGrid(**kw).x)
    band0 = np.exp(-((x + 50e3) / 8e3) ** 2)
    phi0 = np.tile(band0[None, :], (5, 1)) * 0.8
    u = np.full((5, 101), 100.0 / SPY)
    v = np.zeros((5, 101))
    results = {}
    for limited in (True, False):
        p = Pair(kw, {"fracture_density.constant_fd": True,
                      "fracture_density.fd2d_scheme": limited})
        phi, jphi = torch.as_tensor(phi0), jnp.asarray(phi0)
        ut, vt = torch.as_tensor(u), torch.as_tensor(v)
        for _ in range(250):
            phi = p.t.step(p.ts.replace(fracture_density=phi), ut, vt,
                           2.0 * SPY).density
            jphi = p.j.step(p.js.replace(fracture_density=jphi),
                            jnp.asarray(u), jnp.asarray(v),
                            2.0 * SPY).density
        assert _rel(phi, jphi) <= 1e-12
        results[limited] = phi.numpy()
    for limited, phi in results.items():
        com = float((x * phi[2]).sum() / phi[2].sum())
        assert com == pytest.approx(0.0, abs=2.0 * 1000.0), (limited, com)
        np.testing.assert_allclose(phi[2].sum(), 0.8 * band0.sum(), rtol=0.02)
    assert results[True].max() > results[False].max() + 0.02


def test_growth_floating_only_and_age_reset():
    """Spreading above the threshold grows phi on floating ice only
    (include_grounded_ice extends it); the age resets where fractures
    grow and ages by dt where intact."""
    kw = dict(Mx=31, My=31, Lx=30e3, Ly=30e3)
    bed = np.full((31, 31), -2000.0)
    bed[:, :10] = -100.0                       # west strip grounded
    grounded = bed == -100.0
    X, Y = np.meshgrid(JGrid(**kw).x, JGrid(**kw).y)
    u, v = 2e-9 * X, 2e-9 * Y
    dt = 0.5 * SPY
    p = Pair(kw, bed=bed)
    jres, res = p.step(np.zeros((31, 31)), u, v, dt,
                       age=np.full((31, 31), 10.0 * SPY))
    _check(jres, res)
    phi, age = res.density.numpy(), res.age.numpy()
    assert phi[~grounded].max() > 1e-4 and phi[grounded].max() == 0.0
    assert (age[phi > 1e-6] == 0.0).all()
    intact = (~grounded) & (phi <= 1e-6)
    if intact.any():
        assert age[intact].max() == pytest.approx(10.0 * SPY + dt, rel=1e-6)
    pg = Pair(kw, {"fracture_density.include_grounded_ice": True}, bed=bed)
    jres, res = pg.step(np.zeros((31, 31)), u, v, dt)
    _check(jres, res)
    assert res.density.numpy()[grounded].max() > 1e-4


def test_healing_options():
    """Below the healing threshold phi decays; constant_healing at a fixed
    rate; fracture_weighted_healing by (1 - phi); constant_fd freezes all
    but the transport."""
    kw = dict(Mx=11, My=11, Lx=10e3, Ly=10e3)
    phi0 = np.full((11, 11), 0.5)
    z = np.zeros((11, 11))
    dt = 1.0 * SPY
    gh = {"fracture_density.gamma_h": 1.0}
    expected = 0.5 - 1.0 * 2.0e-10 * dt
    for over, want in (({}, expected),
                       ({"fracture_density.constant_healing": True}, expected),
                       ({"fracture_density.fracture_weighted_healing": True},
                        0.5 - (1 - 0.5) * 2.0e-10 * dt),
                       ({"fracture_density.constant_fd": True}, 0.5)):
        jres, res = Pair(kw, dict(gh, **over)).step(phi0, z, z, dt)
        _check(jres, res)
        np.testing.assert_allclose(res.density.numpy(), want, rtol=1e-6)


def test_borstad_envelope_and_stress_criteria():
    """borstad_limit: phi jumps to 1 - (eps_cr / eps_e)^(1/n) where the
    criterion holds; max_shear_stress with a hardness compares the
    constitutive stress with the Pa threshold."""
    kw = dict(Mx=21, My=21, Lx=20e3, Ly=20e3)
    X, Y = np.meshgrid(JGrid(**kw).x, JGrid(**kw).y)
    k = 4.0e-9
    z = np.zeros((21, 21))
    p = Pair(kw, {"fracture_density.borstad_limit": True})
    jres, res = p.step(z, k * X, k * Y, 0.1 * SPY)
    _check(jres, res)
    target = 1.0 - (p.t.eps_cr / (np.sqrt(3.0) * k)) ** (1.0 / 3.0)
    np.testing.assert_allclose(res.density.numpy()[5:-5, 5:-5], target,
                               rtol=1e-6)
    c, B = 2.0e-9, 1.0e8
    tau_max = B * (c / 2.0) ** (1.0 / 3.0)
    for thresh, grows in ((tau_max * 0.5, True), (tau_max * 2.0, False)):
        ps = Pair(kw, {"fracture_density.max_shear_stress": True,
                       "fracture_density.initiation_stress_threshold":
                       float(thresh)})
        jres, res = ps.step(z, c * Y, z, 0.5 * SPY,
                            hardness=np.full((21, 21), B))
        _check(jres, res)
        assert (res.density.numpy()[5:-5, 5:-5].max() > 0.0) == grows


def test_inflow_pinning_phi0():
    kw = dict(Mx=21, My=5, Lx=20e3, Ly=5e3, periodicity="y")
    bc = np.zeros((5, 21), bool)
    bc[:, 0] = True
    p = Pair(kw, {"fracture_density.phi0": 0.25,
                  "fracture_density.constant_fd": True}, bc=bc)
    z = np.zeros((5, 21))
    jres, res = p.step(np.full((5, 21), 0.9), z, z, SPY)
    _check(jres, res)
    phi = res.density.numpy()
    assert (phi[:, 0] == 0.25).all() and (phi[:, 1:] == 0.9).all()


OPTIONS = [
    {}, {"fracture_density.fd2d_scheme": False},
    {"fracture_density.max_shear_stress": True},
    {"fracture_density.lefm": True},
    {"fracture_density.max_shear_stress": True, "hardness": True},
    {"fracture_density.lefm": True, "hardness": True},
    {"fracture_density.borstad_limit": True},
    {"fracture_density.gamma_h": 0.5,
     "fracture_density.fracture_weighted_healing": True},
    {"fracture_density.gamma_h": 0.5, "fracture_density.constant_healing":
     True, "fracture_density.include_grounded_ice": True},
    {"fracture_density.constant_fd": True},
    {"fracture_density.phi0": 0.3, "bc": True},
]


def _random_case(dtype, seed=29):
    kw = dict(Mx=27, My=23, Lx=260e3, Ly=220e3)
    rng = np.random.default_rng(seed)
    X, Y = np.meshgrid(JGrid(**kw).x, JGrid(**kw).y)
    H = np.maximum(600.0 - 0.002 * np.abs(X), 0.0) \
        + rng.uniform(0.0, 50.0, X.shape)
    bed = np.where(X < -80e3, 100.0, -900.0)
    H = np.where(X > 240e3, 0.0, H)
    u = 4e-9 * X + 3e-6 * rng.standard_normal(X.shape)
    v = 2e-9 * Y + 3e-6 * rng.standard_normal(X.shape)
    phi = rng.uniform(0.0, 0.7, X.shape) * (rng.uniform(size=X.shape) > 0.3)
    age = rng.uniform(0.0, 30.0 * SPY, X.shape)
    hard = rng.uniform(0.5e8, 2e8, X.shape)
    bc = np.zeros(X.shape, bool)
    bc[:, :2] = True
    return kw, H, bed, u, v, phi, age, hard, bc


@pytest.mark.parametrize("opt", OPTIONS, ids=lambda o: ",".join(
    k.split(".")[-1] for k in o) or "default")
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_every_option_matches(opt, dtype):
    kw, H, bed, u, v, phi, age, hard, bc = _random_case(dtype)
    over = {k: v_ for k, v_ in opt.items() if "." in k}
    p = Pair(kw, over, H=H, bed=bed, bc=bc if opt.get("bc") else None,
             dtype=dtype)
    jres, res = p.step(phi, u, v, 0.4 * SPY, age=age,
                       hardness=hard if opt.get("hardness") else None)
    if dtype == np.float64:
        _check(jres, res)
    else:
        assert _rel(res.density, jres.density) <= 1e-5
        a, b = res.density.numpy() > 0, np.asarray(jres.density) > 0
        assert (a != b).sum() <= 3
        both = a & b
        assert _rel(res.age.numpy()[both], np.asarray(jres.age)[both]) <= 1e-5
    phi_new = res.density.numpy()
    assert phi_new.min() >= 0.0 and phi_new.max() <= 1.0


def test_flow_enhancement_matches():
    kw = dict(Mx=9, My=7, Lx=1e4, Ly=1e4)
    phi = np.random.default_rng(2).uniform(0.0, 1.0, (7, 9))
    for eps in (1.0, 0.5, 0.05):
        p = Pair(kw, {"fracture_density.softening_lower_limit": eps})
        got = p.t.flow_enhancement(torch.as_tensor(phi), 3.0)
        want = p.j.flow_enhancement(jnp.asarray(phi), 3.0)
        assert _rel(got, want) <= 1e-12


def _pik_state(where, over):
    from pism_tpu_torch import setups
    model, state, grid = setups.antarctica_pik_model(
        "float64", 200.0, device=where, Mz=11, extra_cfg=over)
    phi = np.random.default_rng(5).uniform(0.0, 1.0, grid.shape2)
    return model, state.replace(fracture_density=torch.as_tensor(phi)), phi


def test_ssa_hardness_softening_matches():
    """SSAFD's hardness with fracture_density.softening_lower_limit < 1
    against the JAX SSAFD's on the PIK chain's state (1e-12); the
    unsoftened hardness where the limit is 1; SSAFEM does not soften, as
    in JAX."""
    from pism_tpu.model.ssa import SSAFD as JSSAFD
    from pism_tpu.model.ssafem import SSAFEM as JSSAFEM
    from pism_tpu.physics.rheology import flow_law_from_config as j_law
    from pism_tpu_torch.convert import state_to_numpy
    from test_torch_antarctica import numpy_to_jax

    for eps in (0.5, 1.0):
        model, state, phi = _pik_state("cpu", {
            "fracture_density.softening_lower_limit": eps})
        B = model.ssa._hardness(state)
        B0 = model.ssa._hardness(state.replace(fracture_density=None))
        cfg = JConfig(dict(model.config.non_default()))
        jg = JGrid(**{k: getattr(model.grid, k) for k in (
            "Mx", "My", "Lx", "Ly", "Mz", "Lz")})
        jssa = JSSAFD(grid=jg, config=cfg, flow_law=j_law(cfg, "ssa"))
        jstate = numpy_to_jax(state_to_numpy(state))
        assert _rel(B, jssa._hardness(jstate)) <= 1e-12
        if eps == 1.0:
            assert torch.equal(B, B0)
        else:
            np.testing.assert_allclose(
                B.numpy(), B0.numpy() * np.maximum(1.0 - 0.5 * phi, 0.5),
                rtol=1e-14)
            cfg_fem = JConfig(dict(model.config.non_default(), **{
                "stress_balance.ssa.method": "fem"}))
            jfem = JSSAFEM(grid=jg, config=cfg_fem,
                           flow_law=j_law(cfg_fem, "ssa"))
            from pism_tpu_torch.model.ssafem import SSAFEM
            fem = SSAFEM(grid=model.grid, config=pt.Config(dict(
                model.config.non_default(), **{
                    "stress_balance.ssa.method": "fem"})),
                flow_law=model.ssa.flow_law)
            assert torch.equal(fem._hardness(state), B0)
            assert _rel(fem._hardness(state), jfem._hardness(jstate)) <= 1e-12
