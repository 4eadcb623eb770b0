"""The kernels under spatial decomposition (``pism_tpu_torch/ops/sharded.py``)
on CPU meshes, where each shard runs its kernel's plain version:

- K5, the sharded SSA matvec, and its JVP against the JAX package's
  ``ssa_matvec_sharded(..., interpret=True)`` and ``jax.jvp`` of it on the
  uneven 37x29 grid of tests/test_sharding.py:291-345, meshes (2, 4) and
  (2, 2): 1e-5 of the largest value in float32 (the JAX test's own) and
  1e-12 in float64;
- K5 against the port's unsharded ``ssa_matvec_plain`` (K1): bit-equal,
  since per cell they evaluate the same expressions in the same order;
- K6, ``diffusivity(..., pallas=True, mesh=...)``, in both packages, on the
  thermo case 37x45x9 and the isothermal case 53x41 of
  tests/test_sharding.py:226-288: 2e-5 of the largest value in float32 (the
  JAX test's), 1e-12 in float64;
- the port's meshed chains against its unmeshed ones on the same grid: the
  100 km hybrid chain in float64 on a (2, 4) mesh, EISMINT II A at
  21x21x21 and Halfar test B at 61x61 in float64 with ``sia.pallas = on``:
  equal steps and dt-limit hits, H within 1e-12 of max H (the shards
  compute the whole-field values, so the runs agree to the bit).

The port's meshes name the CPU eight times; JAX's are its 8 virtual CPU
devices (tests/conftest.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu import Config as JConfig, Grid as JGrid  # noqa: E402
from pism_tpu.ops import sia as j_sia  # noqa: E402
from pism_tpu.ops.pallas_sharded import (  # noqa: E402
    ssa_matvec_sharded as j_ssa_matvec_sharded)
from pism_tpu.ops.stencils import Shifter as JShifter  # noqa: E402
from pism_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from pism_tpu.physics.enthalpy_converter import (  # noqa: E402
    EnthalpyConverter as JEC)
from pism_tpu.physics.rheology import (  # noqa: E402
    flow_law_from_config as j_flow_law)
from pism_tpu.state import new_geometry as j_new_geometry  # noqa: E402
import pism_tpu_torch as pt  # noqa: E402
from pism_tpu_torch import setups  # noqa: E402
from pism_tpu_torch.model.icemodel import IceModel  # noqa: E402
from pism_tpu_torch.ops import sharded as S  # noqa: E402
from pism_tpu_torch.ops import sia as t_sia  # noqa: E402
from pism_tpu_torch.ops.kernels import ssa_matvec as K  # noqa: E402
from pism_tpu_torch.ops.stencils import Shifter  # noqa: E402
from pism_tpu_torch.parallel import make_mesh  # noqa: E402
from pism_tpu_torch.physics.enthalpy_converter import EnthalpyConverter  # noqa: E402
from pism_tpu_torch.physics.rheology import flow_law_from_config  # noqa: E402
from pism_tpu_torch.state import new_geometry  # noqa: E402

SPY = 3.15569259747e7
TOL_K5 = {np.float64: 1e-12, np.float32: 1e-5}
TOL_K6 = {np.float64: 1e-12, np.float32: 2e-5}
# the uneven grid of tests/test_sharding.py:298-299
MX, MY, LX, LY = 37, 29, 200e3, 160e3


@pytest.fixture(autouse=True, scope="module")
def _fresh_compile_state():
    """Drop the compiled executables of earlier tests in this process
    before the shard_map compilations (tests/test_sharding.py:23-33)."""
    jax.clear_caches()
    yield


@pytest.fixture(scope="module")
def jax_devices():
    d = jax.devices()
    if len(d) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    return d


def _meshes(jax_devices, shape):
    n = shape[0] * shape[1]
    return (make_mesh(["cpu"] * n, shape),
            j_make_mesh(jax_devices[:n], shape))


def _rel(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def _matvec_inputs(dtype, seed=11, shape=(MY, MX)):
    """u, v, nuH_e, nuH_n, beta at tests/test_sharding.py's scales, and
    tangents of all five."""
    rng = np.random.default_rng(seed)
    x = [rng.normal(size=shape) * 1e-5, rng.normal(size=shape) * 1e-5,
         rng.uniform(1e13, 1e15, size=shape),
         rng.uniform(1e13, 1e15, size=shape),
         rng.uniform(1e8, 1e10, size=shape)]
    t = [rng.normal(size=shape) * 1e-6, rng.normal(size=shape) * 1e-6,
         rng.normal(size=shape) * 1e13, rng.normal(size=shape) * 1e13,
         rng.normal(size=shape) * 1e8]
    return [a.astype(dtype) for a in x], [a.astype(dtype) for a in t]


@pytest.mark.parametrize("shape", [(2, 4), (2, 2)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_k5_matches_jax(jax_devices, dtype, shape):
    mesh, jmesh = _meshes(jax_devices, shape)
    grid = JGrid(Mx=MX, My=MY, Lx=LX, Ly=LY)
    x, t = _matvec_inputs(dtype)
    tx, tt = [torch.tensor(a) for a in x], [torch.tensor(a) for a in t]
    jx, jt = [jnp.asarray(a) for a in x], [jnp.asarray(a) for a in t]

    def f_jax(*a):
        return j_ssa_matvec_sharded(*a, jmesh, grid.dx, grid.dy, True)

    # one compiled program (op-by-op dispatch of the interpreted kernel
    # takes seconds per call)
    want, jvp_want = jax.jit(lambda a, t: jax.jvp(f_jax, a, t))(
        tuple(jx), tuple(jt))
    got = S.ssa_matvec_sharded(*tx, mesh, grid.dx, grid.dy)
    jvp_got = S.ssa_matvec_sharded_jvp(*tx[:2], *tt[:2], *tx[2:4], *tt[2:4],
                                       tx[4], tt[4], mesh, grid.dx, grid.dy)
    _, jvp_fn = torch.func.jvp(
        lambda *a: S.SSAMatvecSharded.apply(*a, mesh, grid.dx, grid.dy),
        tuple(tx), tuple(tt))
    for g, w in zip(got, want):
        assert g.shape == (MY, MX) and g.dtype == tx[0].dtype
        assert _rel(g, w) <= TOL_K5[dtype]
    for g, gf, w in zip(jvp_got, jvp_fn, jvp_want):
        assert _rel(g, w) <= TOL_K5[dtype]
        assert _rel(gf, w) <= TOL_K5[dtype]


@pytest.mark.parametrize(
    "shape,grid",
    [((2, 4), (MY, MX)), ((2, 2), (MY, MX)), ((4, 2), (MY, MX)),
     ((1, 8), (MY, MX)), ((8, 1), (MY, MX)), ((1, 4), (9, 33)),
     ((4, 1), (33, 9))],
    ids=["shape0", "shape1", "shape2", "shape3", "shape4", "9x33-on-1x4",
         "33x9-on-4x1"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_k5_equals_k1(dtype, shape, grid):
    """The sharded plain version is the unsharded one to the bit, with and
    without a drag tangent; on the uneven grid, and on grids cut into 9x9
    shards (smaller than one tile of the CUDA kernel, as the card tests
    cut them)."""
    mesh = make_mesh(["cpu"] * (shape[0] * shape[1]), shape)
    x, t = _matvec_inputs(dtype, seed=12, shape=grid)
    u, v, ne, nn, b = [torch.tensor(a) for a in x]
    du, dv, dne, dnn, db = [torch.tensor(a) for a in t]
    got = S.ssa_matvec_sharded(u, v, ne, nn, b, mesh, 20e3, 25e3)
    for g, r in zip(got, K.ssa_matvec_plain(u, v, ne, nn, b, 20e3, 25e3)):
        assert torch.equal(g, r)
    for dbeta in (None, db):
        got = S.ssa_matvec_sharded_jvp(u, v, du, dv, ne, nn, dne, dnn, b,
                                       dbeta, mesh, 20e3, 25e3)
        ref = K.ssa_matvec_jvp_plain(u, v, du, dv, ne, nn, dne, dnn, b,
                                     dbeta, 20e3, 25e3)
        for g, r in zip(got, ref):
            assert torch.equal(g, r)


def test_k5_plain_route_equals_the_wrapper_on_the_cpu():
    """``ssa_matvec_sharded_plain`` (the card's reference) is the CPU
    route of ``ssa_matvec_sharded``; neither counts a launch."""
    mesh = make_mesh(["cpu"] * 4, (2, 2))
    x, t = _matvec_inputs(np.float64, seed=13)
    tx, tt = [torch.tensor(a) for a in x], [torch.tensor(a) for a in t]
    n0 = (K.HALO_LAUNCHES, K.HALO_JVP_LAUNCHES)
    for g, r in zip(S.ssa_matvec_sharded(*tx, mesh, 5e3, 5e3),
                    S.ssa_matvec_sharded_plain(*tx, mesh, 5e3, 5e3)):
        assert torch.equal(g, r)
    args = (*tx[:2], *tt[:2], *tx[2:4], *tt[2:4], tx[4], None, mesh, 5e3, 5e3)
    for g, r in zip(S.ssa_matvec_sharded_jvp(*args),
                    S.ssa_matvec_sharded_jvp_plain(*args)):
        assert torch.equal(g, r)
    assert (K.HALO_LAUNCHES, K.HALO_JVP_LAUNCHES) == n0


def test_k5_wrapper_checks_its_blocks():
    z = torch.zeros
    with pytest.raises(ValueError):
        K.ssa_matvec_halo(True, True, z(7, 8), z(7, 8), z(5, 6), z(5, 6),
                          z(3, 3), 1.0, 1.0)
    with pytest.raises(TypeError):
        K.ssa_matvec_halo(True, True, z(7, 8), z(7, 8), z(5, 6), z(5, 6),
                          z(3, 4, dtype=torch.float64), 1.0, 1.0)


def _dome(Mx, My, Lx, Ly):
    """tests/test_sharding.py's ``_dome``: a dome over a wavy bed."""
    X, Y = np.meshgrid(np.linspace(-Lx, Lx, Mx), np.linspace(-Ly, Ly, My))
    r2 = (X / (0.8 * Lx)) ** 2 + (Y / (0.8 * Ly)) ** 2
    H = 2500.0 * np.maximum(1.0 - r2, 0.0) ** 1.2
    bed = 200.0 * np.sin(X / 50e3) * np.cos(Y / 70e3)
    return H, bed


def _k6_case(thermo, dtype, seed=14):
    if thermo:
        kw = dict(Mx=37, My=45, Lx=300e3, Ly=360e3, Mz=9, Lz=4000.0)
        over = {}
    else:
        kw = dict(Mx=53, My=41, Lx=300e3, Ly=250e3)
        over = {"stress_balance.sia.flow_law": "isothermal_glen"}
    name = "float32" if dtype == np.float32 else "float64"
    over["runtime.float_dtype"] = name
    H, bed = _dome(kw["Mx"], kw["My"], kw["Lx"], kw["Ly"])
    E = None
    if thermo:
        E = np.random.default_rng(seed).uniform(
            9.0e4, 1.05e5, size=(kw["My"], kw["Mx"], kw["Mz"]))
        E = E.astype(dtype)
    return kw, over, H.astype(dtype), bed.astype(dtype), E


@pytest.mark.parametrize("thermo", [True, False], ids=["K3", "K4"])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_k6_matches_jax(jax_devices, dtype, thermo):
    kw, over, H, bed, E = _k6_case(thermo, dtype)
    mesh, jmesh = _meshes(jax_devices, (2, 4))

    jcfg = JConfig(over)
    jgrid = JGrid(**kw)
    jlaw = j_flow_law(jcfg, "sia", JEC.from_config(jcfg))

    def f_jax(H_, bed_, E_):
        geom = jax.tree_util.tree_map(
            lambda a: a.astype(H.dtype) if hasattr(a, "dtype")
            and a.dtype == jnp.float64 else a, j_new_geometry(H_, bed_))
        return j_sia.diffusivity(jlaw, geom, E_, jgrid, JShifter(jgrid),
                                 pallas=True, mesh=jmesh)

    if thermo:   # one compiled program; the K4 route reads A on the host
        want = jax.jit(f_jax)(jnp.asarray(H), jnp.asarray(bed),
                              jnp.asarray(E))
    else:
        want = f_jax(jnp.asarray(H), jnp.asarray(bed), None)

    cfg = pt.Config(over)
    grid = pt.Grid(**kw)
    law = flow_law_from_config(cfg, "sia", EnthalpyConverter.from_config(cfg))
    geom = new_geometry(torch.tensor(H), torch.tensor(bed))
    got = t_sia.diffusivity(law, geom, None if E is None else torch.tensor(E),
                            grid, Shifter(grid), pallas=True, mesh=mesh)
    for name in ("De", "Dn", "qe", "qn"):
        g = getattr(got, name)
        assert g.shape == H.shape and g.dtype == torch.from_numpy(H).dtype
        assert _rel(g, getattr(want, name)) <= TOL_K6[dtype], name
    assert _rel(got.max_D, want.max_D) <= TOL_K6[dtype]


@pytest.mark.parametrize("thermo", [True, False], ids=["K3", "K4"])
def test_k6_equals_the_unsharded_kernel_route(thermo):
    """Per-shard K3/K4 (plain here) on one-ghost blocks, cropped: the
    unsharded kernel route's fluxes and max D, to 1e-14 of the largest
    value (torch's CPU ``pow`` and ``exp`` may round an element differently
    in their vectorized and scalar loops, which a block's width moves; on
    the card the kernels agree to the bit, tests/test_torch_cuda.py)."""
    kw, over, H, bed, E = _k6_case(thermo, np.float64)
    cfg = pt.Config(over)
    grid = pt.Grid(**kw)
    law = flow_law_from_config(cfg, "sia", EnthalpyConverter.from_config(cfg))
    geom = new_geometry(torch.tensor(H), torch.tensor(bed))
    E = None if E is None else torch.tensor(E)
    ref = t_sia.diffusivity(law, geom, E, grid, Shifter(grid), pallas=True,
                            d_limit=2.0)
    for shape in ((2, 4), (4, 2), (1, 8)):
        mesh = make_mesh(["cpu"] * 8, shape)
        got = t_sia.diffusivity(law, geom, E, grid, Shifter(grid), pallas=True,
                                mesh=mesh, d_limit=2.0)
        for a, b in zip(got, ref):
            assert _rel(a, b) <= 1e-14


# ---------------------------------------------------------------------------
# the chains, meshed against unmeshed on the same grid
# ---------------------------------------------------------------------------

def _compare(a, sa, b, sb):
    assert sb.nsteps == sa.nsteps > 0
    assert sb.limit_hits_dict() == sa.limit_hits_dict()
    Ha, Hb = a.geometry.ice_thickness, b.geometry.ice_thickness
    assert bool(torch.isfinite(Hb).all())
    assert float((Hb - Ha).abs().max()) <= 1e-12 * float(Ha.max())


def test_hybrid_chain_meshed_matches_unmeshed():
    """The 100 km synthetic-Greenland chain in float64, 2 model years, on a
    (2, 4) mesh (My rounded from 29 to 30) against an IceModel on the same
    grid, config, surface and ocean without one."""
    mesh = make_mesh(["cpu"] * 8, (2, 4))
    model, state, grid = setups.hybrid_greenland_model("float64", 100.0,
                                                       device="cpu", mesh=mesh)
    assert (grid.My, grid.Mx) == (30, 16)
    assert model.ssa.mesh is mesh and model.stress_balance.mesh is mesh
    ref = IceModel(grid=grid, config=model.config, surface=model.surface,
                   ocean=model.ocean, device="cpu")
    a, ta, sa = ref.step_once(state, 0.0, 2.0 * SPY)
    b, tb, sb = model.step_once(state, 0.0, 2.0 * SPY)
    assert ta == tb
    assert sb.ssa_krylov_iters == sa.ssa_krylov_iters > 0
    _compare(a, sa, b, sb)


def test_hybrid_grid_rounds_up_to_mesh_multiples():
    mesh = make_mesh(["cuda:0"] * 4, (2, 2))   # names the card, builds nothing
    _, _, grid = setups.hybrid_greenland_model("float32", 20.0, device="cpu",
                                               mesh=mesh)
    assert (grid.My, grid.Mx) == (142, 76)


def test_eismint2_meshed_matches_unmeshed():
    """EISMINT II A at 21x21x21 float64, 5000 model years, K3's route per
    shard of a (2, 4) mesh (21 pads to 22 and 24 internally)."""
    on = {"stress_balance.sia.pallas": "on"}
    mesh = make_mesh(["cpu"] * 8, (2, 4))
    model, state, grid = setups.eismint2_model("float64", Mx=21, Mz=21,
                                               device="cpu", extra_cfg=on,
                                               mesh=mesh)
    ref, _, _ = setups.eismint2_model("float64", Mx=21, Mz=21, device="cpu",
                                      extra_cfg=on)
    assert (grid.My, grid.Mx) == (21, 21)
    a, _, sa = ref.step_once(state, 0.0, 5000.0 * SPY)
    b, _, sb = model.step_once(state, 0.0, 5000.0 * SPY)
    _compare(a, sa, b, sb)


def test_halfar_meshed_matches_unmeshed():
    """Halfar test B at 61x61 float64, 1000 model years, K4's route per
    shard of a (2, 4) mesh."""
    on = {"stress_balance.sia.pallas": "on"}
    mesh = make_mesh(["cpu"] * 8, (2, 4))
    model, state, _, sol = setups.halfar_model("B", 61, "float64",
                                               device="cpu", extra_cfg=on,
                                               mesh=mesh)
    ref, _, _, _ = setups.halfar_model("B", 61, "float64", device="cpu",
                                       extra_cfg=on)
    a, _, sa = ref.step_once(state, sol.t0, 1000.0 * SPY)
    b, _, sb = model.step_once(state, sol.t0, 1000.0 * SPY)
    _compare(a, sa, b, sb)
