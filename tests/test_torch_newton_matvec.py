"""The Newton matvec of the SSA solve (``ssa_newton_matvec`` and its
per-shard twin ``ssa_newton_matvec_halo``, ``ops/kernels/ssa_matvec.py``)
on the CPU, where the wrappers run their plain versions:

- against the composition it replaces in the port (free the direction,
  ``linearize_nuH``'s tangent, the icy-face mask, ``ssa_matvec_jvp_plain``,
  free, the Dirichlet rows) at 31x31 with a random Dirichlet mask that
  holds the grid's edges: 1e-13 (float64) and 1e-6 (float32) of the
  largest value, the rounding of an equal computation;
- against the TPU kernels' JVP (``ssa_matvec_pallas`` and
  ``ssa_matvec_sharded`` in interpret mode, through ``jax.jvp`` of
  nuH(u, v) as tests/test_torch_ssa_matvec.py and test_torch_sharded.py
  run them): 1e-12 / 1e-5, the tolerances of those files;
- the port's ``jmv`` from ``SSAFD.build_problem`` against the JAX
  package's ``jax.linearize(residual)`` matvec plus ``where(bc_mask, d,
  0)`` on the 100 km hybrid-chain state in float64, 1e-10 of max|J d|;
- the sharded plain version on 2x2 and 2x4 meshes of the CPU against the
  unsharded one: equal to the bit;
- CPU tensors never load the kernel library, and the wrappers refuse what
  the kernels do not take.

The kernels themselves are held to these plain versions on the card in
tests/test_torch_cuda.py.
"""

import dataclasses
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu.ops import ssa as j_ssa  # noqa: E402
from pism_tpu.ops.pallas_kernels import ssa_matvec_pallas  # noqa: E402
from pism_tpu.ops.pallas_sharded import (  # noqa: E402
    ssa_matvec_sharded as j_ssa_matvec_sharded)
from pism_tpu.ops.stencils import shift as j_shift  # noqa: E402
from pism_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from pism_tpu_torch.ops import sharded as S  # noqa: E402
from pism_tpu_torch.ops import ssa as t_ssa  # noqa: E402
from pism_tpu_torch.ops.kernels import _build  # noqa: E402
from pism_tpu_torch.ops.kernels import ssa_matvec as K  # noqa: E402
from pism_tpu_torch.ops.stencils import shift as t_shift  # noqa: E402
from pism_tpu_torch.parallel import make_mesh  # noqa: E402

DX, DY = 20e3, 25e3
SPY = 3.15569259747e7
EPS_REG2 = (1.0 / SPY / 1e6) ** 2
EXT_NUH = 4.9e16


def _system(shape, dtype, seed):
    """A linearization point, a direction and the fields that make the
    frozen system: u, v at ~300 m/a, hardness, thickness with thin ice
    under the strength extension, an icy mask whose complement (the
    Dirichlet rows) holds the whole grid edge and random cells inside."""
    rng = np.random.default_rng(seed)
    icy = rng.uniform(size=shape) > 0.15
    icy[0, :] = icy[-1, :] = icy[:, 0] = icy[:, -1] = False
    a = dict(u=rng.normal(size=shape) * 1e-5, v=rng.normal(size=shape) * 1e-5,
             du=rng.normal(size=shape) * 1e-6, dv=rng.normal(size=shape) * 1e-6,
             B=rng.uniform(1e8, 3e8, size=shape),
             H=rng.uniform(20.0, 3000.0, size=shape) * icy,
             beta=rng.uniform(0.0, 1e10, size=shape))
    a = {k: x.astype(dtype) for k, x in a.items()}
    a["icy"] = icy
    return a


def _linearized(a):
    """nuH (with the regularization and the icy-face mask), the coefficient
    planes with the mask folded into k, the port's tangent and the masks,
    as ``SSAFD.build_problem`` forms them."""
    t = {k: torch.from_numpy(x) for k, x in a.items()}
    icy = t["icy"]
    keep_e = (icy & t_shift(icy, 0, 1)).to(t["u"].dtype)
    keep_n = (icy & t_shift(icy, 1, 0)).to(t["u"].dtype)
    bc = ~icy
    u, v = torch.where(bc, 0.0, t["u"]), torch.where(bc, 0.0, t["v"])
    nuH, tangent = t_ssa.linearize_nuH(
        u, v, t["B"], t["H"], DX, DY, t_shift, n_glen=3.0, eps_reg2=EPS_REG2,
        extension_nuH=EXT_NUH, extension_mask=icy & (t["H"] < 50.0))
    nuH = t_ssa.NuH((nuH.e + 1e13) * keep_e, (nuH.n + 1e13) * keep_n)
    coefs = tuple(torch.stack((*c[:3], c[3] * keep), -1)
                  for c, keep in ((tangent.e, keep_e), (tangent.n, keep_n)))
    return dict(t, u=u, v=v, nuH=nuH, coefs=coefs, tangent=tangent,
                keep=(keep_e, keep_n), bc=bc)


def _rel(a, b):
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    return np.abs(a.astype(np.float64) - b).max() / np.abs(b).max()


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-13),
                                       (np.float32, 1e-6)])
def test_plain_equals_the_composition_it_replaces(dtype, tol):
    s = _linearized(_system((31, 31), dtype, 1))
    bc, du, dv = s["bc"], s["du"], s["dv"]
    # the parent's jmv: free, tangent, keep, fused JVP, free, Dirichlet rows
    fu, fv = torch.where(bc, 0.0, du), torch.where(bc, 0.0, dv)
    dn = s["tangent"](fu, fv)
    dn_e, dn_n = dn.e * s["keep"][0], dn.n * s["keep"][1]
    Ju, Jv = K.ssa_matvec_jvp_plain(s["u"], s["v"], fu, fv, s["nuH"].e,
                                    s["nuH"].n, dn_e, dn_n, s["beta"], None,
                                    DX, DY)
    want = (torch.where(bc, 0.0, Ju) + torch.where(bc, du, 0.0),
            torch.where(bc, 0.0, Jv) + torch.where(bc, dv, 0.0))
    args = (s["u"], s["v"], du, dv, s["nuH"].e, s["nuH"].n, *s["coefs"],
            s["beta"], bc, DX, DY)
    got = K.ssa_newton_matvec(*args)
    for g, p, w in zip(got, K.ssa_newton_matvec_plain(*args), want):
        assert g.dtype == du.dtype and g.shape == du.shape
        assert torch.equal(g, p)
        assert _rel(g, w) <= tol
    # the Dirichlet rows carry the direction itself
    assert torch.equal(got[0][bc], du[bc]) and int(bc.sum()) > 4 * 31


def _jax_nuH(B, H, icy):
    """make_nuH of the JAX package's build_problem on the same fields."""
    def jsh(x, jy, ix):
        return j_shift(x, jy, ix, False, False)

    keep_e = (icy & jsh(icy, 0, 1)).astype(B.dtype)
    keep_n = (icy & jsh(icy, 1, 0)).astype(B.dtype)

    def nuH(u, v):
        n = j_ssa.compute_nuH(u, v, B, H, DX, DY, jsh, n_glen=3.0,
                              eps_reg2=EPS_REG2, extension_nuH=EXT_NUH,
                              extension_mask=icy & (H < 50.0))
        return (n.e + 1e13) * keep_e, (n.n + 1e13) * keep_n
    return nuH


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
def test_matches_the_tpu_kernel_jvp(dtype, tol):
    """jax.jvp of free(A(u, v; nuH(u, v), beta)) through the Pallas matvec
    (interpret mode) at the direction free(d), plus d on the Dirichlet
    rows."""
    a = _system((24, 40), dtype, 2)
    s = _linearized(a)
    j = {k: jnp.asarray(x) for k, x in a.items()}
    bc = ~j["icy"]
    nuH = _jax_nuH(j["B"], j["H"], j["icy"])

    def res(u, v):
        ne, nn = nuH(u, v)
        Au, Av = ssa_matvec_pallas(u, v, ne, nn, j["beta"], DX, DY, True)
        return jnp.where(bc, 0.0, Au), jnp.where(bc, 0.0, Av)

    free = [jnp.where(bc, 0.0, j[k]) for k in ("u", "v", "du", "dv")]
    _, (Ju, Jv) = jax.jvp(res, tuple(free[:2]), tuple(free[2:]))
    want = (Ju + jnp.where(bc, j["du"], 0.0), Jv + jnp.where(bc, j["dv"], 0.0))
    got = K.ssa_newton_matvec(s["u"], s["v"], s["du"], s["dv"], s["nuH"].e,
                              s["nuH"].n, *s["coefs"], s["beta"], s["bc"],
                              DX, DY)
    for g, w in zip(got, want):
        assert _rel(g, w) <= tol


@pytest.fixture(scope="module")
def jax_devices():
    d = jax.devices()
    if len(d) < 8:
        pytest.skip("needs 8 virtual CPU devices")
    return d


@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
def test_sharded_matches_the_tpu_sharded_kernel_jvp(jax_devices, dtype, tol):
    """The per-shard Newton matvec on a 2x4 mesh against jax.jvp through
    the sharded Pallas matvec (interpret mode, 8 virtual CPU devices) on
    the uneven 29x37 grid of tests/test_sharding.py."""
    a = _system((29, 37), dtype, 3)
    s = _linearized(a)
    j = {k: jnp.asarray(x) for k, x in a.items()}
    bc = ~j["icy"]
    nuH = _jax_nuH(j["B"], j["H"], j["icy"])
    jmesh = j_make_mesh(jax_devices, (2, 4))

    def res(u, v):
        ne, nn = nuH(u, v)
        Au, Av = j_ssa_matvec_sharded(u, v, ne, nn, j["beta"], jmesh, DX, DY,
                                      True)
        return jnp.where(bc, 0.0, Au), jnp.where(bc, 0.0, Av)

    free = [jnp.where(bc, 0.0, j[k]) for k in ("u", "v", "du", "dv")]
    _, (Ju, Jv) = jax.jit(lambda p, t: jax.jvp(res, p, t))(
        tuple(free[:2]), tuple(free[2:]))
    want = (Ju + jnp.where(bc, j["du"], 0.0), Jv + jnp.where(bc, j["dv"], 0.0))
    mv = S.ssa_newton_matvec_sharded(s["u"], s["v"], s["nuH"].e, s["nuH"].n,
                                     *s["coefs"], s["beta"], s["bc"],
                                     make_mesh(["cpu"] * 8, (2, 4)), DX, DY)
    for g, w in zip(mv(s["du"], s["dv"]), want):
        assert _rel(g, w) <= tol


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sharded_equals_unsharded(dtype, shape):
    """Each shard's plain version computes the whole-field values of its
    cells, the faces of its west column and south row from the ghosts, so
    the gathered result is the unsharded one to the bit; the frozen blocks
    serve several directions."""
    s = _linearized(_system((29, 37), dtype, 4))
    mesh = make_mesh(["cpu"] * (shape[0] * shape[1]), shape)
    frozen = (s["u"], s["v"], s["nuH"].e, s["nuH"].n, *s["coefs"], s["beta"],
              s["bc"])
    n0 = (K.NEWTON_LAUNCHES, K.HALO_NEWTON_LAUNCHES)
    mv = S.ssa_newton_matvec_sharded(*frozen, mesh, DX, DY)
    mv_plain = S.ssa_newton_matvec_sharded_plain(*frozen, mesh, DX, DY)
    rng = np.random.default_rng(5)
    for d in ((s["du"], s["dv"]),
              tuple(torch.from_numpy(rng.normal(size=(29, 37)).astype(dtype))
                    for _ in range(2))):
        want = K.ssa_newton_matvec(s["u"], s["v"], *d, s["nuH"].e,
                                   s["nuH"].n, *s["coefs"], s["beta"],
                                   s["bc"], DX, DY)
        for g, p, w in zip(mv(*d), mv_plain(*d), want):
            assert torch.equal(g, w) and torch.equal(p, w)
    assert (K.NEWTON_LAUNCHES, K.HALO_NEWTON_LAUNCHES) == n0


def test_cpu_tensors_never_load_the_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"the {name} library was loaded for CPU tensors")

    monkeypatch.setattr(_build, "library", refuse)
    K._library.cache_clear()
    s = _linearized(_system((12, 9), np.float64, 6))
    args = (s["u"], s["v"], s["du"], s["dv"], s["nuH"].e, s["nuH"].n,
            *s["coefs"], s["beta"], s["bc"], DX, DY)
    K.ssa_newton_matvec(*args)
    mv = S.ssa_newton_matvec_sharded(*args[:2], *args[4:10],
                                     make_mesh(["cpu"] * 4, (2, 2)), DX, DY)
    mv(s["du"], s["dv"])
    assert K._library.cache_info().currsize == 0


def test_wrappers_refuse_what_the_kernels_do_not_take():
    s = _linearized(_system((12, 9), np.float64, 7))
    base = dict(u=s["u"], v=s["v"], du=s["du"], dv=s["dv"], nuH_e=s["nuH"].e,
                nuH_n=s["nuH"].n, coef_e=s["coefs"][0], coef_n=s["coefs"][1],
                beta=s["beta"], bc_mask=s["bc"])
    for key, bad, err in (
            ("coef_e", s["coefs"][0][..., :3].contiguous(), ValueError),
            ("coef_n", s["coefs"][1].float(), TypeError),
            ("bc_mask", s["bc"].to(torch.uint8), ValueError),
            ("bc_mask", s["bc"].T.contiguous().T, ValueError),
            ("beta", s["beta"][:-1], ValueError)):
        with pytest.raises(err):
            K.ssa_newton_matvec(**{**base, key: bad}, dx=DX, dy=DY)
    blocks = [torch.zeros(s) for s in ((6, 7), (6, 7), (6, 7), (6, 7),
                                       (4, 5), (4, 5), (4, 5, 4), (4, 5, 4),
                                       (2, 3))]
    with pytest.raises(ValueError):   # the mask needs two ghosts
        K.ssa_newton_matvec_halo(True, True, *blocks,
                                 torch.zeros((4, 5), dtype=torch.bool), DX, DY)
    blocks[6] = torch.zeros((4, 5))
    with pytest.raises(ValueError):   # coefficients on a last axis of 4
        K.ssa_newton_matvec_halo(True, True, *blocks,
                                 torch.zeros((6, 7), dtype=torch.bool), DX, DY)


# the 100 km hybrid chain through both packages (as
# tests/test_torch_ssa_solve.py builds it; importing bench.py turns on a
# persistent compilation cache, pointed at a temporary directory here)
_env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
_cache = (jax.config.jax_compilation_cache_dir,
          jax.config.jax_persistent_cache_min_compile_time_secs)
os.environ["JAX_COMPILATION_CACHE_DIR"] = tempfile.mkdtemp()
import bench  # noqa: E402

jax.config.update("jax_compilation_cache_dir", _cache[0])
jax.config.update("jax_persistent_cache_min_compile_time_secs", _cache[1])
if _env is None:
    del os.environ["JAX_COMPILATION_CACHE_DIR"]
else:
    os.environ["JAX_COMPILATION_CACHE_DIR"] = _env

from pism_tpu_torch import setups  # noqa: E402
from pism_tpu_torch.convert import state_from_numpy  # noqa: E402


def test_jmv_matches_jax_linearize():
    """The Newton matvec of ``SSAFD.solve`` (``build_problem``'s
    ``linearize_nuH`` and ``newton_matvec``) at a velocity of ~100 m/a on
    the 100 km chain's state against JAX's jax.linearize of the residual
    (beta frozen) plus d on the Dirichlet rows."""
    jm, js, _ = bench.hybrid_greenland_model("float64", km=100)
    tm, _, grid = setups.hybrid_greenland_model("float64", km=100,
                                                 device="cpu")
    d = {f.name: np.asarray(getattr(js.geometry, f.name))
         for f in dataclasses.fields(js.geometry)}
    for f in dataclasses.fields(js):
        v = getattr(js, f.name)
        if f.name != "geometry" and v is not None:
            d[f.name] = np.asarray(v)
    ts = state_from_numpy(d, device="cpu")
    JP = jm.ssa.build_problem(js, jm.yield_stress.compute(js))
    TP = tm.ssa.build_problem(ts, tm.yield_stress.compute(ts))
    rng = np.random.default_rng(8)
    X, Y = np.meshgrid(grid.x, grid.y)
    uv = [(100.0 / SPY) * (np.sin(X / 300e3 + k) + 0.2 * rng.normal(size=X.shape))
          for k in range(2)]
    dd = [rng.normal(size=X.shape) * 1e-6 for _ in range(2)]

    ju, jv = JP["free"](tuple(jnp.asarray(a) for a in uv))
    _, lin = jax.linearize(JP["residual"], (ju, jv))
    jd = tuple(jnp.asarray(a) for a in dd)
    Jd = lin(JP["free"](jd))
    bc = JP["bc_mask"]
    want = [Jd[k] + jnp.where(bc, jd[k], 0.0) for k in range(2)]

    tu, tv = TP["free"](tuple(torch.from_numpy(a) for a in uv))
    nuH, coefs = TP["linearize_nuH"](tu, tv)
    jmv = TP["newton_matvec"](tu, tv, nuH, coefs, TP["beta_fn"](tu, tv))
    got = jmv(tuple(torch.from_numpy(a) for a in dd))
    scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
    assert scale > 0.0
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-10 * scale
    assert torch.equal(TP["bc_mask"], torch.from_numpy(np.array(bc)))
