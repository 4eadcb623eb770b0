"""The SSA operator matvec of pism_tpu_torch against the TPU kernel it
replaces (``ssa_matvec_pallas``, run in interpret mode as
tests/test_pallas.py runs it), value and forward-mode JVP. The CUDA kernel
itself is tested on the card in tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

torch.set_num_threads(2)

from pism_tpu.ops import ssa as j_ssa  # noqa: E402
from pism_tpu.ops.pallas_kernels import ssa_matvec_pallas  # noqa: E402
from pism_tpu.ops.stencils import shift as j_shift  # noqa: E402
from pism_tpu_torch.ops import ssa as t_ssa  # noqa: E402
from pism_tpu_torch.ops.kernels import ssa_matvec as K  # noqa: E402
from pism_tpu_torch.ops.stencils import shift as t_shift  # noqa: E402

My, Mx = 24, 40
DX, DY = 20e3, 25e3
# float64 agrees to rounding; float32 to its own rounding of the stencil
TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _inputs(seed, shape=(My, Mx)):
    rng = np.random.default_rng(seed)
    return dict(u=rng.normal(size=shape) * 1e-5,
                v=rng.normal(size=shape) * 1e-5,
                nuHe=rng.uniform(1e13, 1e16, size=shape),
                nuHn=rng.uniform(1e13, 1e16, size=shape),
                beta=rng.uniform(0.0, 1e10, size=shape),
                tu=rng.normal(size=shape) * 1e-5,
                tv=rng.normal(size=shape) * 1e-5)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


# the shapes of the card tests (tests/test_torch_cuda.py), so that the plain
# version the card holds the kernel against is itself held to the TPU
# kernel there: 24x40, the 20 km and 5 km grids, and shapes that no tile of
# the CUDA kernel divides
MATVEC_CASES = [
    pytest.param(dtype, shape, id=name if shape == (My, Mx)
                 else f"{name}-{shape[0]}x{shape[1]}")
    for shape in [(My, Mx), (141, 76), (561, 301), (9, 33), (33, 9), (2, 70)]
    for dtype, name in [(np.float64, "float64"), (np.float32, "float32")]]


@pytest.mark.parametrize("dtype,shape", MATVEC_CASES)
def test_matvec_matches_pallas(dtype, shape):
    x = {k: a.astype(dtype) for k, a in _inputs(1, shape).items()}
    ref = ssa_matvec_pallas(*(jnp.asarray(x[k]) for k in
                              ("u", "v", "nuHe", "nuHn", "beta")),
                            DX, DY, True)
    got = K.ssa_matvec(*(torch.from_numpy(x[k]) for k in
                         ("u", "v", "nuHe", "nuHn", "beta")), DX, DY)
    assert got[0].dtype == torch.from_numpy(x["u"]).dtype
    for g, r in zip(got, ref):
        assert _rel(g.numpy(), r) < TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_jvp_through_nuH_matches_pallas(dtype):
    """The JVP of residual(u, v) = A(u, v; nuH(u, v), beta) through
    compute_nuH with forward-mode AD: JAX's custom JVP of the Pallas kernel
    against the port's autograd.Function under torch.func.jvp."""
    x = {k: a.astype(dtype) for k, a in _inputs(2).items()}
    B = np.full((My, Mx), 1.9e8, dtype)
    H = np.full((My, Mx), 500.0, dtype)

    def jsh(a, jy, ix):
        return j_shift(a, jy, ix, False, False)

    def jres(uv):
        uu, vv = uv
        nuH = j_ssa.compute_nuH(uu, vv, jnp.asarray(B), jnp.asarray(H), DX, DY, jsh)
        return ssa_matvec_pallas(uu, vv, nuH.e, nuH.n, jnp.asarray(x["beta"]),
                                 DX, DY, True)

    def tres(uu, vv):
        nuH = t_ssa.compute_nuH(uu, vv, torch.from_numpy(B),
                                torch.from_numpy(H), DX, DY, t_shift)
        return K.SSAMatvec.apply(uu, vv, nuH.e, nuH.n,
                                 torch.from_numpy(x["beta"]), DX, DY)

    J = lambda k: jnp.asarray(x[k])  # noqa: E731
    T = lambda k: torch.from_numpy(x[k])  # noqa: E731
    _, jt = jax.jvp(jres, ((J("u"), J("v")),), ((J("tu"), J("tv")),))
    _, tt = torch.func.jvp(tres, (T("u"), T("v")), (T("tu"), T("tv")))
    for g, r in zip(tt, jt):
        assert _rel(g.numpy(), r) < TOL[dtype]


def test_function_jvp_matches_plain_residual_jvp():
    """The Function's bilinear JVP rule against torch.func.jvp of the plain
    torch residual, with tangents in every argument."""
    x = {k: torch.from_numpy(a) for k, a in _inputs(3).items()}
    rng = np.random.default_rng(4)
    t = {k: torch.from_numpy(rng.normal(size=(My, Mx)) * s) for k, s in
         (("nuHe", 1e14), ("nuHn", 1e14), ("beta", 1e8))}
    args = (x["u"], x["v"], x["nuHe"], x["nuHn"], x["beta"])
    tangents = (x["tu"], x["tv"], t["nuHe"], t["nuHn"], t["beta"])
    _, jf = torch.func.jvp(lambda *a: K.SSAMatvec.apply(*a, DX, DY),
                           args, tangents)
    _, jp = torch.func.jvp(lambda *a: K.ssa_matvec_plain(*a, DX, DY),
                           args, tangents)
    for g, r in zip(jf, jp):
        assert _rel(g.numpy(), r.numpy()) < 1e-12


def test_function_jvp_hands_the_kernel_plain_tensors(monkeypatch):
    """Under torch.func.jvp and torch.autograd.forward_ad the Function's
    JVP reaches the fused kernel with tensors that have storage. The CPU
    stand-in for the kernel reads its inputs through numpy, which, like a
    kernel's data pointers, fails on the transforms' wrapped tensors."""
    plain = K.ssa_matvec_jvp_plain

    def needs_storage(*args):
        args = [torch.from_numpy(a.numpy()) if torch.is_tensor(a) else a
                for a in args]
        return plain(*args)

    monkeypatch.setattr(K, "ssa_matvec_jvp_plain", needs_storage)
    x = {k: torch.from_numpy(a) for k, a in _inputs(3).items()}
    rng = np.random.default_rng(4)
    t = {k: torch.from_numpy(rng.normal(size=(My, Mx)) * s) for k, s in
         (("nuHe", 1e14), ("nuHn", 1e14), ("beta", 1e8))}
    args = (x["u"], x["v"], x["nuHe"], x["nuHn"], x["beta"])
    tangents = (x["tu"], x["tv"], t["nuHe"], t["nuHn"], t["beta"])
    ref = plain(*args[:2], *tangents[:2], *args[2:4], *tangents[2:4],
                args[4], tangents[4], DX, DY)
    _, jf = torch.func.jvp(lambda *a: K.SSAMatvec.apply(*a, DX, DY),
                           args, tangents)
    with fwAD.dual_level():
        out = K.SSAMatvec.apply(*(fwAD.make_dual(a, d) for a, d in
                                  zip(args, tangents)), DX, DY)
        jd = [fwAD.unpack_dual(o).tangent for o in out]
    for g, h, r in zip(jf, jd, ref):
        assert _rel(g.numpy(), r.numpy()) < 1e-12
        assert _rel(h.numpy(), r.numpy()) < 1e-12


def test_fused_jvp_is_the_two_application_rule():
    x = {k: torch.from_numpy(a) for k, a in _inputs(5).items()}
    rng = np.random.default_rng(6)
    dnu_e = torch.from_numpy(rng.normal(size=(My, Mx)) * 1e14)
    dnu_n = torch.from_numpy(rng.normal(size=(My, Mx)) * 1e14)
    fused = K.ssa_matvec_jvp(x["u"], x["v"], x["tu"], x["tv"], x["nuHe"],
                             x["nuHn"], dnu_e, dnu_n, x["beta"], None, DX, DY)
    t1 = K.ssa_matvec_plain(x["tu"], x["tv"], x["nuHe"], x["nuHn"], x["beta"],
                            DX, DY)
    t2 = K.ssa_matvec_plain(x["u"], x["v"], dnu_e, dnu_n,
                            torch.zeros_like(x["beta"]), DX, DY)
    for f, a, b in zip(fused, t1, t2):
        assert _rel(f.numpy(), (a + b).numpy()) < 1e-12


def test_wrapper_rejects_bad_inputs():
    x = {k: torch.from_numpy(a) for k, a in _inputs(7).items()}
    args = [x["u"], x["v"], x["nuHe"], x["nuHn"], x["beta"]]
    with pytest.raises(TypeError):
        K.ssa_matvec(*args[:4], args[4].float(), DX, DY)
    with pytest.raises(ValueError):
        K.ssa_matvec(*args[:4], args[4][:-1], DX, DY)
    with pytest.raises(ValueError):
        K.ssa_matvec(*args[:4], args[4].T.contiguous().T, DX, DY)
    with pytest.raises(ValueError):
        K.ssa_matvec(args[0][None], *args[1:], DX, DY)
    with pytest.raises(TypeError):
        K.ssa_matvec(*(a.to(torch.int64) for a in args), DX, DY)


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    x = {k: torch.from_numpy(a) for k, a in _inputs(8).items()}
    before = (K.LAUNCHES, K.JVP_LAUNCHES)
    got = K.ssa_matvec(x["u"], x["v"], x["nuHe"], x["nuHn"], x["beta"], DX, DY)
    ref = K.ssa_matvec_plain(x["u"], x["v"], x["nuHe"], x["nuHn"], x["beta"],
                             DX, DY)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    assert (K.LAUNCHES, K.JVP_LAUNCHES) == before

