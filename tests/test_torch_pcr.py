"""K2 and K2b, the PCR line-solve kernels: their plain torch versions in
pism_tpu_torch against the TPU kernels ``pcr_fused_sub`` (system on axis
-2) and ``pcr_fused`` (system on the last axis) run in interpret mode, on
random diagonally dominant systems; and the line preconditioner with
``line_pcr_impl = pallas_sublane`` against the JAX package's.

Tolerance 1e-12 of the largest value, float64: the same eliminations in the
same order, so only rounding differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu import Grid as JGrid  # noqa: E402
from pism_tpu.ops import ssa as j_ssa  # noqa: E402
from pism_tpu.ops.pallas_kernels import pcr_fused, pcr_fused_sub  # noqa: E402
from pism_tpu.ops.stencils import Shifter as JShifter  # noqa: E402
import pism_tpu_torch as pt  # noqa: E402
from pism_tpu_torch.ops import ssa as t_ssa  # noqa: E402
from pism_tpu_torch.ops.kernels import pcr as K2  # noqa: E402
from pism_tpu_torch.ops.stencils import Shifter as TShifter  # noqa: E402


def _system(shape, seed):
    """Random rows with |b| > |a| + |c|; unit diagonal as the line
    preconditioner's equilibrated rows have."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.45, 0.0, size=shape)
    c = rng.uniform(-0.45, 0.0, size=shape)
    b = np.ones(shape) + rng.uniform(0.0, 0.1, size=shape)
    d = rng.normal(size=shape)
    return a, b, c, d


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("n,batch", [(1, 7), (2, 5), (37, 9), (76, 141),
                                     (141, 76)])
def test_lines_sub_matches_tpu_kernel(n, batch):
    a, b, c, d = _system((n, batch), n)
    ref = pcr_fused_sub(*(jnp.asarray(x) for x in (a, b, c, d)),
                        interpret=True)
    got = K2.pcr_lines_sub(*(torch.from_numpy(x) for x in (a, b, c, d)))
    assert got.shape == (n, batch) and got.dtype == torch.float64
    assert _rel(got.numpy(), ref) <= 1e-12


@pytest.mark.parametrize("batch,n", [(7, 1), (5, 2), (9, 37), (141, 76)])
def test_lines_matches_tpu_kernel(batch, n):
    a, b, c, d = _system((batch, n), n + 1)
    ref = pcr_fused(*(jnp.asarray(x) for x in (a, b, c, d)),
                    interpret=True)
    got = K2.pcr_lines(*(torch.from_numpy(x) for x in (a, b, c, d)))
    assert got.shape == (batch, n)
    assert _rel(got.numpy(), ref) <= 1e-12


def test_edge_coefficients_are_ignored():
    """a on the first row and c on the last row of each line do not enter."""
    a, b, c, d = (torch.from_numpy(x) for x in _system((37, 9), 5))
    x = K2.pcr_lines_sub(a, b, c, d)
    a2, c2 = a.clone(), c.clone()
    a2[0], c2[-1] = 123.0, -77.0
    assert torch.equal(K2.pcr_lines_sub(a2, b, c2, d), x)
    assert torch.equal(K2.pcr_lines(a2.T.contiguous(), b.T.contiguous(),
                                    c2.T.contiguous(), d.T.contiguous()),
                       x.T)


def test_wrappers_check_inputs():
    a, b, c, d = (torch.from_numpy(x) for x in _system((8, 6), 1))
    with pytest.raises(ValueError):
        K2.pcr_lines(a, b, c, d[:, :-1].contiguous())
    with pytest.raises(ValueError):
        K2.pcr_lines_sub(a.T, b.T, c.T, d.T)      # not contiguous
    with pytest.raises(TypeError):
        K2.pcr_lines(a.float(), b, c, d)
    with pytest.raises(TypeError):
        K2.pcr_lines(*(x.int() for x in (a, b, c, d)))


@pytest.fixture(scope="module")
def frozen_system():
    kw = dict(Mx=23, My=31, Lx=450e3, Ly=600e3)
    jg, tg = JGrid(**kw), pt.Grid(**kw)
    rng = np.random.default_rng(11)
    bc = rng.random(jg.shape2) < 0.15
    bc[0], bc[-1], bc[:, 0], bc[:, -1] = True, True, True, True
    nuHe = rng.uniform(1e14, 1e17, size=jg.shape2)
    nuHn = rng.uniform(1e14, 1e17, size=jg.shape2)
    beta = rng.uniform(1e6, 1e10, size=jg.shape2)
    r = (rng.normal(size=jg.shape2), rng.normal(size=jg.shape2))
    return jg, tg, bc, nuHe, nuHn, beta, r


def _torch_precond(frozen_system, impl):
    jg, tg, bc, nuHe, nuHn, beta, r = frozen_system
    T = torch.from_numpy
    tp = t_ssa.make_line_preconditioner(
        t_ssa.NuH(T(nuHe), T(nuHn)), T(beta), T(bc), jg.dx, jg.dy,
        TShifter(tg), impl)
    return tp((T(r[0]), T(r[1])))


def test_preconditioner_pallas_sublane_matches_jax(frozen_system):
    jg, tg, bc, nuHe, nuHn, beta, r = frozen_system
    jp = j_ssa.make_line_preconditioner(
        j_ssa.NuH(jnp.asarray(nuHe), jnp.asarray(nuHn)), jnp.asarray(beta),
        jnp.asarray(bc), jg.dx, jg.dy, JShifter(jg),
        pcr_impl="pallas_sublane")
    ref = jp((jnp.asarray(r[0]), jnp.asarray(r[1])))
    for got, want in zip(_torch_precond(frozen_system, "pallas_sublane"), ref):
        assert got.is_contiguous()
        assert _rel(got.numpy(), want) <= 1e-12


def test_preconditioner_routes_agree(frozen_system):
    """``xla`` (plain PCR on the transposed v-lines) and ``pallas_sublane``
    (the kernels' CPU path on the (My, Mx) layout) give the same solve."""
    xla = _torch_precond(frozen_system, "xla")
    sub = _torch_precond(frozen_system, "pallas_sublane")
    for a, b in zip(sub, xla):
        assert _rel(a.numpy(), b.numpy()) <= 1e-15
    with pytest.raises(NotImplementedError):
        _torch_precond(frozen_system, "pallas")
