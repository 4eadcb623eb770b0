"""K2 and K2b, the PCR line-solve kernels: their plain torch versions in
pism_tpu_torch against the TPU kernels ``pcr_fused_sub`` (system on axis
-2) and ``pcr_fused`` (system on the last axis) run in interpret mode, on
random diagonally dominant systems, in the one-shot form and as a factor
(unit diagonal implicit) followed by an apply with a scale; the plain factor
and apply against the plain PCR solve, equal to the bit; and the line
preconditioner with ``line_pcr_impl = pallas_sublane`` against the JAX
package's.

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


_FACTOR_SHAPES = [(1, 7), (2, 5), (37, 9), (141, 76), (561, 6)]   # (n, batch)


def _unit_system(shape, seed):
    """(a, c, r, scale): unit-diagonal rows, a residual and the row scale
    the line preconditioner divides it by."""
    a, _, c, r = _system(shape, seed)
    scale = np.random.default_rng(seed + 100).uniform(0.5, 2.0, size=shape)
    return a, c, r, scale


@pytest.mark.parametrize("n,batch", _FACTOR_SHAPES)
def test_factor_apply_sub_matches_tpu_kernel(n, batch):
    """Factor with the unit diagonal implicit, apply with a scale, on axis
    -2, against the TPU kernel on (a, ones, c, r / scale); n = 561 runs ten
    rounds."""
    a, c, r, scale = _unit_system((n, batch), n + 2)
    ref = pcr_fused_sub(jnp.asarray(a), jnp.ones((n, batch)), jnp.asarray(c),
                        jnp.asarray(r / scale), interpret=True)
    T = torch.from_numpy
    f = K2.pcr_factor_lines_sub(T(a), None, T(c))
    got = K2.pcr_apply(f, T(r), T(scale))
    assert f.sub and (f.n, f.batch) == (n, batch)
    assert got.shape == (n, batch) and got.is_contiguous()
    assert _rel(got.numpy(), ref) <= 1e-12


@pytest.mark.parametrize("n,batch", _FACTOR_SHAPES)
def test_factor_apply_lines_matches_tpu_kernel(n, batch):
    a, c, r, scale = _unit_system((batch, n), n + 3)
    ref = pcr_fused(jnp.asarray(a), jnp.ones((batch, n)), jnp.asarray(c),
                    jnp.asarray(r / scale), interpret=True)
    T = torch.from_numpy
    f = K2.pcr_factor_lines(T(a), None, T(c))
    got = K2.pcr_apply(f, T(r), T(scale))
    assert not f.sub and (f.n, f.batch) == (n, batch)
    assert got.shape == (batch, n)
    assert _rel(got.numpy(), ref) <= 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sub", [True, False])
@pytest.mark.parametrize("unit", [True, False])
@pytest.mark.parametrize("n,batch", [(1, 4), (2, 3), (37, 9), (141, 19)])
def test_factor_apply_equals_plain_pcr_to_the_bit(dtype, sub, unit, n, batch):
    """apply_plain(factor_plain(a, b, c), d) is solve_batched_pcr(a, b, c, d)
    operation for operation, in both dtypes and layouts, with b given or
    the unit diagonal implicit, with and without a scale."""
    a, b, c, d = (torch.from_numpy(x).to(dtype)
                  for x in _system((n, batch) if sub else (batch, n), n + 4))
    scale = 1.0 + torch.rand(d.shape, dtype=dtype,
                             generator=torch.Generator().manual_seed(n))
    if unit:
        b = torch.ones_like(a)
    solve = K2.pcr_lines_sub_plain if sub else K2.pcr_lines_plain
    make = K2.pcr_factor_lines_sub_plain if sub else K2.pcr_factor_lines_plain
    wrapped = K2.pcr_factor_lines_sub if sub else K2.pcr_factor_lines
    f = make(a, None if unit else b, c)
    assert torch.equal(K2.pcr_apply_plain(f, d), solve(a, b, c, d))
    assert torch.equal(K2.pcr_apply_plain(f, d, scale),
                       solve(a, b, c, d / scale))
    # the wrappers take the plain versions on CPU tensors
    assert torch.equal(K2.pcr_apply(wrapped(a, None if unit else b, c), d, scale),
                       solve(a, b, c, d / scale))
    alpha, gamma, b_last = f.coefficients()
    rounds = 0 if n == 1 else int(np.ceil(np.log2(n)))
    assert alpha.shape == gamma.shape == (rounds, *d.shape)
    assert b_last.shape == d.shape and alpha.dtype == dtype


@pytest.mark.parametrize("sub", [True, False])
def test_one_factor_serves_several_right_hand_sides(sub):
    n, batch = 76, 23
    shape = (n, batch) if sub else (batch, n)
    a, b, c, _ = (torch.from_numpy(x) for x in _system(shape, 21))
    f = (K2.pcr_factor_lines_sub if sub else K2.pcr_factor_lines)(a, b, c)
    solve = K2.pcr_lines_sub if sub else K2.pcr_lines
    g = torch.Generator().manual_seed(3)
    for _ in range(4):
        d = torch.randn(shape, dtype=torch.float64, generator=g)
        x = K2.pcr_apply(f, d)
        assert torch.equal(x, solve(a, b, c, d))
        # it solves the system it was factored from
        xs = x if not sub else x.T
        am, bm, cm, dm = ((t if not sub else t.T) for t in (a, b, c, d))
        res = bm * xs - dm
        res[:, 1:] += am[:, 1:] * xs[:, :-1]
        res[:, :-1] += cm[:, :-1] * xs[:, 1:]
        assert float(res.abs().max()) <= 1e-12


def test_apply_checks_inputs():
    a, b, c, d = (torch.from_numpy(x) for x in _system((8, 6), 2))
    f = K2.pcr_factor_lines(a, b, c)
    with pytest.raises(ValueError):
        K2.pcr_apply(f, d[:, :-1].contiguous())       # another shape
    with pytest.raises(ValueError):
        K2.pcr_apply(f, d.float())                    # another dtype
    with pytest.raises(ValueError):
        K2.pcr_apply(f, d, d.T)                       # scale not contiguous
    with pytest.raises(TypeError):
        K2.pcr_factor_lines_sub(a, b.float(), c)
    with pytest.raises(ValueError):
        K2.pcr_factor_lines(a, None, c[:, :-1].contiguous())


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
