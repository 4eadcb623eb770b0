"""Periodic grids in the port: ``ops/stencils.py``'s ``shift`` and
``Shifter`` against the JAX package's on x, y and xy periodicity, to the
bit; ``pad_ghosts``; the SSA operator's periodic route (the padded-block
kernel on the whole field wrap-padded, ``ops/ssa.py``) and its Newton
matvec against the plain periodic stencils and against the JAX package's
periodic operator, to the bit on the CPU; the line preconditioner on a
periodic grid against the JAX package's (its PCR drops the wrap coupling of
the first and last rows, as the JAX package's does). The card holds the
route's kernels to the same references in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pism_tpu import Grid as JGrid
from pism_tpu.ops import ssa as j_ssa
from pism_tpu.ops import stencils as j_st
from pism_tpu_torch import Grid
from pism_tpu_torch.ops import ssa as t_ssa
from pism_tpu_torch.ops import stencils as t_st
from pism_tpu_torch.ops.kernels import ssa_matvec as K

torch.set_num_threads(2)

T = torch.from_numpy
PERIODICITY = ["x", "y", "xy"]
DX, DY = 20e3, 25e3


def _grids(periodicity, My=7, Mx=11):
    kw = dict(Mx=Mx, My=My, Lx=100e3, Ly=75e3, periodicity=periodicity)
    return JGrid(**kw), Grid(**kw)


@pytest.mark.parametrize("periodicity", PERIODICITY)
def test_shift_matches_jax(periodicity):
    jg, tg = _grids(periodicity)
    a = np.random.default_rng(0).normal(size=(jg.My, jg.Mx, 3))
    jsh, tsh = j_st.Shifter(jg), t_st.Shifter(tg)
    for jy in range(-3, 4):
        for ix in range(-3, 4):
            ref = np.asarray(j_st.shift(jnp.asarray(a), jy, ix,
                                        jg.periodic_y, jg.periodic_x))
            got = t_st.shift(T(a), jy, ix, tg.periodic_y, tg.periodic_x)
            np.testing.assert_array_equal(got.numpy(), ref)
            np.testing.assert_array_equal(
                tsh(T(a), jy, ix).numpy(),
                np.asarray(jsh(jnp.asarray(a), jy, ix)))


@pytest.mark.parametrize("periodicity", ["none"] + PERIODICITY)
def test_pad_ghosts_reads_the_shifted_values(periodicity):
    """Every ghost of ``pad_ghosts`` is the value ``shift`` reads there."""
    _, tg = _grids(periodicity)
    a = T(np.random.default_rng(1).normal(size=tg.shape2))
    p = t_st.pad_ghosts(a, 2, tg.periodic_y, tg.periodic_x)
    assert p.shape == (tg.My + 4, tg.Mx + 4) and p.is_contiguous()
    for jy in range(-2, 3):
        for ix in range(-2, 3):
            want = t_st.shift(a, jy, ix, tg.periodic_y, tg.periodic_x)
            assert torch.equal(p[2 + jy:2 + jy + tg.My, 2 + ix:2 + ix + tg.Mx],
                               want)


def _fields(seed, shape, dtype=np.float64):
    rng = np.random.default_rng(seed)
    d = dict(u=rng.normal(size=shape) * 1e-5, v=rng.normal(size=shape) * 1e-5,
             nuHe=rng.uniform(1e13, 1e16, size=shape),
             nuHn=rng.uniform(1e13, 1e16, size=shape),
             beta=rng.uniform(0.0, 1e10, size=shape),
             du=rng.normal(size=shape) * 1e-5,
             dv=rng.normal(size=shape) * 1e-5,
             B=rng.uniform(1e8, 3e8, size=shape),
             H=rng.uniform(10.0, 2000.0, size=shape))
    d = {k: a.astype(dtype) for k, a in d.items()}
    d["bc"] = rng.random(shape) < 0.2
    return d


@pytest.mark.parametrize("periodicity", PERIODICITY)
@pytest.mark.parametrize("shape", [(7, 11), (5, 51), (33, 3)])
def test_periodic_matvec_route_matches_jax(periodicity, shape):
    """The route (on the CPU, the padded-block kernel's plain version), the
    plain periodic stencils and the JAX package's periodic operator agree
    to the bit; the route reaches the padded-block instance."""
    jg, tg = _grids(periodicity, *shape)
    x = _fields(2, shape)
    periodic = (tg.periodic_y, tg.periodic_x)
    ref = j_ssa.apply_operator(
        jnp.asarray(x["u"]), jnp.asarray(x["v"]),
        j_ssa.NuH(jnp.asarray(x["nuHe"]), jnp.asarray(x["nuHn"])),
        jnp.asarray(x["beta"]), DX, DY, j_st.Shifter(jg))
    nuH = t_ssa.NuH(T(x["nuHe"]), T(x["nuHn"]))
    got = t_ssa.apply_operator(T(x["u"]), T(x["v"]), nuH, T(x["beta"]),
                               DX, DY, periodic)
    plain = t_ssa.apply_operator_stencil(T(x["u"]), T(x["v"]), nuH,
                                         T(x["beta"]), DX, DY,
                                         t_st.Shifter(tg))
    for g, p, r in zip(got, plain, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))


@pytest.mark.parametrize("periodicity", PERIODICITY)
def test_periodic_newton_matvec_route(periodicity):
    """The Newton matvec's periodic route against the plain stencils (the
    tangent of ``linearize_nuH`` with periodic shifts, the operator, the
    Dirichlet rows), to the bit, from a sweep's own linearization."""
    _, tg = _grids(periodicity)
    x = _fields(3, tg.shape2)
    sh = t_st.Shifter(tg)
    periodic = (tg.periodic_y, tg.periodic_x)
    u, v = T(x["u"]), T(x["v"])
    nuH, tangent = t_ssa.linearize_nuH(u, v, T(x["B"]), T(x["H"]), DX, DY, sh)
    coefs = tuple(torch.stack(c, -1) for c in (tangent.e, tangent.n))
    bc = T(x["bc"])
    mv = t_ssa.ssa_newton_matvec_periodic(u, v, nuH.e, nuH.n, *coefs,
                                          T(x["beta"]), bc, DX, DY, periodic)
    for seed in (4, 5):
        d = _fields(seed, tg.shape2)
        got = mv(T(d["du"]), T(d["dv"]))
        want = t_ssa.newton_matvec_stencil(u, v, T(d["du"]), T(d["dv"]), nuH,
                                           tangent, T(x["beta"]), bc, DX, DY,
                                           sh)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_closed_axes_route_equals_k1():
    """With no periodic axis the padded-block route is K1's result (so the
    route's edge flags close the grid as K1's clamp does)."""
    x = _fields(6, (9, 13))
    args = [T(x[k]) for k in ("u", "v", "nuHe", "nuHn", "beta")]
    a = t_ssa.ssa_matvec_periodic(*args, DX, DY, (False, False))
    b = K.ssa_matvec(*args, DX, DY)
    for g, w in zip(a, b):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("impl", ["xla", "pallas_sublane"])
@pytest.mark.parametrize("periodicity", PERIODICITY)
def test_line_preconditioner_periodic_matches_jax(periodicity, impl):
    jg, tg = _grids(periodicity, 9, 13)
    x = _fields(7, tg.shape2)
    rng = np.random.default_rng(8)
    r = (rng.normal(size=tg.shape2), rng.normal(size=tg.shape2))
    jp = j_ssa.make_line_preconditioner(
        j_ssa.NuH(jnp.asarray(x["nuHe"]), jnp.asarray(x["nuHn"])),
        jnp.asarray(x["beta"]), jnp.asarray(x["bc"]), DX, DY,
        j_st.Shifter(jg), pcr_impl=impl)
    tp = t_ssa.make_line_preconditioner(
        t_ssa.NuH(T(x["nuHe"]), T(x["nuHn"])), T(x["beta"]), T(x["bc"]),
        DX, DY, t_st.Shifter(tg), impl)
    for got, want in zip(tp((T(r[0]), T(r[1]))),
                         jp((jnp.asarray(r[0]), jnp.asarray(r[1])))):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()
