"""Card-only tests of pism_tpu_torch: the CUDA kernels (SSA matvec, the
Newton matvec, PCR line solves, fused thermomechanical and isothermal SIA)
against their plain torch versions, the 100 km chain on the card against
the CPU, and EISMINT II A and Halfar test B through the SIA kernels against
the CPU, their max of D from the launch against the faces' max; K5 (the
matvec per shard of a mesh of the card) against its plain version and
against K1 on the whole field, the Newton matvec per shard against the
unsharded one, and K3/K4 per shard against the unsharded kernels, equal to
the bit; PICO and Lingle-Clark on the card against the CPU, and one step of
the 16 km PIK chain.

They skip without a CUDA card. This file imports no JAX, so on a machine
with a card and no JAX it runs without the JAX-loading conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pism_tpu_torch import setups  # noqa: E402
from pism_tpu_torch.convert import state_to_numpy  # noqa: E402
from pism_tpu_torch.model.icemodel import IceModel  # noqa: E402
from pism_tpu_torch.ops import sharded as S  # noqa: E402
from pism_tpu_torch.ops import ssa as ssa_ops  # noqa: E402
from pism_tpu_torch.ops.kernels import pcr as K2  # noqa: E402
from pism_tpu_torch.ops.kernels import sia_iso as K4  # noqa: E402
from pism_tpu_torch.ops.kernels import sia_thermo as K3  # noqa: E402
from pism_tpu_torch.ops.kernels import ssa_matvec as K  # noqa: E402
from pism_tpu_torch.ops.stencils import shift  # noqa: E402
from pism_tpu_torch.parallel import make_mesh  # noqa: E402
from pism_tpu_torch.physics.enthalpy_converter import EnthalpyConverter  # noqa: E402
from pism_tpu_torch.physics.rheology import GPBLD, PatersonBudd  # noqa: E402

DX, DY = 20e3, 25e3
SPY = 3.15569259747e7
# float64 agrees to rounding; float32 to its own rounding of the stencil
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(shape, dtype, device, seed):
    rng = np.random.default_rng(seed)
    a = {k: rng.normal(size=shape) * 1e-5 for k in ("u", "v", "du", "dv")}
    a["nuH_e"] = rng.uniform(1e13, 1e16, size=shape)
    a["nuH_n"] = rng.uniform(1e13, 1e16, size=shape)
    a["dnuH_e"] = rng.normal(size=shape) * 1e14
    a["dnuH_n"] = rng.normal(size=shape) * 1e14
    a["beta"] = rng.uniform(0.0, 1e10, size=shape)
    a["dbeta"] = rng.normal(size=shape) * 1e8
    return {k: torch.tensor(v, dtype=dtype, device=device) for k, v in a.items()}


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(24, 40), (141, 76), (561, 301),
                                   (9, 33), (33, 9), (2, 70)])
def test_kernels_match_plain(cuda, dtype, shape):
    """Matvec and fused JVP (with and without a drag tangent) at a small
    shape, at the 20 km and 5 km grids and at shapes that no tile of the
    matvec kernel divides (narrower or shorter than one tile, ragged on
    either axis); each call launches once."""
    x = _inputs(shape, dtype, cuda, 9)
    mv = (x["u"], x["v"], x["nuH_e"], x["nuH_n"], x["beta"], DX, DY)
    n0 = K.LAUNCHES
    got, ref = K.ssa_matvec(*mv), K.ssa_matvec_plain(*mv)
    torch.cuda.synchronize()
    assert K.LAUNCHES == n0 + 1
    for g, r in zip(got, ref):
        assert _rel(g, r) < TOL[dtype]
    for dbeta in (None, x["dbeta"]):
        jv = (x["u"], x["v"], x["du"], x["dv"], x["nuH_e"], x["nuH_n"],
              x["dnuH_e"], x["dnuH_n"], x["beta"], dbeta, DX, DY)
        n0 = K.JVP_LAUNCHES
        got, ref = K.ssa_matvec_jvp(*jv), K.ssa_matvec_jvp_plain(*jv)
        torch.cuda.synchronize()
        assert K.JVP_LAUNCHES == n0 + 1
        for g, r in zip(got, ref):
            assert _rel(g, r) < TOL[dtype]


@pytest.mark.cuda
def test_function_jvp_on_the_card(cuda):
    """torch.func.jvp through the autograd.Function (the fused kernel) against
    torch.func.jvp of the plain version."""
    x = _inputs((24, 40), torch.float64, cuda, 10)
    args = (x["u"], x["v"], x["nuH_e"], x["nuH_n"], x["beta"])
    tangents = (x["du"], x["dv"], x["dnuH_e"], x["dnuH_n"], x["dbeta"])
    _, jf = torch.func.jvp(lambda *a: K.SSAMatvec.apply(*a, DX, DY),
                           args, tangents)
    _, jp = torch.func.jvp(lambda *a: K.ssa_matvec_plain(*a, DX, DY),
                           args, tangents)
    for g, r in zip(jf, jp):
        assert _rel(g, r) < 1e-12


@pytest.mark.cuda
def test_wrapper_rejects_mixed_devices(cuda):
    x = _inputs((8, 8), torch.float64, cuda, 11)
    with pytest.raises(ValueError):
        K.ssa_matvec(x["u"], x["v"], x["nuH_e"], x["nuH_n"], x["beta"].cpu(),
                     DX, DY)


@pytest.mark.cuda
def test_chain_on_the_card_matches_cpu(cuda):
    """The 100 km chain in float64 for one model year: equal step counts;
    H to 1e-5 of max H and the volume to 1e-8, because the SSA solve
    amplifies the rounding differences of the two devices (a 1e-15 input
    change moves u by ~1e-5 of max|u|)."""
    runs = {}
    for where in ("cpu", cuda):
        model, state, _ = setups.hybrid_greenland_model("float64", 100.0,
                                                        device=where)
        n0 = (K.NEWTON_LAUNCHES, K.JVP_LAUNCHES)
        state, t, stats = model.step_once(state, 0.0, SPY)
        runs[str(where)] = (state_to_numpy(state), stats,
                            K.NEWTON_LAUNCHES - n0[0], K.JVP_LAUNCHES - n0[1])
    (a, sa, la, ja), (b, sb, lb, jb) = runs["cpu"], runs[str(cuda)]
    assert la == 0 and lb > 0 and ja == jb == 0
    assert sb.nsteps == sa.nsteps and sb.limit_hits_dict() == sa.limit_hits_dict()
    Ha, Hb = a["ice_thickness"], b["ice_thickness"]
    assert np.all(np.isfinite(Hb))
    assert np.abs(Hb - Ha).max() <= 1e-5 * Ha.max()
    assert abs(Hb.sum() - Ha.sum()) <= 1e-8 * Ha.sum()


def _newton_inputs(shape, dtype, device, seed):
    """A frozen Newton system: the linearization point, a direction, nuH,
    coefficient planes (a1, a2, a3, k; k zero on a tenth of the faces, as
    the icy-face mask leaves it) that give dnuH ~ 1e14, beta, and a
    Dirichlet mask holding the grid's edges and a tenth of the cells."""
    rng = np.random.default_rng(seed)
    a = {k: rng.normal(size=shape) * 1e-5 for k in ("u", "v")}
    a.update({k: rng.normal(size=shape) * 1e-6 for k in ("du", "dv")})
    a["nuH_e"] = rng.uniform(1e13, 1e16, size=shape)
    a["nuH_n"] = rng.uniform(1e13, 1e16, size=shape)
    for f in ("coef_e", "coef_n"):
        c = rng.normal(size=(*shape, 4)) * 1e10
        c[..., 3] = rng.uniform(1e13, 1e15, size=shape) \
            * (rng.uniform(size=shape) > 0.1)
        a[f] = c
    a["beta"] = rng.uniform(0.0, 1e10, size=shape)
    x = {k: torch.tensor(v, dtype=dtype, device=device) for k, v in a.items()}
    bc = rng.uniform(size=shape) < 0.1
    bc[0, :] = bc[-1, :] = bc[:, 0] = bc[:, -1] = True
    x["bc"] = torch.tensor(bc, device=device)
    return x


NEWTON_ARGS = ("u", "v", "du", "dv", "nuH_e", "nuH_n", "coef_e", "coef_n",
               "beta", "bc")


def _replaced_composition(x):
    """What the Newton matvec replaces, on the tensors' device: free the
    direction, the plain torch tangent, the fused JVP launch, free, the
    Dirichlet rows."""
    bc = x["bc"]
    fu, fv = torch.where(bc, 0.0, x["du"]), torch.where(bc, 0.0, x["dv"])
    dn = ssa_ops.NuHTangent(x["coef_e"].unbind(-1), x["coef_n"].unbind(-1),
                            DX, DY, shift)(fu, fv)
    Ju, Jv = K.ssa_matvec_jvp(x["u"], x["v"], fu, fv, x["nuH_e"], x["nuH_n"],
                              dn.e, dn.n, x["beta"], None, DX, DY)
    return (torch.where(bc, 0.0, Ju) + torch.where(bc, x["du"], 0.0),
            torch.where(bc, 0.0, Jv) + torch.where(bc, x["dv"], 0.0))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(24, 40), (141, 76), (561, 301)])
def test_newton_matvec_matches_plain(cuda, dtype, shape):
    """The Newton matvec against its plain version (one launch per call)
    and against the composition it replaces on the card, to the bit: the
    tangent rounds as torch's ops do there, the stresses as K1's JVP."""
    x = _newton_inputs(shape, dtype, cuda, 15)
    args = [x[k] for k in NEWTON_ARGS]
    n0 = K.NEWTON_LAUNCHES
    got = K.ssa_newton_matvec(*args, DX, DY)
    torch.cuda.synchronize()
    assert K.NEWTON_LAUNCHES == n0 + 1
    for g, r, c in zip(got, K.ssa_newton_matvec_plain(*args, DX, DY),
                       _replaced_composition(x)):
        assert _rel(g, r) < TOL[dtype]
        assert torch.equal(g, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape,mesh_shape", [((142, 76), (2, 2)),
                                              ((29, 37), (2, 4))])
def test_newton_matvec_halo_equals_unsharded(cuda, dtype, shape, mesh_shape):
    """The Newton matvec per shard of a mesh of the card: one launch per
    shard and call, within K1's tolerance of the plain sharded version and
    equal to the unsharded kernel to the bit, for two directions of one
    prepared system."""
    mesh = make_mesh([cuda] * (mesh_shape[0] * mesh_shape[1]), mesh_shape)
    x = _newton_inputs(shape, dtype, cuda, 16)
    frozen = [x[k] for k in NEWTON_ARGS if k not in ("du", "dv")]
    mv = S.ssa_newton_matvec_sharded(*frozen, mesh, DX, DY)
    mv_plain = S.ssa_newton_matvec_sharded_plain(*frozen, mesh, DX, DY)
    for d in ((x["du"], x["dv"]), (x["dv"], x["u"])):
        n0 = K.HALO_NEWTON_LAUNCHES
        got = mv(*d)
        torch.cuda.synchronize()
        assert K.HALO_NEWTON_LAUNCHES == n0 + mesh.size
        whole = K.ssa_newton_matvec(x["u"], x["v"], *d, *frozen[2:], DX, DY)
        for g, r, w in zip(got, mv_plain(*d), whole):
            assert _rel(g, r) < TOL[dtype]
            assert torch.equal(g, w)


def _tridiag(shape, seed, dtype, device):
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.45, 0.0, size=shape)
    c = rng.uniform(-0.45, 0.0, size=shape)
    b = 1.0 + rng.uniform(0.0, 0.1, size=shape)
    d = rng.normal(size=shape)
    return [torch.tensor(x, dtype=dtype, device=device) for x in (a, b, c, d)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n,batch", [(1, 5), (2, 3), (37, 9), (76, 141),
                                     (141, 76), (301, 561), (561, 301),
                                     (3000, 4), (4096, 3), (4800, 2)])
def test_pcr_kernels_match_plain(cuda, dtype, n, batch):
    """Both layouts at the chain's line shapes, at n = 1 and n not a power
    of two, and on lines longer than a block's threads: the one-shot form,
    the factor alone (b given, and the unit diagonal implicit) and the
    apply alone (with and without a scale) round as the plain versions do,
    so all are equal to the bit. A block is one line, so no batch leaves a
    ragged last block; 3000 and 4096 slots take four per thread (4096 a
    whole block of 1024 threads), 4800 take 32."""
    sub = _tridiag((n, batch), n, dtype, cuda)
    lanes = [x.T.contiguous() for x in sub]
    scale = 0.5 + torch.rand((n, batch), dtype=dtype, device=cuda,
                             generator=torch.Generator(cuda).manual_seed(n))
    n0, s0 = K2.LAUNCHES, K2.SUB_LAUNCHES
    f0, fs0 = K2.FACTOR_LAUNCHES, K2.SUB_FACTOR_LAUNCHES
    got_sub, got = K2.pcr_lines_sub(*sub), K2.pcr_lines(*lanes)
    torch.cuda.synchronize()
    assert (K2.LAUNCHES, K2.SUB_LAUNCHES) == (n0 + 1, s0 + 1)
    assert (K2.FACTOR_LAUNCHES, K2.SUB_FACTOR_LAUNCHES) == (f0 + 1, fs0 + 1)
    assert torch.equal(got_sub, K2.pcr_lines_sub_plain(*sub))
    assert torch.equal(got, K2.pcr_lines_plain(*lanes))
    assert torch.equal(got.T, got_sub)

    for is_sub, (a, b, c, d), sc, make, make_plain in (
            (True, sub, scale, K2.pcr_factor_lines_sub,
             K2.pcr_factor_lines_sub_plain),
            (False, lanes, scale.T.contiguous(), K2.pcr_factor_lines,
             K2.pcr_factor_lines_plain)):
        for unit in (False, True):
            fp = make_plain(a, None if unit else b, c)
            f = make(a, None if unit else b, c)
            assert f.sub == is_sub and f.table is not None
            for g, q in zip(f.coefficients(), fp.coefficients()):
                assert torch.equal(g, q)
            for s_ in (None, sc):
                x = K2.pcr_apply(f, d, s_)
                torch.cuda.synchronize()
                assert torch.equal(x, K2.pcr_apply_plain(fp, d, s_))


@pytest.mark.cuda
def test_pcr_kernels_refuse_what_they_do_not_take(cuda):
    """A line too long for a block's shared memory, a plain factor and
    a right-hand side of another dtype than the factor's raise; nothing
    falls back to the plain version."""
    a, b, c, d = _tridiag((8, 6), 3, torch.float32, cuda)
    with pytest.raises(ValueError):
        K2.pcr_apply(K2.pcr_factor_lines_sub(a, b, c), d.double())
    long = _tridiag((4, 10000), 4, torch.float32, cuda)
    with pytest.raises(RuntimeError):
        K2.pcr_lines(*long)                           # 6 n floats > 227 KB
    with pytest.raises(ValueError):
        K2.pcr_apply(K2.pcr_factor_lines_plain(a, b, c), d)


def _sia_inputs(shape, dtype, device, seed=5):
    My, Mx, Mz = shape
    rng = np.random.default_rng(seed)
    Y, X = np.meshgrid(np.linspace(-1, 1, My), np.linspace(-1, 1, Mx),
                       indexing="ij")
    H = np.maximum(3000.0 * (1.0 - X ** 2 - Y ** 2), 0.0)
    s = H + rng.uniform(0.0, 5.0, size=H.shape) * (H > 0)
    z = 5000.0 * np.linspace(0.0, 1.0, Mz) ** 2
    E = 1.0e5 + rng.uniform(0.0, 8e4, size=shape)
    return [torch.tensor(x, dtype=dtype, device=device) for x in (H, s, E, z)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("law", [PatersonBudd, GPBLD])
@pytest.mark.parametrize("shape", [(61, 61, 61), (30, 17, 5), (33, 33, 61),
                                   (9, 33, 13), (33, 9, 7)])
def test_sia_thermo_kernel_matches_plain(cuda, dtype, law, shape):
    tol = {torch.float64: 1e-12, torch.float32: 1e-4}[dtype]
    H, s, E, z = _sia_inputs(shape, dtype, cuda)
    kw = dict(enhancement=1.5, dx=25e3, dy=25e3,
              EC=EnthalpyConverter(), pb_law=law(EC=EnthalpyConverter()))
    for d_cap in (None, 2.0):
        n0 = K3.LAUNCHES
        got = K3.sia_flux_thermo(H, s, E, z, d_cap=d_cap, **kw)
        torch.cuda.synchronize()
        assert K3.LAUNCHES == n0 + 1
        ref = K3.sia_flux_thermo_plain(H, s, E, z, d_cap=d_cap, **kw)
        for g, r in zip(got[:4], (ref[2], ref[3], ref[0], ref[1])):
            assert _rel(g, r) <= tol


def _same_bits(a, b):
    """Equal in every bit (a NaN equal to a NaN)."""
    i = torch.int32 if a.dtype == torch.float32 else torch.int64
    return bool(((a.view(i) == b.view(i))
                 | (torch.isnan(a) & torch.isnan(b))).all())


def _level_major(E):
    """E (My, Mx, Mz) as a view of a contiguous (Mz, My, Mx) array, the
    layout the energy step leaves."""
    return E.movedim(-1, 0).contiguous().movedim(0, -1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(61, 61, 61), (30, 17, 5), (33, 33, 61)])
def test_sia_thermo_layouts_equal(cuda, dtype, shape):
    """K3 reads E through its strides: level-major and contiguous E give
    the same bits, each in one launch."""
    H, s, E, z = _sia_inputs(shape, dtype, cuda)
    Elm = _level_major(E)
    assert not Elm.is_contiguous()
    kw = dict(enhancement=1.5, dx=25e3, dy=25e3, EC=EnthalpyConverter(),
              pb_law=GPBLD(EC=EnthalpyConverter()))
    n0 = K3.LAUNCHES
    a = K3.sia_flux_thermo(H, s, E, z, **kw)
    b = K3.sia_flux_thermo(H, s, Elm, z, **kw)
    torch.cuda.synchronize()
    assert K3.LAUNCHES == n0 + 2
    for g, r in zip(a, b):
        assert _same_bits(g, r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,Mz", [(torch.float64, 1), (torch.float32, 1),
                                      (torch.float64, 2), (torch.float32, 2),
                                      (torch.float64, 5), (torch.float32, 5),
                                      (torch.float64, 61),
                                      (torch.float32, 61),
                                      (torch.float64, 401)])
def test_sia_thermo_any_Mz(cuda, dtype, Mz):
    """K3 against its plain version from one level (K = 0) to more levels
    than shared memory holds at once, level-major E."""
    tol = {torch.float64: 1e-12, torch.float32: 1e-4}[dtype]
    H, s, E, z = _sia_inputs((17, 30, Mz), dtype, cuda)
    E = _level_major(E)
    kw = dict(enhancement=1.5, dx=25e3, dy=25e3, EC=EnthalpyConverter(),
              pb_law=PatersonBudd(EC=EnthalpyConverter()))
    got = K3.sia_flux_thermo(H, s, E, z, **kw)
    ref = K3.sia_flux_thermo_plain(H, s, E, z, **kw)
    torch.cuda.synchronize()
    for g, r in zip(got[:4], (ref[2], ref[3], ref[0], ref[1])):
        assert bool(torch.isfinite(g).all())
        if Mz == 1:
            assert float(g.abs().max()) == 0.0 == float(r.abs().max())
        else:
            assert _rel(g, r) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kernel", ["K3", "K4"])
@pytest.mark.parametrize("nan", [False, True])
def test_max_D_from_the_launch(cuda, dtype, kernel, nan):
    """max_D of the kernel's own launch is torch.maximum(torch.max(De),
    torch.max(Dn)) to the bit, NaN included; its two words of work are
    back as they were."""
    if kernel == "K3":
        H, s, E, z = _sia_inputs((61, 61, 61), dtype, cuda)
        if nan:
            H[20, 30] = float("nan")
        kw = dict(enhancement=1.5, dx=25e3, dy=25e3, EC=EnthalpyConverter(),
                  pb_law=GPBLD(EC=EnthalpyConverter()))
        De, Dn, _, _, max_D = K3.sia_flux_thermo(H, s, _level_major(E), z,
                                                 **kw)
    else:
        H, s = _dome((601, 601), dtype, cuda)
        if nan:
            H[200, 300] = float("nan")
        De, Dn, _, _, max_D = K4.sia_flux(H, s, A=4e-25, enhancement=1.5,
                                          dx=3e3, dy=3e3)
    torch.cuda.synchronize()
    assert max_D.shape == () and max_D.dtype == dtype
    assert bool(torch.isnan(max_D)) == nan
    assert _same_bits(max_D, torch.maximum(torch.max(De), torch.max(Dn)))
    from pism_tpu_torch.ops.kernels import _build
    name = "sia_flux_thermo" if kernel == "K3" else "sia_flux"
    assert _build.workspace(name, H.device).tolist() == [0, -2 ** 63]


@pytest.mark.cuda
def test_eismint2_on_the_card_matches_cpu(cuda):
    """EISMINT II A at 21x21x21 in float64 for 5000 model years: the card
    (K3 under ``auto``... which needs float32, so ``sia.pallas = on``)
    against the CPU (K3's plain version): equal steps, H to 1e-10 of
    max H."""
    runs = {}
    for where in ("cpu", cuda):
        model, state, _ = setups.eismint2_model(
            "float64", Mx=21, Mz=21, device=where,
            extra_cfg={"stress_balance.sia.pallas": "on"})
        n0 = K3.LAUNCHES
        state, t, stats = model.step_once(state, 0.0, 5000.0 * SPY)
        runs[str(where)] = (state_to_numpy(state), stats, K3.LAUNCHES - n0)
    (a, sa, la), (b, sb, lb) = runs["cpu"], runs[str(cuda)]
    assert la == 0 and lb == sb.nsteps > 0
    assert sb.nsteps == sa.nsteps and sb.limit_hits_dict() == sa.limit_hits_dict()
    Ha, Hb = a["ice_thickness"], b["ice_thickness"]
    assert np.abs(Hb - Ha).max() <= 1e-10 * Ha.max()


def _dome(shape, dtype, device, seed=6):
    """A Halfar-like dome over the inner 70% of the square, an ice-free
    margin around it, and surface noise on the ice."""
    My, Mx = shape
    rng = np.random.default_rng(seed)
    Y, X = np.meshgrid(np.linspace(-1, 1, My), np.linspace(-1, 1, Mx),
                       indexing="ij")
    r = np.sqrt(X ** 2 + Y ** 2) / 0.7
    H = 3600.0 * np.maximum(1.0 - r ** (4.0 / 3.0), 0.0) ** (3.0 / 7.0)
    s = H + rng.uniform(0.0, 5.0, size=H.shape) * (H > 0)
    return [torch.tensor(x, dtype=dtype, device=device) for x in (H, s)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", [(61, 61), (601, 601), (17, 30), (303, 303),
                                   (9, 33), (33, 9), (5, 70)])
def test_sia_iso_kernel_matches_plain(cuda, dtype, shape):
    """K4 against its plain version, with and without a diffusivity cap
    that binds; one launch per call."""
    tol = {torch.float64: 1e-12, torch.float32: 2e-5}[dtype]
    H, s = _dome(shape, dtype, cuda)
    dx = 1800e3 / (shape[1] - 1)
    kw = dict(A=4e-25, enhancement=1.5, dx=dx, dy=dx)
    gam = K4.gamma(4e-25, enhancement=1.5)
    max_D = None
    for d_cap in (None, "half"):
        if d_cap == "half":
            d_cap = 0.5 * max_D
        n0 = K4.LAUNCHES
        got = K4.sia_flux(H, s, d_cap=d_cap, **kw)
        torch.cuda.synchronize()
        assert K4.LAUNCHES == n0 + 1
        ref = K4.sia_flux_plain(H, s, gamma=gam, dx=dx, dy=dx, d_cap=d_cap)
        for g, r in zip(got[:4], (ref[2], ref[3], ref[0], ref[1])):
            assert bool(torch.isfinite(g).all())
            assert _rel(g, r) <= tol
        if d_cap is None:
            max_D = float(got[4])
            assert max_D > 0.0
        else:
            assert float(got[4]) == pytest.approx(d_cap, rel=1e-6)


@pytest.mark.cuda
def test_halfar_on_the_card_matches_cpu(cuda):
    """Halfar test B at 31x31 in float64 for 300 model years with
    ``sia.pallas = on``: K4 on the card against its plain version on the
    CPU, equal steps and dt-limit hits, H to 1e-10 of max H."""
    runs = {}
    for where in ("cpu", cuda):
        model, state, _, sol = setups.halfar_model(
            "B", Mx=31, device=where,
            extra_cfg={"stress_balance.sia.pallas": "on"})
        n0 = K4.LAUNCHES
        state, t, stats = model.step_once(state, sol.t0, 300.0 * SPY)
        runs[str(where)] = (state_to_numpy(state), stats, K4.LAUNCHES - n0)
    (a, sa, la), (b, sb, lb) = runs["cpu"], runs[str(cuda)]
    assert la == 0 and lb == sb.nsteps > 0
    assert sb.nsteps == sa.nsteps and sb.limit_hits_dict() == sa.limit_hits_dict()
    Ha, Hb = a["ice_thickness"], b["ice_thickness"]
    assert np.abs(Hb - Ha).max() <= 1e-10 * Ha.max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape,mesh_shape", [((142, 76), (2, 2)),
                                              ((29, 37), (2, 4)),
                                              ((561, 301), (2, 2)),
                                              ((40, 24), (1, 8)),
                                              ((9, 33), (1, 4)),
                                              ((33, 9), (4, 1))])
def test_k5_matches_plain_and_k1(cuda, dtype, shape, mesh_shape):
    """The sharded matvec and its fused JVP (with and without a drag
    tangent) on a mesh of the one card: one K5 launch per shard, within
    K1's tolerance of the plain sharded version and equal to K1 on the
    whole field to the bit (the same device code). The last two meshes
    cut 9x9 shards, smaller than one tile of the matvec kernel on one axis
    and ragged on the other."""
    mesh = make_mesh([cuda] * (mesh_shape[0] * mesh_shape[1]), mesh_shape)
    x = _inputs(shape, dtype, cuda, 12)
    mv = (x["u"], x["v"], x["nuH_e"], x["nuH_n"], x["beta"])
    n0 = K.HALO_LAUNCHES
    got = S.ssa_matvec_sharded(*mv, mesh, DX, DY)
    torch.cuda.synchronize()
    assert K.HALO_LAUNCHES == n0 + mesh.size
    for g, r, k1 in zip(got, S.ssa_matvec_sharded_plain(*mv, mesh, DX, DY),
                        K.ssa_matvec(*mv, DX, DY)):
        assert _rel(g, r) < TOL[dtype]
        assert torch.equal(g, k1)
    for dbeta in (None, x["dbeta"]):
        jv = (x["u"], x["v"], x["du"], x["dv"], x["nuH_e"], x["nuH_n"],
              x["dnuH_e"], x["dnuH_n"], x["beta"], dbeta)
        n0 = K.HALO_JVP_LAUNCHES
        got = S.ssa_matvec_sharded_jvp(*jv, mesh, DX, DY)
        torch.cuda.synchronize()
        assert K.HALO_JVP_LAUNCHES == n0 + mesh.size
        for g, r, k1 in zip(got,
                            S.ssa_matvec_sharded_jvp_plain(*jv, mesh, DX, DY),
                            K.ssa_matvec_jvp(*jv, DX, DY)):
            assert _rel(g, r) < TOL[dtype]
            assert torch.equal(g, k1)


@pytest.mark.cuda
def test_k5_function_jvp_on_the_card(cuda):
    """torch.func.jvp through ``SSAMatvecSharded`` (the fused K5 JVP) against
    torch.func.jvp of the plain whole-field operator."""
    mesh = make_mesh([cuda] * 4, (2, 2))
    x = _inputs((24, 40), torch.float64, cuda, 13)
    args = (x["u"], x["v"], x["nuH_e"], x["nuH_n"], x["beta"])
    tangents = (x["du"], x["dv"], x["dnuH_e"], x["dnuH_n"], x["dbeta"])
    _, jf = torch.func.jvp(
        lambda *a: S.SSAMatvecSharded.apply(*a, mesh, DX, DY), args, tangents)
    _, jp = torch.func.jvp(lambda *a: K.ssa_matvec_plain(*a, DX, DY),
                           args, tangents)
    for g, r in zip(jf, jp):
        assert _rel(g, r) < 1e-12


@pytest.mark.cuda
def test_k5_across_cards(cuda):
    """A 1x2 mesh of two distinct cards: the halo strips travel between
    them and the result lands on the input's card, equal to K1's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    mesh = make_mesh(["cuda:0", "cuda:1"], (1, 2))
    x = _inputs((60, 40), torch.float64, torch.device("cuda:0"), 14)
    mv = (x["u"], x["v"], x["nuH_e"], x["nuH_n"], x["beta"])
    got = S.ssa_matvec_sharded(*mv, mesh, DX, DY)
    for g, k1 in zip(got, K.ssa_matvec(*mv, DX, DY)):
        assert g.device == torch.device("cuda:0")
        assert torch.equal(g, k1)


@pytest.mark.cuda
def test_meshed_chains_across_cards(cuda):
    """A mesh of every card (``make_mesh()``): Halfar test B at 61x61 in
    float64 (K4 per shard, ``sia.pallas = on``) for 300 model years and
    the 100 km hybrid chain in float64 (K5 per shard) for one model year,
    against the unmeshed runs on the first card: equal steps and H to the
    bit."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    mesh = make_mesh()
    dev = torch.device("cuda:0")
    on = {"stress_balance.sia.pallas": "on"}
    runs = []
    for m in (None, mesh):
        model, state, _, sol = setups.halfar_model("B", 61, device=dev,
                                                   extra_cfg=on, mesh=m)
        runs.append(model.step_once(state, sol.t0, 300.0 * SPY))
    model, state, grid = setups.hybrid_greenland_model("float64", 100.0,
                                                       device=dev, mesh=mesh)
    ref = IceModel(grid=grid, config=model.config, surface=model.surface,
                   ocean=model.ocean, device=dev)
    runs += [m.step_once(state, 0.0, SPY) for m in (ref, model)]
    for (a, _, sa), (b, _, sb) in (runs[:2], runs[2:]):
        assert sb.nsteps == sa.nsteps > 0
        assert b.geometry.ice_thickness.device == dev
        assert torch.equal(a.geometry.ice_thickness, b.geometry.ice_thickness)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mesh_shape", [(2, 2), (2, 4)])
def test_k6_equals_unsharded(cuda, dtype, mesh_shape):
    """K3 and K4 per shard on one-ghost blocks (61 pads to the mesh)
    against the unsharded kernels: equal to the bit, one launch per
    shard."""
    mesh = make_mesh([cuda] * (mesh_shape[0] * mesh_shape[1]), mesh_shape)
    H, s, E, z = _sia_inputs((61, 61, 13), dtype, cuda)
    kw = dict(enhancement=1.5, dx=25e3, dy=25e3, EC=EnthalpyConverter(),
              pb_law=PatersonBudd(EC=EnthalpyConverter()), d_cap=None)
    n0 = K3.LAUNCHES
    got = S.sia_flux_thermo_sharded(H, s, E, z, mesh, **kw)
    torch.cuda.synchronize()
    assert K3.LAUNCHES == n0 + mesh.size
    for g, r in zip(got, K3.sia_flux_thermo(H, s, E, z, **kw)):
        assert torch.equal(g, r)
    H, s = _dome((61, 61), dtype, cuda)
    kw = dict(A=4e-25, enhancement=1.5, dx=30e3, dy=30e3, d_cap=None)
    n0 = K4.LAUNCHES
    got = S.sia_flux_sharded(H, s, mesh, **kw)
    torch.cuda.synchronize()
    assert K4.LAUNCHES == n0 + mesh.size
    for g, r in zip(got, K4.sia_flux(H, s, **kw)):
        assert torch.equal(g, r)


@pytest.mark.cuda
def test_cli_runs_on_the_card_with_classic_files(cuda, tmp_path):
    """``pism_tpu_torch.cli.main`` without ``-platform``: the run, its
    series and its state file on the card in netcdf3; the state reads back
    on the card to the bit, and equals the same command line with
    ``-platform cpu`` (Halfar B, float64) within 1e-10 of max H."""
    from pism_tpu_torch import cli
    from pism_tpu_torch.io import checkpoint as ckpt
    from pism_tpu_torch.io.nc4 import File

    states = {}
    for plat in ("cuda", "cpu"):
        d = tmp_path / plat
        d.mkdir()
        argv = ["-test", "B", "-Mx", "31", "-y", "100", "-o", str(d / "b.nc"),
                "-o_format", "netcdf3", "-verbose", "0",
                "-ts_file", str(d / "ts.nc"), "-ts_times", "430:10:520",
                "-extra_file", str(d / "ex.nc"), "-extra_times", "450:50:500"]
        if plat == "cpu":
            argv += ["-platform", "cpu"]
        assert cli.main(argv) == 0
        for name in ("b.nc", "ts.nc", "ex.nc"):
            with open(d / name, "rb") as fh:
                assert fh.read(3) == b"CDF"
        states[plat], _ = ckpt.load_state(str(d / "b.nc"), device=plat)
    Hg = states["cuda"].geometry.ice_thickness
    assert Hg.device.type == "cuda"
    Hc = states["cpu"].geometry.ice_thickness
    assert float((Hg.cpu() - Hc).abs().max()) <= 1e-10 * float(Hc.max())
    with File(str(tmp_path / "cuda" / "ex.nc"), "r") as f:
        assert f.read("thk").shape[0] == 2


@pytest.mark.cuda
def test_cli_eismint_k3_restart_on_the_card(cuda, tmp_path):
    """EISMINT II A 21x21x11 float32 on K3 through the CLI, then B from its
    file: the launches happen and the continuation starts from the saved
    state to the bit."""
    from pism_tpu_torch import cli
    from pism_tpu_torch.io import checkpoint as ckpt

    a, b = str(tmp_path / "a.nc"), str(tmp_path / "b.nc")
    cfg = ["-config", "runtime.float_dtype=float32",
           "-config", "stress_balance.sia.bed_smoother.range=0"]
    K3.LAUNCHES = 0
    assert cli.main(["-eisII", "A", "-Mx", "21", "-Mz", "11", "-y", "200",
                     "-o", a, "-o_format", "netcdf3", "-verbose", "0"]
                    + cfg) == 0
    assert K3.LAUNCHES > 0
    s, t = ckpt.load_state(a)
    assert s.enthalpy.dtype == torch.float32 and s.enthalpy.is_cuda
    assert cli.main(["-eisII", "B", "-i", a, "-y", "50", "-o", b,
                     "-o_format", "netcdf3", "-verbose", "0"] + cfg) == 0
    s2, t2 = ckpt.load_state(b)
    assert t2 == pytest.approx(t + 50 * SPY, rel=1e-12)
    assert bool(torch.isfinite(s2.geometry.ice_thickness).all())


def _with_climatic_mass_balance(src, dst):
    """A classic copy of the data file ``src`` with a climatic_mass_balance
    field (its precipitation less 300 kg m-2 year-1), so that the smb
    heuristic takes the Robin profile."""
    from pism_tpu_torch.io.nc4 import File

    with File(src, "r") as f:
        x, y = f.read("x"), f.read("y")
        fields = {n: (f.read(n), f.read_attrs(n)) for n in f.variables()}
        proj = f.get_global_attr("proj")
    with File(dst, "w", format="netcdf3") as f:
        f.define_dimension("y", len(y), y, attrs={"units": "m"})
        f.define_dimension("x", len(x), x, attrs={"units": "m"})
        for name, (a, attrs) in fields.items():
            f.write(name, a, ("y", "x"), attrs)
        f.write("climatic_mass_balance", fields["precipitation"][0] - 300.0,
                ("y", "x"), {"units": "kg m-2 year-1"})
        f.set_global_attr("proj", proj)


@pytest.mark.cuda
@pytest.mark.parametrize("profile", ["conduction", "robin"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_bootstrap_on_the_card_equals_the_cpu(cuda, tmp_path, dtype,
                                              profile):
    """``io.bootstrap.bootstrap`` of the synthetic std-greenland file onto
    the 20 km grid: the regridded fields on the card equal the CPU's to the
    bit (host float64 regridding, then a cast); the enthalpy, computed on
    each device, within 1e-12 (float64) or 1e-6 (float32) of its max. With
    a climatic_mass_balance in the file (``robin``) the smb heuristic's erf
    chain makes E: float32 within 4 ulps of T at 273.15 K times c_i, as
    ``chip_smoke.py`` phase 8 holds it (CUDA's erff and the CPU's differ by
    up to 3 ulps of erf)."""
    from pism_tpu_torch import Config, Grid
    from pism_tpu_torch.examples.std_greenland_workflow import (
        SEARISE_PROJ, synthesize_bootstrap_file)
    from pism_tpu_torch.io.bootstrap import bootstrap

    path = str(tmp_path / "boot.nc")
    synthesize_bootstrap_file(path, 20.0, "netcdf3", SEARISE_PROJ)
    if profile == "robin":
        path, src = str(tmp_path / "boot_cmb.nc"), path
        _with_climatic_mass_balance(src, path)
    grid = Grid(Mx=76, My=141, Mz=41, Lx=750e3, Ly=1400e3, Lz=4000.0)
    cfg = Config({"runtime.float_dtype": dtype})
    g, c = (state_to_numpy(bootstrap(path, grid, cfg, device=d))
            for d in (cuda, "cpu"))
    assert sorted(g) == sorted(c)
    for name in ("ice_thickness", "bed_elevation", "basal_melt_rate",
                 "cell_type", "ice_surface_elevation"):
        np.testing.assert_array_equal(g[name], c[name], err_msg=name)
    E, Ec = g["enthalpy"], c["enthalpy"]
    if dtype == "float64":
        assert np.abs(E - Ec).max() <= 1e-12 * np.abs(Ec).max()
    elif profile == "robin":
        c_i = cfg.get_number("constants.ice.specific_heat_capacity")
        assert np.abs(E - Ec).max() <= 4 * 2.0 ** -15 * c_i
    else:
        assert np.abs(E - Ec).max() <= 1e-6 * np.abs(Ec).max()


# -- the PISM-PIK Antarctic chain ------------------------------------------

def _pik_state(km):
    """The PIK chain's initial float64 state on the CPU."""
    return setups.antarctica_pik_model("float64", km=km, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("basins", [False, True])
def test_pico_on_the_card_equals_the_cpu(cuda, basins):
    """PICO at 16 km (251 x 251) on the card and on the CPU from the same
    float64 geometry: box index, d_gl and d_if equal; melt, temperatures,
    salinity and overturning within 1e-12 of their max without basins, and
    within 1e-10 with them: the per-basin sums over 63,001 cells reduce in
    another order on the card, and the box cascade amplifies that (melt
    2.5e-12 of its max on an H100)."""
    from pism_tpu_torch.coupler.pico import Pico
    from pism_tpu_torch.state import map_tensors

    model, state, grid = _pik_state(16.0)
    X = np.meshgrid(grid.x, grid.y)[0]
    b = torch.tensor(np.where(X < 0, 1, 2)) if basins else None
    out = {}
    for dev in ("cpu", cuda):
        p = Pico(temperature_ocean=torch.full(grid.shape2, 271.45,
                                              dtype=torch.float64, device=dev),
                 salinity_ocean=torch.full(grid.shape2, 34.65,
                                           dtype=torch.float64, device=dev),
                 config=model.config, grid=grid,
                 basin_mask=None if b is None else b.to(dev))
        g = map_tensors(state, lambda x: x.to(dev)).geometry
        out[str(dev)] = {k: v.cpu() for k, v in p.solve(g, 0.0)._asdict()
                         .items()}
    a, c = out["cpu"], out[str(cuda)]
    for name in ("box", "d_gl", "d_if", "contshelf"):
        assert torch.equal(a[name], c[name]), name
    tol = 1e-10 if basins else 1e-12
    for name in ("melt", "T_basal", "temperature", "salinity", "overturning"):
        scale = a[name].abs().max().clamp_min(1e-300)
        assert float((a[name] - c[name]).abs().max() / scale) <= tol, name


@pytest.mark.cuda
@pytest.mark.parametrize("elastic", [False, True])
def test_lingle_clark_on_the_card_equals_the_cpu(cuda, elastic):
    """One Lingle-Clark solve at 16 km (cuFFT against pocketFFT) from the
    same float64 state with an added load: the bed and the viscous
    displacement within 1e-12 of their max."""
    from pism_tpu_torch.config import Config
    from pism_tpu_torch.model.beddef import LingleClark
    from pism_tpu_torch.state import map_tensors

    model, state, grid = _pik_state(16.0)
    H = state.geometry.ice_thickness * 1.1
    state = state.replace(geometry=state.geometry.replace(ice_thickness=H))
    cfg = Config({"bed_deformation.lc.elastic_model": elastic})
    out = []
    for dev in ("cpu", cuda):
        lc = LingleClark(grid=grid, config=cfg)
        s = lc.step(map_tensors(state, lambda x: x.to(dev)), 3.0 * SPY,
                    t=10.0 * SPY)
        out.append((s.geometry.bed_elevation.cpu(), s.bed_uplift.cpu()))
    for a, c in zip(*out):
        assert float((a - c).abs().max() / a.abs().max()) <= 1e-12
    assert float(out[0][1].abs().max()) > 0.0


@pytest.mark.cuda
def test_pik_chain_step_on_the_card(cuda):
    """One step of the 16 km chain (251 x 251 x 31, float32, path A) on the
    card: finite fields, a shelf, PICO melt under it, K1, the Newton matvec
    and K2/K2b launched."""
    from pism_tpu_torch.state import floating_ice

    model, state, grid = setups.antarctica_pik_model(
        "float32", km=16.0, device=cuda,
        extra_cfg={"stress_balance.ssa.fd.line_pcr_impl": "pallas_sublane"})
    n0 = (K.LAUNCHES, K.NEWTON_LAUNCHES, K2.SUB_LAUNCHES, K2.LAUNCHES)
    state, t, stats = model.step_once(state, 0.0, 0.5 * SPY)
    torch.cuda.synchronize()
    assert stats.nsteps >= 1
    for f in (state.geometry.ice_thickness, state.enthalpy, state.u_ssa):
        assert bool(torch.isfinite(f).all())
    floating = floating_ice(state.geometry.cell_type)
    assert bool(floating.any())
    melt = model.ocean(state.geometry, t)
    assert float(melt[floating].max()) > 0.0
    n1 = (K.LAUNCHES, K.NEWTON_LAUNCHES, K2.SUB_LAUNCHES, K2.LAUNCHES)
    assert all(b > a for a, b in zip(n0, n1))
