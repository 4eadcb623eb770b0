"""Card-only tests of pism_tpu_torch: the CUDA kernels (SSA matvec, the
Newton matvec, PCR line solves, fused thermomechanical and isothermal SIA)
against their plain torch versions, the 100 km chain on the card against
the CPU, and EISMINT II A and Halfar test B through the SIA kernels against
the CPU, their max of D from the launch against the faces' max; K5 (the
matvec per shard of a mesh of the card) against its plain version and
against K1 on the whole field, the Newton matvec per shard against the
unsharded one, and K3/K4 per shard against the unsharded kernels, equal to
the bit; PICO and Lingle-Clark on the card against the CPU, and one step of
the 16 km PIK chain; the SSA operator and Newton matvec on periodic grids
(the padded-block kernels on the wrap-padded field) against the plain
periodic stencils, and MISMIP3d and MISMIP experiment 1 on the card
against the CPU; the Newton matvec's drag tangent against its plain
version, the multigrid preconditioner and the SSA verification tests
against the CPU; ISMIP-HOM A (the Blatter solve replayed as CUDA graphs,
and without them), SSAFEM's test I and the composite Blatter model on a
dome against the CPU; the VJP kernels (the reverse mode of K1 and of its
padded-block instance) against their plain versions, with the adjoint
identity, and reverse mode through ``SSAMatvec`` on the card; the
Greenland dEBM chain on the card against the CPU.

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
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape,periodic", [
    ((141, 76), None), ((561, 301), None), ((9, 33), None), ((33, 9), None),
    ((2, 70), None), ((7, 151), (True, False)), ((101, 1601), (True, False))])
def test_vjp_kernels_match_plain(cuda, dtype, shape, periodic):
    """The VJP kernels (the reverse mode of K1 and of its padded-block
    instance) against the plain VJPs on the same inputs, every output and
    each design's subset; the adjoint identity <g, A w> = <A^T g, w> in
    float64; no plain VJP call from the wrappers on the card."""
    from pism_tpu_torch.ops.stencils import pad_ghosts
    x = _inputs(shape, dtype, cuda, 12)
    g = _inputs(shape, dtype, cuda, 13)
    gu, gv = g["du"] * 1e5, g["dv"] * 1e5
    if periodic is None:
        args = (x["u"], x["v"], x["nuH_e"], x["nuH_n"], x["beta"])
        kern, plain, launches = K.ssa_matvec_vjp, K.ssa_matvec_vjp_plain, \
            "VJP_LAUNCHES"
    else:
        py, px = periodic
        args = (not px, not py, pad_ghosts(x["u"], 2, py, px),
                pad_ghosts(x["v"], 2, py, px),
                pad_ghosts(x["nuH_e"], 1, py, px),
                pad_ghosts(x["nuH_n"], 1, py, px), x["beta"])
        kern, plain, launches = K.ssa_matvec_halo_vjp, \
            K.ssa_matvec_halo_vjp_plain, "HALO_VJP_LAUNCHES"
    ref = plain(*args, gu, gv, DX, DY)
    for need in ((True, True, True), (False, False, True),
                 (False, True, False)):
        n0, p0 = getattr(K, launches), K.PLAIN_VJP_CALLS
        got = kern(*args, gu, gv, DX, DY, need)
        torch.cuda.synchronize()
        assert getattr(K, launches) == n0 + 1 and K.PLAIN_VJP_CALLS == p0
        for a, b, w in zip(got, ref, (need[0], need[0], need[1], need[1],
                                      need[2])):
            assert (a is None) == (not w)
            if w:
                assert _rel(a, b) < TOL[dtype]
    if dtype == torch.float64:
        w_u, w_v = x["du"], x["dv"]
        if periodic is None:
            Au, Av = K.ssa_matvec(w_u, w_v, *args[2:], DX, DY)
            ub, vb = kern(*args, gu, gv, DX, DY, (True, False, False))[:2]
        else:
            Au, Av = ssa_ops.ssa_matvec_periodic(
                w_u, w_v, x["nuH_e"], x["nuH_n"], x["beta"], DX, DY, periodic)
            wu = w_u.clone().requires_grad_()
            wv = w_v.clone().requires_grad_()
            out = ssa_ops.apply_operator(wu, wv, ssa_ops.NuH(
                x["nuH_e"], x["nuH_n"]), x["beta"], DX, DY, periodic)
            ub, vb = torch.autograd.grad(out, (wu, wv), (gu, gv))
        lhs = float(torch.sum(gu * Au) + torch.sum(gv * Av))
        rhs = float(torch.sum(ub * w_u) + torch.sum(vb * w_v))
        assert abs(lhs - rhs) <= 1e-12 * abs(lhs)


@pytest.mark.cuda
def test_function_vjp_on_the_card(cuda):
    """Reverse mode through ``SSAMatvec`` on the card launches the VJP
    kernel and agrees with autograd of the plain version."""
    x = _inputs((24, 40), torch.float64, cuda, 14)
    names = ("u", "v", "nuH_e", "nuH_n", "beta")
    a = [x[k].clone().requires_grad_() for k in names]
    b = [x[k].clone().requires_grad_() for k in names]
    gu, gv = x["du"], x["dv"]
    n0, p0 = K.VJP_LAUNCHES, K.PLAIN_VJP_CALLS
    ga = torch.autograd.grad(K.SSAMatvec.apply(*a, DX, DY), a, (gu, gv))
    gb = torch.autograd.grad(K.ssa_matvec_plain(*b, DX, DY), b, (gu, gv))
    assert K.VJP_LAUNCHES == n0 + 1 and K.PLAIN_VJP_CALLS == p0
    for p, q in zip(ga, gb):
        assert _rel(p, q) < 1e-12


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
@pytest.mark.parametrize("shape,periodic", [((24, 40), None),
                                            ((141, 76), None),
                                            ((61, 11), (False, True)),
                                            ((5, 221), (True, False))])
def test_newton_matvec_drag_tangent(cuda, dtype, shape, periodic):
    """The Newton matvec with the drag tangent of the exact drag Jacobian,
    whole field or through the periodic route (the padded-block instance):
    one launch counted apart from the frozen-beta ones, within K1's
    tolerance of its plain version (on the CPU too), and with a zero plane
    equal to the launch without one to the bit."""
    x = _newton_inputs(shape, dtype, cuda, 17)
    rng = np.random.default_rng(18)
    drag = torch.tensor(-rng.uniform(1e19, 1e21, size=shape), dtype=dtype,
                        device=cuda)
    args = [x[k] for k in NEWTON_ARGS]
    if periodic is None:
        counter = "NEWTON_DRAG_LAUNCHES"

        def run(a, c):
            return K.ssa_newton_matvec(*a, DX, DY, c)

        def plain(a, c):
            return K.ssa_newton_matvec_plain(*a, DX, DY, c)
    else:
        counter = "HALO_NEWTON_DRAG_LAUNCHES"

        def run(a, c):
            return ssa_ops.ssa_newton_matvec_periodic(
                *a[:2], *a[4:], DX, DY, periodic, c)(*a[2:4])

        def plain(a, c):
            pad = lambda t, g: ssa_ops.st.pad_ghosts(t, g, *periodic)  # noqa
            return K.ssa_newton_matvec_halo_plain(
                not periodic[1], not periodic[0],
                *(pad(t, g) for t, g in zip(a[:8], (2, 2, 2, 2, 1, 1, 1, 1))),
                a[8], pad(a[9], 2), DX, DY, c)
    n0 = getattr(K, counter)
    got = run(args, drag)
    torch.cuda.synchronize()
    assert getattr(K, counter) == n0 + 1
    cpu_args = [a.cpu() for a in args]
    for g, r, c in zip(got, plain(args, drag), plain(cpu_args, drag.cpu())):
        assert _rel(g, r) < TOL[dtype]
        assert _rel(g.cpu(), c) < TOL[dtype]
    for a, b in zip(run(args, torch.zeros_like(drag)), run(args, None)):
        assert torch.equal(a, b)


SCALINGS = 4


def _cpu_envelope(fn, size):
    """The CPU runs of an SSA verification test with its thickness scaled
    by 1 + k 1e-15, k = 0 .. SCALINGS-1: (the unscaled run's result, [(Newton
    sweeps, Krylov total)] of each), the rounding envelope of the solve's
    counts."""
    from pism_tpu_torch.verification import ssa_tests
    solve, out, first = ssa_tests._solve, [], None
    for k in range(SCALINGS):
        def scaled(grid, cfg, B, H, *a, k=k, **kw):
            return solve(grid, cfg, B, np.asarray(H) * (1.0 + k * 1e-15),
                         *a, **kw)
        ssa_tests._solve = scaled
        try:
            res = fn(*size, device="cpu")
        finally:
            ssa_tests._solve = solve
        first = first or res
        out.append((int(res.info["newton_iters"]),
                     int(res.info["krylov_iters"])))
    return first, out


@pytest.mark.cuda
@pytest.mark.parametrize("letter,size", [("I", (11, 31)), ("V", (51, 5)),
                                         ("N", (111, 5)), ("M", (41, None))])
def test_ssa_verification_on_the_card_matches_cpu(cuda, letter, size):
    """Tests I, V, N and M at small sizes, float64, on the card (through
    the kernels) and on the CPU: velocities within 1e-5 of max|u|, and the
    card's Newton sweeps one that the CPU run takes with its thickness
    scaled by 1 + k 1e-15, k = 0..3, and its Krylov total within 10% of
    the CPU's range under those scalings. Test I at 11x31 takes 6 sweeps
    on the CPU unscaled and 7 with the scaling k = 2: the count is
    rounding, which the card's sums round otherwise."""
    from pism_tpu_torch.verification import ssa_tests
    fn = getattr(ssa_tests, f"ssa_test_{letter}")
    a, env = _cpu_envelope(fn, size)
    n0 = (K.LAUNCHES, K.HALO_LAUNCHES)
    b = fn(*size, device=cuda)
    assert (K.LAUNCHES, K.HALO_LAUNCHES) != n0
    assert int(b.info["newton_iters"]) in {s for s, _ in env}, env
    kry = [k for _, k in env]
    assert 0.9 * min(kry) <= int(b.info["krylov_iters"]) <= 1.1 * max(kry), \
        (int(b.info["krylov_iters"]), env)
    scale = float(max(a.u.abs().max(), a.v.abs().max()))
    assert float((b.u.cpu() - a.u).abs().max()) <= 1e-5 * scale
    assert float((b.v.cpu() - a.v).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
def test_ssa_verification_J_on_the_card_matches_cpu(cuda):
    """Test J at 17 and 33 points, float64, on the card and on the CPU:
    equal Newton sweeps, the errors within 1e-5 relative."""
    from pism_tpu_torch.verification import ssa_tests
    a = ssa_tests.ssa_test_J(17, device="cpu")
    n0 = (K.LAUNCHES, K.HALO_LAUNCHES)
    b = ssa_tests.ssa_test_J(17, device=cuda)
    assert K.LAUNCHES > n0[0] and K.HALO_LAUNCHES > n0[1]
    assert [i["newton_iters"] for i in a.info] == \
        [i["newton_iters"] for i in b.info]
    for k in ("max", "max2"):
        assert b.errors[k] == pytest.approx(a.errors[k], rel=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("periodicity", ["none", "xy"])
def test_mg_preconditioner_on_the_card(cuda, periodicity):
    """The multigrid V-cycle on the card (K1 on the coarse levels, the
    periodic route on a periodic fine level) against the CPU's plain
    operators, float64, to 1e-12."""
    from pism_tpu_torch.grid import Grid
    from pism_tpu_torch.ops import mg
    n = 61
    g = Grid(Mx=n, My=n, Lx=400e3, Ly=400e3, periodicity=periodicity)
    rng = np.random.default_rng(19)
    f = lambda a, d: torch.tensor(a, dtype=torch.float64, device=d)  # noqa
    nuH = [rng.uniform(1e14, 1e16, (n, n)) for _ in range(2)]
    beta = rng.uniform(0.0, 1e9, (n, n))
    bc = np.zeros((n, n), bool)
    bc[0, :] = periodicity == "none"
    r = [rng.normal(size=(n, n)) for _ in range(2)]
    out = {}
    for d in ("cpu", cuda):
        n0 = (K.LAUNCHES, K.HALO_LAUNCHES)
        p = mg.make_preconditioner(ssa_ops.NuH(f(nuH[0], d), f(nuH[1], d)),
                                   f(beta, d), torch.tensor(bc, device=d),
                                   g.dx, g.dy, (g.periodic_y, g.periodic_x))
        out[str(d)] = p((f(r[0], d), f(r[1], d)))
    assert K.LAUNCHES > n0[0]
    assert (K.HALO_LAUNCHES > n0[1]) == (periodicity == "xy")
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert _rel(b.cpu(), a) < 1e-12


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
                                     (1601, 101), (101, 1601),
                                     (3000, 4), (4096, 3), (4800, 2)])
def test_pcr_kernels_match_plain(cuda, dtype, n, batch):
    """Both layouts at the chain's line shapes and MISMIP3d's at 1 km
    (1601 x 101), at n = 1 and n not a power of two, and on lines longer
    than a block's threads: the one-shot form, the factor alone (b given,
    and the unit diagonal implicit) and the apply alone (with and without
    a scale) round as the plain versions do, so all are equal to the bit.
    A block is one line, so no batch leaves a ragged last block; 1601,
    3000 and 4096 slots take four per thread (4096 a whole block of 1024
    threads), 4800 take 32."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("periodicity", ["x", "y", "xy"])
@pytest.mark.parametrize("shape", [(7, 151), (101, 1601), (9, 33), (33, 9)])
def test_periodic_route_matches_plain(cuda, dtype, periodicity, shape):
    """The SSA operator and the Newton matvec on a periodic grid: one launch
    of the padded-block kernels on the wrap-padded field against the plain
    periodic stencils on the card (K1's tolerances), and against the
    route's plain version on the CPU."""
    from pism_tpu_torch.grid import Grid
    from pism_tpu_torch.ops.stencils import Shifter

    grid = Grid(Mx=shape[1], My=shape[0], Lx=1e5, Ly=1e5,
                periodicity=periodicity)
    sh, periodic = Shifter(grid), (grid.periodic_y, grid.periodic_x)
    a = _inputs(shape, dtype, cuda, 21)
    rng = np.random.default_rng(22)
    B = torch.tensor(rng.uniform(1e8, 3e8, size=shape), dtype=dtype,
                     device=cuda)
    H = torch.tensor(rng.uniform(10.0, 2000.0, size=shape), dtype=dtype,
                     device=cuda)
    bc = torch.tensor(rng.random(shape) < 0.2, device=cuda)
    nuH = ssa_ops.NuH(a["nuH_e"], a["nuH_n"])
    n0 = (K.HALO_LAUNCHES, K.HALO_NEWTON_LAUNCHES)
    got = ssa_ops.apply_operator(a["u"], a["v"], nuH, a["beta"], DX, DY,
                                 periodic)
    ref = ssa_ops.apply_operator_stencil(a["u"], a["v"], nuH, a["beta"], DX,
                                         DY, sh)
    cpu = ssa_ops.apply_operator(*(x.cpu() for x in (a["u"], a["v"])),
                                 ssa_ops.NuH(*(x.cpu() for x in nuH)),
                                 a["beta"].cpu(), DX, DY, periodic)
    for g, r, c in zip(got, ref, cpu):
        assert _rel(g, r) < TOL[dtype] and _rel(g.cpu(), c) < TOL[dtype]
    lin, tangent = ssa_ops.linearize_nuH(a["u"], a["v"], B, H, DX, DY, sh)
    coefs = tuple(torch.stack(c, -1) for c in (tangent.e, tangent.n))
    mv = ssa_ops.ssa_newton_matvec_periodic(a["u"], a["v"], lin.e, lin.n,
                                            *coefs, a["beta"], bc, DX, DY,
                                            periodic)
    got = mv(a["du"], a["dv"])
    ref = ssa_ops.newton_matvec_stencil(a["u"], a["v"], a["du"], a["dv"], lin,
                                        tangent, a["beta"], bc, DX, DY, sh)
    for g, r in zip(got, ref):
        assert _rel(g, r) < TOL[dtype]
    assert (K.HALO_LAUNCHES, K.HALO_NEWTON_LAUNCHES) == (n0[0] + 1, n0[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["mismip3d", "mismip1"])
def test_mismip_on_the_card_matches_cpu(cuda, which):
    """MISMIP3d at 50 km and MISMIP experiment 1 at 51 x 5 (periodic y),
    float64, 20 a on the card and on the CPU: equal steps and dt-limit
    hits, the volume within 1e-10; the periodic run through the
    padded-block kernels only."""
    runs = {}
    for where in ("cpu", cuda):
        if which == "mismip3d":
            model, state, grid = setups.mismip3d_model("float64", km=50.0,
                                                       device=where)
        else:
            model, state, grid = setups.mismip_model("float64", 51, 5,
                                                     device=where)
        n0 = (K.LAUNCHES, K.HALO_LAUNCHES, K.HALO_NEWTON_LAUNCHES)
        state, t, stats = model.step_once(state, 0.0, 20.0 * SPY)
        n1 = (K.LAUNCHES, K.HALO_LAUNCHES, K.HALO_NEWTON_LAUNCHES)
        runs[str(where)] = (state_to_numpy(state), stats, n0, n1)
    (a, sa, _, _), (b, sb, n0, n1) = runs["cpu"], runs[str(cuda)]
    assert sb.nsteps == sa.nsteps and sb.limit_hits_dict() == sa.limit_hits_dict()
    V = a["ice_thickness"].sum()
    assert abs(b["ice_thickness"].sum() - V) <= 1e-10 * V
    assert np.all(np.isfinite(b["u_ssa"]))
    if which == "mismip1":
        assert n1[0] == n0[0] and n1[1] > n0[1] and n1[2] > n0[2]


# -- the SIA kernels on an ensemble's member axis ---------------------------

def _members(kernel, B, dtype, device, level_major=True):
    """B members of different domes (and enthalpies): (args of the
    wrapper, its keywords)."""
    if kernel == "K3":
        xs = [_sia_inputs((41, 41, 21), dtype, device, seed=20 + b)
              for b in range(B)]
        H = torch.stack([x[0] * (0.8 + 0.1 * b) for b, x in enumerate(xs)])
        s = torch.stack([x[1] for x in xs]) + H - torch.stack(
            [x[0] for x in xs])
        E = torch.stack([x[2] for x in xs])
        if level_major:   # per member level-major, as the energy step leaves
            E = E.movedim(-1, 0).contiguous().movedim(0, -1)
        kw = dict(enhancement=1.5, dx=40e3, dy=40e3, EC=EnthalpyConverter(),
                  pb_law=GPBLD(EC=EnthalpyConverter()))
        return (H, s, E, xs[0][3]), kw
    xs = [_dome((61, 47), dtype, device, seed=30 + b) for b in range(B)]
    H = torch.stack([x[0] * (0.8 + 0.1 * b) for b, x in enumerate(xs)])
    s = torch.stack([x[1] for x in xs]) + H - torch.stack([x[0] for x in xs])
    return (H, s), dict(A=4e-25, enhancement=1.5, dx=3e3, dy=3e3)


def _wrapper(kernel):
    return K3.sia_flux_thermo if kernel == "K3" else K4.sia_flux


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kernel", ["K3", "K4"])
@pytest.mark.parametrize("B", [2, 7, 100])
def test_member_launch_equals_single_launches(cuda, kernel, dtype, B):
    """One launch for B members: each member's outputs equal to the bit
    those of a launch of it alone, and the (B,) max(D) each member's faces'
    max; the wrapper counts one launch, with a member axis."""
    args, kw = _members(kernel, B, dtype, cuda)
    mod = K3 if kernel == "K3" else K4
    n0, m0 = mod.LAUNCHES, mod.MEMBER_LAUNCHES
    got = _wrapper(kernel)(*args, **kw)
    assert (mod.LAUNCHES - n0, mod.MEMBER_LAUNCHES - m0) == (1, 1)
    assert got[4].shape == (B,)
    for b in range(B):
        one = _wrapper(kernel)(*(a[b] if a.dim() > 1 else a for a in args),
                               **kw)
        for g, o in zip(got, one):
            assert _same_bits(g[b], o)
        assert _same_bits(got[4][b], torch.maximum(torch.max(got[0][b]),
                                                   torch.max(got[1][b])))
    torch.cuda.synchronize()
    from pism_tpu_torch.ops.kernels import _build
    name = "sia_flux_thermo" if kernel == "K3" else "sia_flux"
    assert _build.workspace(name, cuda, B).tolist() == [0] + [-2 ** 63] * B


def _todays_launch(kernel, args, kw):
    """The single-field C entry point (``pism_sia_flux_thermo_<prec>``,
    ``pism_sia_flux_<prec>``), which takes no member axis: (qe, qn, De, Dn,
    max_D)."""
    import ctypes
    from pism_tpu_torch.ops.kernels import _build
    H = args[0]
    prec = "f32" if H.dtype == torch.float32 else "f64"
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    out = [torch.empty_like(H) for _ in range(4)]
    max_D = torch.empty((), dtype=H.dtype, device=H.device)
    name = "sia_flux_thermo" if kernel == "K3" else "sia_flux"
    work = _build.workspace(name, H.device).data_ptr()
    if kernel == "K3":
        lib = _build.library("sia_thermo")
        fn = getattr(lib, f"pism_sia_flux_thermo_{prec}")
        fn.argtypes = [p] * 10 + [i, i, i, ll, ll, ll,
                                  ctypes.POINTER(ctypes.c_double), p]
        c = K3._constants(3.0, kw["enhancement"], 910.0, 9.81, kw["dx"],
                          kw["dy"], kw["EC"], kw["pb_law"], None)
        H, s, E, z = args
        _build.launch(fn, name, H.device, H.data_ptr(), s.data_ptr(),
                      E.data_ptr(), z.data_ptr(), *(o.data_ptr() for o in out),
                      work, max_D.data_ptr(), *H.shape, E.shape[2],
                      *E.stride(), (ctypes.c_double * len(c))(*c))
    else:
        lib = _build.library("sia_iso")
        fn = getattr(lib, f"pism_sia_flux_{prec}")
        fn.argtypes = [p] * 8 + [i, i, ctypes.POINTER(ctypes.c_double), p]
        c = K4._constants(K4.gamma(kw["A"], 3.0, kw["enhancement"]), 3.0,
                          kw["dx"], kw["dy"], None)
        H, s = args
        _build.launch(fn, name, H.device, H.data_ptr(), s.data_ptr(),
                      *(o.data_ptr() for o in out), work, max_D.data_ptr(),
                      *H.shape, (ctypes.c_double * len(c))(*c))
    return (*out, max_D)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_one_member_is_todays_launch(cuda, kernel, dtype):
    """A member axis of one member, and a field without one, give the bits
    of the single-field entry point (the launch before the member axis)."""
    args, kw = _members(kernel, 1, dtype, cuda)
    qe, qn, De, Dn, max_D = _todays_launch(
        kernel, [a[0] if a.dim() > 1 else a for a in args], kw)
    for got in (_wrapper(kernel)(*args, **kw),
                _wrapper(kernel)(*(a[0] if a.dim() > 1 else a for a in args),
                                 **kw)):
        got = [g.reshape(g.shape[-2:]) if g.dim() > 1 else g.reshape(())
               for g in got]
        for g, o in zip(got, (De, Dn, qe, qn, max_D)):
            assert _same_bits(g, o)


@pytest.mark.cuda
def test_paleo_ensemble_on_the_card_matches_cpu(cuda):
    """Three paleo members at 100 km in float64, 200 a: the card against
    the CPU, equal steps and dt-limit hits per member, H within 1e-10 of
    max H."""
    from pism_tpu_torch.parallel.ensemble import EnsembleRunner
    out = {}
    for where in ("cpu", cuda):
        model, batched, grid, _ = setups.paleo_ensemble_model(
            3, 100.0, dtype="float64", device=where, Mz=11)
        st, stats = EnsembleRunner(model).run_segment(batched, 0.0,
                                                     200.0 * SPY)
        out[str(where)] = (st.geometry.ice_thickness.cpu(), stats)
    (Ha, sa), (Hb, sb) = out["cpu"], out[str(cuda)]
    assert [s.nsteps for s in sa] == [s.nsteps for s in sb]
    assert [s.limit_hits for s in sa] == [s.limit_hits for s in sb]
    assert float((Hb - Ha).abs().max() / Ha.abs().max()) <= 1e-10


def _member_fields(B, dtype, device, grid):
    """The member dots' pairs x = (u, v) and y = (u + du, v + dv), and a
    positive field, as ``_ssa_members`` draws them."""
    rng = np.random.default_rng(40 + B)
    shape = (B, *grid)

    def t(x):
        return torch.tensor(x, dtype=dtype, device=device)

    u, v, du, dv = (t(rng.normal(size=shape) * 1e-5) for _ in range(4))
    ne = t(rng.uniform(1e13, 1e16, size=shape))
    return (u, v), (u + du * 0.1, v + dv * 0.1), ne


def _ssa_members(kernel, B, dtype, device, grid=(41, 23), dot_dtype=None):
    """(member-axis call, member b's single call, plain call) of one of the
    SSA solve's member-axis kernels on random (B, *grid) inputs; the member
    dots in ``dot_dtype`` if given (a member sum sums in its field's
    dtype)."""
    from pism_tpu_torch.ops.kernels import member_dot as KD
    if kernel.startswith("member_"):
        # |r|^2-like sums (no cancellation, so the relative error is the
        # summation order's alone)
        x, y, pos = _member_fields(B, dtype, device, grid)

        def one(p, b):
            return tuple(f[b:b + 1] for f in p)

        if kernel == "member_dot":
            return (lambda: KD.member_dot(x, y, dot_dtype),
                    lambda b: KD.member_dot(one(x, b), one(y, b),
                                            dot_dtype)[0],
                    lambda: KD.member_dot_plain(x, y, dot_dtype))
        if kernel == "member_dots":
            return (lambda: KD.member_dots(x, y, dot_dtype),
                    lambda b: tuple(d[0] for d in KD.member_dots(
                        one(x, b), one(y, b), dot_dtype)),
                    lambda: KD.member_dots_plain(x, y, dot_dtype))
        return (lambda: KD.member_sum(pos),
                lambda b: KD.member_sum(pos[b:b + 1])[0],
                lambda: KD.member_sum_plain(pos))
    rng = np.random.default_rng(40 + B)
    shape = (B, *grid)

    def t(x):
        return torch.tensor(x, dtype=dtype, device=device)

    u, v, du, dv = (t(rng.normal(size=shape) * 1e-5) for _ in range(4))
    ne, nn, beta = (t(rng.uniform(1e13, 1e16, size=shape)) for _ in range(3))
    du, dv = du * 0.1, dv * 0.1
    if kernel == "ssa_matvec":
        args = (u, v, ne, nn, beta)
        return (lambda: K.ssa_matvec(*args, DX, DY),
                lambda b: K.ssa_matvec(*(a[b] for a in args), DX, DY),
                lambda: K.ssa_matvec_plain(*args, DX, DY))
    if kernel == "ssa_newton_matvec":
        ce, cn = (t(rng.normal(size=(*shape, 4)) * 1e10) for _ in range(2))
        bc = torch.tensor(rng.uniform(size=shape) < 0.1, device=device)
        args = (u, v, du, dv, ne, nn, ce, cn, beta, bc)
        return (lambda: K.ssa_newton_matvec(*args, DX, DY),
                lambda b: K.ssa_newton_matvec(*(a[b] for a in args), DX, DY),
                lambda: K.ssa_newton_matvec_plain(*args, DX, DY))
    a, c = (t(rng.uniform(-0.2, 0.2, size=shape)) for _ in range(2))
    r, s = t(rng.normal(size=shape)), t(rng.uniform(1.0, 2.0, size=shape))
    sub = kernel == "pcr_lines_sub"
    factor = K2.pcr_factor_lines_sub if sub else K2.pcr_factor_lines
    plain = K2.pcr_factor_lines_sub_plain if sub else K2.pcr_factor_lines_plain

    def members_first(f):
        return tuple(x.movedim(-3, 0) if x.dim() == 4 else x
                     for x in f.coefficients())

    def one(b):
        f = factor(a[b], None, c[b])
        return (K2.pcr_apply(f, r[b], s[b]), *f.coefficients())

    def batched():
        f = factor(a, None, c)
        return (K2.pcr_apply(f, r, s), *members_first(f))

    def reference():
        f = plain(a.cpu(), None, c.cpu())
        return tuple(x.to(device) for x in (
            K2.pcr_apply_plain(f, r.cpu(), s.cpu()), *members_first(f)))

    return batched, one, reference


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("kernel", ["ssa_matvec", "ssa_newton_matvec",
                                    "pcr_lines", "pcr_lines_sub",
                                    "member_dot", "member_dots",
                                    "member_sum"])
@pytest.mark.parametrize("B", [1, 3, 100])
def test_ssa_member_launch_equals_single_launches(cuda, kernel, dtype, B):
    """The SSA solve's member-axis launches (K1, the Newton matvec, K2b and
    K2 factor and apply, the member dot, dots and sum): each member equal
    to the bit to a launch of it alone, and the plain version at the
    kernels' tolerances (``PERF.md`` section 6: the PCR kernels exactly,
    the dots and sums as sums in another order)."""
    batched, one, plain = _ssa_members(kernel, B, dtype, cuda)
    got = batched()
    got = got if isinstance(got, tuple) else (got,)
    for b in range(B):
        ref = one(b)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for g, o in zip(got, ref):
            assert _same_bits(g[b].reshape(o.shape), o)
    tol = 0.0 if kernel.startswith("pcr") else TOL[dtype]
    for g, p in zip(got, plain() if isinstance(plain(), tuple)
                    else (plain(),)):
        assert _rel(g, p) <= tol


#: the member dots' and sums' precisions: field dtype, dot dtype
MEMBER_PRECISIONS = {"f32": (torch.float32, None),
                     "f64": (torch.float64, None),
                     "f32_f64": (torch.float32, torch.float64)}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel, prec", [
    (k, p) for k in ("member_dot", "member_dots", "member_sum")
    for p in ("f32", "f64", "f32_f64")
    if (k, p) != ("member_sum", "f32_f64")])
@pytest.mark.parametrize("grid", [(251, 251), (141, 76)])
@pytest.mark.parametrize("B", [1, 3, 100])
def test_member_sums_over_chunks_equal_single_launches(cuda, kernel, prec,
                                                       grid, B):
    """The member dot, dots and sum where a member spans several chunks of
    the kernel (at the Antarctic and the 20 km grids; 251 x 251 has an odd
    cell count, so members start off 16-byte boundaries): each member equal
    to the bit to a launch of it alone, each dot of ``member_dots`` to
    ``member_dot`` of its pair, and the plain versions at ``TOL`` of the
    sum's dtype."""
    from pism_tpu_torch.ops.kernels import member_dot as KD
    dtype, dd = MEMBER_PRECISIONS[prec]
    batched, one, plain = _ssa_members(kernel, B, dtype, cuda, grid, dd)
    got = batched()
    got = got if isinstance(got, tuple) else (got,)
    for b in range(B):
        ref = one(b)
        ref = ref if isinstance(ref, tuple) else (ref,)
        for g, o in zip(got, ref):
            assert _same_bits(g[b].reshape(o.shape), o)
    want = plain()
    for g, p in zip(got, want if isinstance(want, tuple) else (want,)):
        assert g.dtype == (dd or dtype)
        assert _rel(g, p) <= TOL[dd or dtype]
    if kernel == "member_dots":
        x, y, _ = _member_fields(B, dtype, cuda, grid)
        for g, (p, q) in zip(got, ((x, x), (x, y), (y, y))):
            assert _same_bits(g, KD.member_dot(p, q, dd))
        assert _same_bits(got[1], KD.member_dot(y, x, dd))
        # the Krylov loop's and the final pairs: the dots asked for only
        for which, idx in ((("xx", "xy"), (0, 1)), (("xx", "yy"), (0, 2))):
            sub = KD.member_dots(x, y, dd, which)
            assert len(sub) == 2
            assert all(_same_bits(g, got[i]) for g, i in zip(sub, idx))


@pytest.mark.cuda
def test_ssa_member_launches_count_once(cuda):
    """One launch and one member count per call for all members; no single
    launch counted; the member dot, dots and sum each count their own
    launch only; the lockstep Krylov loop launches three dot kernels an
    iteration (one ``member_dot``, two ``member_dots``)."""
    from pism_tpu_torch.ops.kernels import member_dot as KD
    counters = ((K, "MEMBER_LAUNCHES", "LAUNCHES", "ssa_matvec"),
                (K, "NEWTON_MEMBER_LAUNCHES", "NEWTON_LAUNCHES",
                 "ssa_newton_matvec"),
                (K2, "MEMBER_LAUNCHES", "LAUNCHES", "pcr_lines"),
                (K2, "SUB_MEMBER_LAUNCHES", "SUB_LAUNCHES", "pcr_lines_sub"),
                (KD, "LAUNCHES", "SUM_LAUNCHES", "member_dot"),
                (KD, "DOTS_LAUNCHES", "LAUNCHES", "member_dots"),
                (KD, "SUM_LAUNCHES", "DOTS_LAUNCHES", "member_sum"))
    for mod, member_count, single, kernel in counters:
        batched, _, _ = _ssa_members(kernel, 7, torch.float32, cuda)
        m0 = getattr(mod, member_count)
        s0 = getattr(mod, single) if single else None
        batched()
        assert getattr(mod, member_count) - m0 == 1
        if single:
            assert getattr(mod, single) == s0

    B, cap = 3, [6, 6, 6]
    rng = np.random.default_rng(3)
    shift = torch.tensor(rng.uniform(0.5, 3.0, size=B),
                         device=cuda)[:, None, None]
    b = tuple(torch.tensor(rng.normal(size=(B, 9, 7)), device=cuda)
              for _ in range(2))

    def matvec(x):
        return tuple((4.0 + shift) * c
                     - (torch.roll(c, 1, -1) + torch.roll(c, -1, -1)
                        + torch.roll(c, 1, -2) + torch.roll(c, -1, -2))
                     for c in x)

    d0, p0 = KD.LAUNCHES, KD.DOTS_LAUNCHES
    _, its, _ = ssa_ops.bicgstab_solve(
        matvec, b, tuple(torch.zeros_like(c) for c in b), lambda r: r,
        rtol=1e-30, max_iter=cap, lead=1)
    assert its == cap
    # b.b and rhat.v an iteration; the head's and t's pairs an iteration,
    # and the final r.r with r0.r0
    assert KD.LAUNCHES - d0 == 1 + 6
    assert KD.DOTS_LAUNCHES - p0 == 2 * 6 + 1


@pytest.mark.cuda
def test_hybrid_ensemble_members_independent_of_the_batch(cuda):
    """Three hybrid-chain members at 100 km, float32, path A, 1 a on the
    card: each equal to the bit to its run as a 1-member ensemble."""
    from pism_tpu_torch.parallel.ensemble import (EnsembleRunner, member,
                                                  stack_states)
    model, batched, _, _ = setups.hybrid_ensemble_model(
        3, 100.0, device=cuda,
        extra_cfg={"stress_balance.ssa.fd.line_pcr_impl": "pallas_sublane"})
    runner = EnsembleRunner(model)
    out, stats = runner.run_segment(batched, 0.0, SPY)
    for b in range(3):
        one, (s1,) = runner.run_segment(stack_states([member(batched, b)]),
                                        0.0, SPY)
        assert torch.equal(one.geometry.ice_thickness[0],
                           out.geometry.ice_thickness[b])
        assert torch.equal(one.enthalpy[0], out.enthalpy[b])
        assert torch.equal(one.u_ssa[0], out.u_ssa[b])
        assert (s1.nsteps, s1.ssa_newton_iters, s1.ssa_krylov_iters) == (
            stats[b].nsteps, stats[b].ssa_newton_iters,
            stats[b].ssa_krylov_iters)


@pytest.mark.cuda
def test_hybrid_ensemble_on_the_card_matches_cpu(cuda):
    """Three hybrid-chain members at 100 km in float64 on path A, 2 a: the
    card against the CPU, equal steps and dt-limit hits per member, volumes
    within 1e-8 (the 100 km chain's bound in chip_smoke.py phase 1: the SSA
    solve amplifies the devices' rounding)."""
    from pism_tpu_torch.parallel.ensemble import EnsembleRunner
    out = {}
    for where in ("cpu", cuda):
        model, batched, _, _ = setups.hybrid_ensemble_model(
            3, 100.0, dtype="float64", device=where,
            extra_cfg={"stress_balance.ssa.fd.line_pcr_impl":
                       "pallas_sublane"})
        st, stats = EnsembleRunner(model).run_segment(batched, 0.0, 2 * SPY)
        out[str(where)] = (st.geometry.ice_thickness.sum(dim=(1, 2)).cpu(),
                           stats)
    (Va, sa), (Vb, sb) = out["cpu"], out[str(cuda)]
    assert [s.nsteps for s in sa] == [s.nsteps for s in sb]
    assert [s.limit_hits for s in sa] == [s.limit_hits for s in sb]
    assert float(((Vb - Va).abs() / Va).max()) <= 1e-8


# -- the PISM-PIK chain on the member axis ----------------------------------

def shelf(seed=3, Mx=29):
    """A marine ice sheet with a shelf, an ice rise and open ocean on a 700
    km square (``tests/test_torch_pico.py``'s), its ambient water and
    basins 1 (x <= 0), 2 and 3 (a corner without shelf data): (grid, H,
    bed, T0, S0, basins, X, Y). ``tests/test_torch_pik_ensemble.py`` takes
    it from here, since this file imports no JAX."""
    from pism_tpu_torch import Grid
    g = Grid(Mx=Mx, My=Mx, Lx=700e3, Ly=700e3)
    X, Y = np.meshgrid(g.x, g.y)
    r = np.sqrt(X ** 2 + Y ** 2)
    rng = np.random.default_rng(seed)
    bed = 600.0 - 1400.0 * (r / 500e3) ** 2 \
        + 700.0 * np.exp(-((X - 500e3) ** 2 + Y ** 2) / 30e3 ** 2)
    H = np.where(r < 350e3, 2500.0 * np.sqrt(np.clip(1 - (r / 420e3) ** 2,
                                                       0, None)), 0.0)
    H = np.where((r >= 350e3) & (r < 580e3), 550.0 - 1.5e-3 * (r - 350e3), H)
    H = H * (1.0 + 0.05 * rng.uniform(-1, 1, H.shape))
    T0 = 272.6 + 0.6 * (X + Y) / 1400e3 + rng.uniform(0.0, 0.3, H.shape)
    S0 = 34.5 + 0.2 * (X - Y) / 1400e3 + rng.uniform(0.0, 0.2, H.shape)
    basins = np.where(X <= 0.0, 1, 2)
    basins = np.where((X < -550e3) & (Y < -550e3), 3, basins)
    return g, H, bed, T0, S0, basins, X, Y


def _pik_members(B, dtype, device):
    """B members of ``shelf``'s ice sheet, H scaled per member, with their
    ambient water (warmer per member): (grid, member geometries, Pico)."""
    import dataclasses
    from pism_tpu_torch import Config, new_geometry
    from pism_tpu_torch import state as St
    from pism_tpu_torch.coupler.pico import Pico
    g, H, bed, T0, S0, basins, _, _ = shelf()
    scale = 1.0 + 0.2 * np.linspace(-1.0, 1.0, B)
    geoms = [new_geometry(torch.tensor(H * s, dtype=dtype, device=device),
                          torch.tensor(bed, dtype=dtype, device=device))
             for s in scale]
    gB = St.Geometry(**{f.name: torch.stack([getattr(x, f.name)
                                             for x in geoms])
                        for f in dataclasses.fields(St.Geometry)})
    TB = torch.tensor(T0[None] + np.linspace(0.0, 2.0, B)[:, None, None],
                      dtype=dtype, device=device)
    cfg = Config({"runtime.float_dtype":
                  "float32" if dtype == torch.float32 else "float64"})
    pico = Pico(temperature_ocean=torch.tensor(T0, device=device),
                salinity_ocean=torch.tensor(S0, device=device), config=cfg,
                grid=g, basin_mask=torch.tensor(basins, device=device),
                member_temperature=TB)
    return g, gB, pico


def _member_geometry(gB, b):
    """Member ``b`` of ``gB`` (and as a 1-member batch)."""
    import dataclasses
    from pism_tpu_torch import state as St
    return [St.Geometry(**{f.name: getattr(gB, f.name)[k]
                           for f in dataclasses.fields(St.Geometry)})
            for k in (b, slice(b, b + 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_pico_members_equal_one_member_calls(cuda, dtype):
    """``Pico.members`` of 100 members on the card against its call on
    each member alone, to the bit (its basin sums in ``member_sum``'s
    order, whatever the batch); box index and distances equal to the
    single form's ``Pico.solve``."""
    import dataclasses
    B = 100
    _, gB, pico = _pik_members(B, dtype, cuda)
    melt = pico.members(gB, None)
    boxes = pico.boxes(gB, lead=1)
    for b in range(B):
        geom, geom1 = _member_geometry(gB, b)
        one = dataclasses.replace(
            pico, member_temperature=pico.member_temperature[b:b + 1])
        assert torch.equal(melt[b], one.members(geom1, None)[0]), b
        solo = dataclasses.replace(
            pico, temperature_ocean=pico.member_temperature[b]).solve(geom,
                                                                      0.0)
        for got, want in zip(boxes, (solo.box, solo.d_gl, solo.d_if)):
            assert torch.equal(got[b], want), b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_basin_sums_do_not_depend_on_the_batch(cuda, dtype):
    """PICO's per-basin float sums at B = 100 against B = 1, to the bit,
    and against torch's sums of the same basin rows in float64 within 1e-6
    (float32) or 1e-14 (float64) of each: the sums' rounding."""
    _, gB, pico = _pik_members(100, dtype, cuda)
    x = gB.ice_thickness * pico.member_temperature
    sums = pico._basin_sums(x, 1)
    for b in range(100):
        assert torch.equal(sums[b], pico._basin_sums(x[b:b + 1], 1)[0]), b
    rows = torch.where(pico.onehot, x[:, None], 0.0)
    want = rows.double().sum(dim=(-2, -1))
    tol = 1e-6 if dtype == torch.float32 else 1e-14
    assert sums.shape == want.shape
    assert float(((sums.double() - want).abs() / want.abs().clamp_min(
        1e-300)).max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lingle_clark_members_equal_single_solves(cuda, dtype):
    """One member-axis Lingle-Clark solve of 100 members (the batched
    cuFFT transforms, a (B, 1, 1) dt) against each member's single solve,
    bed and viscous displacement to the bit."""
    from pism_tpu_torch import Config, Grid
    from pism_tpu_torch import state as St
    from pism_tpu_torch.model.beddef import LingleClark
    from pism_tpu_torch.parallel.ensemble import member
    B, M = 100, 61
    g = Grid(Mx=M, My=M, Lx=2000e3, Ly=2000e3)
    # no update interval: every member solves over its own dt
    lc = LingleClark(grid=g, config=Config(
        {"bed_deformation.update_interval": 0.0}))
    rng = np.random.default_rng(5)
    X, Y = np.meshgrid(g.x, g.y)
    H0 = np.clip(3000.0 * (1 - (X ** 2 + Y ** 2) / 1500e3 ** 2), 0, None)
    H = H0[None] * (1.0 + 0.1 * rng.uniform(-1, 1, (B, M, M)))

    def t(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=cuda)

    bed = t(np.broadcast_to(-500.0 + 1e-4 * X, (B, M, M)))
    geom = St.new_geometry(t(H), bed)
    state = St.ModelState(geometry=geom, bed_uplift=t(
        rng.normal(size=(B, M, M))), bed_reference=bed,
        bed_load_reference=t(np.broadcast_to(H0, (B, M, M))))
    dts = list(np.linspace(0.5, 3.0, B) * SPY)
    ends = [10.0 * SPY] * B
    got = lc.members_step(state, dts, ends, [True] * B)
    for b in range(B):
        want = lc.step(member(state, b), dts[b], t=ends[b])
        assert torch.equal(got.bed_uplift[b], want.bed_uplift), b
        assert torch.equal(got.geometry.bed_elevation[b],
                           want.geometry.bed_elevation), b


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_default_line_preconditioner_launches_the_pcr_kernels(cuda, dtype):
    """The default ``line_pcr_impl = xla`` on the card: the preconditioner
    of the 100 km chain's own linearization takes the PCR kernels (factor
    launches at its build, apply launches per application) and agrees with
    the plain PCR (``_plain_pcr=True``) to 1e-5 relative; the plain route
    launches nothing."""
    model, state, grid = setups.hybrid_greenland_model(dtype, 100.0,
                                                       device=cuda)
    assert model.ssa.pcr_impl == "xla"
    tau_c = model.yield_stress.compute(state, t=0.0)
    P = model.ssa.build_problem(state, tau_c)
    u, v = P["free"]((state.u_ssa, state.v_ssa))
    nuH, beta = P["make_nuH"](u, v), P["beta_fn"](u, v)
    g = torch.Generator(device=cuda).manual_seed(3)
    r = tuple(torch.randn(u.shape, generator=g, device=cuda, dtype=u.dtype)
              for _ in range(2))
    counts = (K2.FACTOR_LAUNCHES, K2.SUB_FACTOR_LAUNCHES, K2.LAUNCHES,
              K2.SUB_LAUNCHES)
    pre = ssa_ops.make_line_preconditioner(
        nuH, beta, P["bc_mask"], grid.dx, grid.dy, model.sh, "xla")
    got = pre(r)
    torch.cuda.synchronize()
    after = (K2.FACTOR_LAUNCHES, K2.SUB_FACTOR_LAUNCHES, K2.LAUNCHES,
             K2.SUB_LAUNCHES)
    assert [b - a for a, b in zip(counts, after)] == [1, 1, 1, 1]
    plain = ssa_ops.make_line_preconditioner(
        nuH, beta, P["bc_mask"], grid.dx, grid.dy, model.sh, "xla",
        _plain_pcr=True)
    ref = plain(r)
    torch.cuda.synchronize()
    assert (K2.FACTOR_LAUNCHES, K2.SUB_FACTOR_LAUNCHES, K2.LAUNCHES,
            K2.SUB_LAUNCHES) == after
    for a, b in zip(got, ref):
        assert float((a - b).abs().max() / b.abs().max()) <= 1e-5


@pytest.mark.cuda
def test_ismip_hom_on_the_card_matches_cpu(cuda):
    """ISMIP-HOM A at L = 20 km, 20 x 20 x 8 float64 (the Blatter solve's
    operator and preconditioner replayed as CUDA graphs): equal Newton
    sweeps, u within 1e-8 of max; the graphs' replay equals the plain
    calls to the bit."""
    from pism_tpu_torch.examples import ismip_hom
    from pism_tpu_torch.util import cudagraph

    cpu = ismip_hom.run_one("A", 20.0, 20, 8, "cpu", raw=True)
    n0 = cudagraph.CAPTURES
    card = ismip_hom.run_one("A", 20.0, 20, 8, cuda, raw=True)
    assert cudagraph.CAPTURES - n0 == 2 * card["newton_iters"]
    assert card["newton_iters"] == cpu["newton_iters"]
    assert np.abs(card["_u"] - cpu["_u"]).max() \
        <= 1e-8 * np.abs(cpu["_u"]).max()
    cudagraph.ENABLED = False
    try:
        plain = ismip_hom.run_one("A", 20.0, 20, 8, cuda, raw=True)
    finally:
        cudagraph.ENABLED = True
    np.testing.assert_array_equal(plain["_u"], card["_u"])


@pytest.mark.cuda
def test_fem_test_I_on_the_card_matches_cpu(cuda):
    """``-test I`` with SSAFEM at 11 x 31 float64: velocities within 1e-5
    of max|u| of the CPU run's and the report's errors within the JAX
    test's 40 m/a (the Krylov totals of this solve move with the
    rounding, so they are not held)."""
    from pism_tpu_torch.verification import ssa_tests

    cfg = {"stress_balance.ssa.method": "fem"}
    a = ssa_tests.run_test("I", My=31, config=cfg, device="cpu")
    b = ssa_tests.run_test("I", My=31, config=cfg, device=cuda)
    ua, ub = a.u.numpy(), b.u.cpu().numpy()
    assert np.abs(ub - ua).max() <= 1e-5 * np.abs(ua).max()
    assert b.errors["max"] < 40.0 and b.info["newton_iters"] > 0


@pytest.mark.cuda
def test_blatter_dome_on_the_card_matches_cpu(cuda):
    """The composite Blatter model on the JAX test's dome (16 x 16 x 11,
    enthalpy, 60 a): equal steps and hits, the volume within 1e-8."""
    from pism_tpu_torch import Config, Grid, Time
    from pism_tpu_torch.coupler.surface import Uniform
    from pism_tpu_torch.state import ModelState, new_geometry

    runs = {}
    for where in ("cpu", cuda):
        grid = Grid(Mx=16, My=16, Lx=300e3, Ly=300e3, Mz=11, Lz=3000.0)
        cfg = Config({"stress_balance.model": "blatter",
                      "energy.model": "enthalpy",
                      "basal_yield_stress.model": "mohr_coulomb",
                      "hydrology.model": "null",
                      "time_stepping.maximum_time_step": 20.0})
        r = np.asarray(grid.radius)
        H = torch.as_tensor(2500.0 * np.maximum(1.0 - (r / 280e3) ** 2, 0.0),
                            device=where)
        model = IceModel(grid=grid, config=cfg, device=where,
                         surface=Uniform(smb=0.3 / SPY, temperature=253.15))
        state, stats = model.run(ModelState(geometry=new_geometry(
            H, torch.zeros_like(H))), Time(0.0, 60.0 * SPY))
        runs[str(where)] = (float(state.geometry.ice_thickness.sum()), stats)
    (va, sa), (vb, sb) = runs["cpu"], runs[str(cuda)]
    assert sb.nsteps == sa.nsteps and sb.limit_hits_dict() == sa.limit_hits_dict()
    assert abs(vb - va) <= 1e-8 * va


@pytest.mark.cuda
def test_greenland_debm_chain_on_the_card_matches_cpu(cuda):
    """The Greenland dEBM chain (``examples/greenland_debm.py``) at 100 km in
    float64 for 1.5 model years (a few steps): equal step counts and hits,
    the bounds of test_chain_on_the_card_matches_cpu for H and the volume,
    and the albedo and snow within 1e-5 of their maxima (they follow the
    surface, which carries H's difference)."""
    from pism_tpu_torch.examples import greenland_debm

    runs = {}
    for where in ("cpu", cuda):
        model, state, _ = greenland_debm.greenland_debm_model(
            "float64", 100.0, 0.0, False, where)
        n0 = K.NEWTON_LAUNCHES
        state, t, stats = model.step_once(state, 0.0, 1.5 * SPY)
        runs[str(where)] = (state_to_numpy(state), stats,
                            K.NEWTON_LAUNCHES - n0)
    (a, sa, la), (b, sb, lb) = runs["cpu"], runs[str(cuda)]
    assert la == 0 and lb > 0
    assert sb.nsteps == sa.nsteps > 0
    assert sb.limit_hits_dict() == sa.limit_hits_dict()
    Ha, Hb = a["ice_thickness"], b["ice_thickness"]
    assert np.all(np.isfinite(Hb))
    assert np.abs(Hb - Ha).max() <= 1e-5 * Ha.max()
    assert abs(Hb.sum() - Ha.sum()) <= 1e-8 * Ha.sum()
    for name in ("surface_albedo", "snow_depth"):
        assert np.abs(b[name] - a[name]).max() <= 1e-5 * np.abs(a[name]).max()
    assert 0.47 <= b["surface_albedo"].min() <= b["surface_albedo"].max() <= 0.82
