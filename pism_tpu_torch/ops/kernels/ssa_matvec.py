"""SSA operator matvec: the hand-written CUDA kernels and their plain
versions.

K1 replaces the TPU kernel ``_ssa_matvec_kernel``
(``pism_tpu/ops/pallas_kernels.py:325``, reached through
``_ssa_matvec_raw`` and ``ssa_matvec_pallas`` with the custom JVP at
``:407-426``). The kernel, ``pism_tpu_torch/csrc/ssa_matvec.cu``, tiles
the grid: a block stages its tile of u and v in shared memory with clamped
neighbour indexing and computes each face stress once; its notes say what
bounds it. In float32 it moves 28 B/cell (0.3 MB at 20 km, 4.7 MB at 5
km), so at the chain's shapes it is bound by launch latency and the face
arithmetic, not by bandwidth. The forward-mode derivative is fused into
one pass (``ssa_matvec_jvp``, the rule of ``SSAMatvec.jvp``), one thread
per cell.

K5 (``ssa_matvec_halo``, ``ssa_matvec_halo_jvp``) replaces
``_ssa_matvec_sharded_kernel`` (``pism_tpu/ops/pallas_sharded.py:108``,
reached through ``_ssa_matvec_sharded_raw`` at ``:175``): the operator on
one shard of a mesh, read from blocks padded with ghost cells, two for the
velocities and one for nuH, with two flags that say whether the shard owns
the grid's west and south edges. ``ops/sharded.py`` exchanges the halos
and launches it per shard; on one card K5 over any mesh gives K1's result
on the whole field bit for bit, since both run the same tiled kernel
(a layout struct tells whole fields from padded blocks).

The SSA solve's Newton sweeps take neither JVP: ``ssa_newton_matvec`` (and
``ssa_newton_matvec_halo`` per shard) is the whole Newton matvec in one
launch. It frees the direction on the Dirichlet rows, forms the viscosity
tangent dnuH from the sweep's per-face coefficients (``ops/ssa.py``
``linearize_nuH``), applies the bilinear JVP with beta frozen and writes the
Dirichlet rows: what the plain tangent, the fused JVP launch and three
selects computed (what the JAX package's ``jax.linearize`` of the residual
computes, ``pism_tpu/model/ssa.py:717-725``). The kernel tiles the grid in
shared memory and computes each face once; its notes say what bounds it.

With the exact drag Jacobian (``drag_jacobian = exact``) the Newton matvec
also takes the sweep's per-cell plane c = 2 dbeta/d|u|^2
(``physics/basal.py`` ``dbeta_coef``) and adds dbeta (u, v), dbeta = c (u
fu + v fv) with (fu, fv) the freed direction, on the free rows: the
``dbeta`` term of the TPU kernel's JVP (``pallas_kernels.py:408-426``),
with dbeta formed in the launch. It is a template flag of the kernel, so
the launches without a plane keep their bits.

On an ensemble's member axis K1 and the Newton matvec take (B, My, Mx)
fields (the coefficient planes (B, My, Mx, 4)), one launch for all members
(``pism_ssa_matvec_members_*``, ``pism_ssa_newton_matvec_members_*``:
``blockIdx.z`` the member); member b equals a single launch on member b to
the bit. The plain versions take the leading axis too.

Routing: a CUDA tensor launches the kernel (built with ``nvcc`` at first use
by ``_build.py`` and loaded with ctypes); a CPU tensor runs the plain torch
version in this module. There is no fallback from one to the other.
``LAUNCHES`` counts launches of the matvec kernel, ``JVP_LAUNCHES`` those of
the fused JVP kernel, ``NEWTON_LAUNCHES`` those of the Newton matvec,
``MEMBER_LAUNCHES`` / ``NEWTON_MEMBER_LAUNCHES`` their member-axis
launches, and ``HALO_LAUNCHES`` / ``HALO_JVP_LAUNCHES`` /
``HALO_NEWTON_LAUNCHES`` those of K5, its fused JVP and its Newton matvec;
``NEWTON_DRAG_LAUNCHES`` and ``HALO_NEWTON_DRAG_LAUNCHES`` count the Newton
matvec's launches with a drag tangent (and only those).

Reverse mode (the inverse toolkit's adjoint): ``ssa_matvec_vjp`` and
``ssa_matvec_halo_vjp`` launch the transpose of K1 and of its padded-block
instance, ``pism_tpu_torch/csrc/ssa_matvec_vjp.cu`` (a library of its own,
built at first use like the others); the JAX package leaves that transpose
to XLA's reverse mode through its plain operator
(``pism_tpu/inverse/ssa_inverse.py:101``). ``SSAMatvec`` and
``SSAMatvecHalo`` reach them as their ``backward``. ``VJP_LAUNCHES`` and
``HALO_VJP_LAUNCHES`` count their launches; ``PLAIN_VJP_CALLS`` counts
calls of their plain versions (``torch.func.vjp`` of the plain operators),
which a CUDA tensor never reaches.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

LAUNCHES = 0
JVP_LAUNCHES = 0
HALO_LAUNCHES = 0
HALO_JVP_LAUNCHES = 0
NEWTON_LAUNCHES = 0
HALO_NEWTON_LAUNCHES = 0
MEMBER_LAUNCHES = 0
NEWTON_MEMBER_LAUNCHES = 0
NEWTON_DRAG_LAUNCHES = 0
HALO_NEWTON_DRAG_LAUNCHES = 0
VJP_LAUNCHES = 0
HALO_VJP_LAUNCHES = 0
PLAIN_VJP_CALLS = 0


# ---------------------------------------------------------------------------
# plain torch versions (CPU path, tests, and the reference on the card)
# ---------------------------------------------------------------------------

def _pad_edge(a):
    """``a`` ((My, Mx), or (B, My, Mx) on the member axis) with one edge
    ghost on each side of its last two axes."""
    p = F.pad(a.reshape(-1, 1, *a.shape[-2:]), (1, 1, 1, 1), mode="replicate")
    return p.view(*a.shape[:-2], a.shape[-2] + 2, a.shape[-1] + 2)


def _minus_div(u, v, nuH_e, nuH_n, dx, dy):
    up, vp = _pad_edge(u), _pad_edge(v)
    c = (..., slice(1, -1), slice(1, -1))
    e = (..., slice(1, -1), slice(2, None))
    nn = (..., slice(2, None), slice(1, -1))
    ne = (..., slice(2, None), slice(2, None))
    s_ = (..., slice(0, -2), slice(1, -1))
    se = (..., slice(0, -2), slice(2, None))
    w = (..., slice(1, -1), slice(0, -2))
    nw = (..., slice(2, None), slice(0, -2))

    ux_e = (up[e] - up[c]) / dx
    vx_e = (vp[e] - vp[c]) / dx
    uy_e = (up[nn] + up[ne] - up[s_] - up[se]) / (4.0 * dy)
    vy_e = (vp[nn] + vp[ne] - vp[s_] - vp[se]) / (4.0 * dy)
    uy_n = (up[nn] - up[c]) / dy
    vy_n = (vp[nn] - vp[c]) / dy
    ux_n = (up[e] + up[ne] - up[w] - up[nw]) / (4.0 * dx)
    vx_n = (vp[e] + vp[ne] - vp[w] - vp[nw]) / (4.0 * dx)

    Txx_e = 2.0 * nuH_e * (2.0 * ux_e + vy_e)
    Txy_n = nuH_n * (uy_n + vx_n)
    Tyy_n = 2.0 * nuH_n * (2.0 * vy_n + ux_n)
    Txy_e = nuH_e * (uy_e + vx_e)

    def shift_w(T):   # clamp-shift one column west
        return torch.cat([T[..., :1], T[..., :-1]], dim=-1)

    def shift_s(T):   # clamp-shift one row south
        return torch.cat([T[..., :1, :], T[..., :-1, :]], dim=-2)

    div_x = (Txx_e - shift_w(Txx_e)) / dx + (Txy_n - shift_s(Txy_n)) / dy
    div_y = (Txy_e - shift_w(Txy_e)) / dx + (Tyy_n - shift_s(Tyy_n)) / dy
    return -div_x, -div_y


def ssa_matvec_plain(u, v, nuH_e, nuH_n, beta, dx, dy):
    """A(u, v) = -div T + beta (u, v) in plain torch (any device), on
    (My, Mx) or (B, My, Mx) fields."""
    mx, my = _minus_div(u, v, nuH_e, nuH_n, dx, dy)
    return mx + beta * u, my + beta * v


def ssa_matvec_jvp_plain(u, v, du, dv, nuH_e, nuH_n, dnuH_e, dnuH_n, beta,
                         dbeta, dx, dy):
    """A(du, dv; nuH, beta) + A(u, v; dnuH, dbeta) in plain torch; ``dbeta``
    None means a frozen drag coefficient."""
    t1 = ssa_matvec_plain(du, dv, nuH_e, nuH_n, beta, dx, dy)
    mx, my = _minus_div(u, v, dnuH_e, dnuH_n, dx, dy)
    if dbeta is not None:
        mx, my = mx + dbeta * u, my + dbeta * v
    return t1[0] + mx, t1[1] + my


def _minus_div_halo(up, vp, nuH_e, nuH_n, west, south, dx, dy):
    """-div T on one shard: ``_ssa_matvec_sharded_kernel`` statement for
    statement. up, vp: (my+4, mx+4) with two ghosts; nuH_e, nuH_n:
    (my+2, mx+2) with one; west/south: the shard owns that edge of the
    grid."""
    my, mx = up.shape[0] - 4, up.shape[1] - 4
    return _minus_div_ext(up, vp, nuH_e[0:my + 1, 0:mx + 1],
                          nuH_n[0:my + 1, 0:mx + 1], west, south, dx, dy)


def _minus_div_ext(up, vp, nuHe, nuHn, west, south, dx, dy):
    """``_minus_div_halo`` with nuH given on the faces of the extended
    region only, (my+1, mx+1): cells -1 .. my-1 by -1 .. mx-1."""
    my, mx = up.shape[0] - 4, up.shape[1] - 4
    # extended region: cell (i, j), i = -1..my-1 <-> padded row i+2
    c = (slice(1, my + 2), slice(1, mx + 2))
    e = (slice(1, my + 2), slice(2, mx + 3))
    nn = (slice(2, my + 3), slice(1, mx + 2))
    ne = (slice(2, my + 3), slice(2, mx + 3))
    s_ = (slice(0, my + 1), slice(1, mx + 2))
    se = (slice(0, my + 1), slice(2, mx + 3))
    w = (slice(1, my + 2), slice(0, mx + 1))
    nw = (slice(2, my + 3), slice(0, mx + 1))

    ux_e = (up[e] - up[c]) / dx
    vx_e = (vp[e] - vp[c]) / dx
    uy_e = (up[nn] + up[ne] - up[s_] - up[se]) / (4.0 * dy)
    vy_e = (vp[nn] + vp[ne] - vp[s_] - vp[se]) / (4.0 * dy)
    uy_n = (up[nn] - up[c]) / dy
    vy_n = (vp[nn] - vp[c]) / dy
    ux_n = (up[e] + up[ne] - up[w] - up[nw]) / (4.0 * dx)
    vx_n = (vp[e] + vp[ne] - vp[w] - vp[nw]) / (4.0 * dx)

    Txx_e = 2.0 * nuHe * (2.0 * ux_e + vy_e)
    Txy_n = nuHn * (uy_n + vx_n)
    Tyy_n = 2.0 * nuHn * (2.0 * vy_n + ux_n)
    Txy_e = nuHe * (uy_e + vx_e)

    cTxx, wTxx = Txx_e[1:, 1:], Txx_e[1:, :-1]
    cTxy_e, wTxy_e = Txy_e[1:, 1:], Txy_e[1:, :-1]
    cTxy_n, sTxy_n = Txy_n[1:, 1:], Txy_n[:-1, 1:]
    cTyy, sTyy = Tyy_n[1:, 1:], Tyy_n[:-1, 1:]

    col = torch.arange(mx, device=up.device).expand(my, mx)
    row = torch.arange(my, device=up.device)[:, None].expand(my, mx)
    wclamp = (col == 0) & bool(west)
    sclamp = (row == 0) & bool(south)
    wTxx = torch.where(wclamp, cTxx, wTxx)
    wTxy_e = torch.where(wclamp, cTxy_e, wTxy_e)
    sTxy_n = torch.where(sclamp, cTxy_n, sTxy_n)
    sTyy = torch.where(sclamp, cTyy, sTyy)

    div_x = (cTxx - wTxx) / dx + (cTxy_n - sTxy_n) / dy
    div_y = (cTxy_e - wTxy_e) / dx + (cTyy - sTyy) / dy
    return -div_x, -div_y


def ssa_matvec_halo_plain(west, south, up, vp, nuH_e, nuH_n, beta, dx, dy):
    """K5 on one shard in plain torch (any device): (Au, Av) of the
    shard's (my, mx) cells."""
    mx_, my_ = _minus_div_halo(up, vp, nuH_e, nuH_n, west, south, dx, dy)
    return mx_ + beta * up[2:-2, 2:-2], my_ + beta * vp[2:-2, 2:-2]


def ssa_matvec_halo_jvp_plain(west, south, up, vp, dup, dvp, nuH_e, nuH_n,
                              dnuH_e, dnuH_n, beta, dbeta, dx, dy):
    """K5's fused JVP on one shard in plain torch, as
    ``ssa_matvec_jvp_plain``; ``dbeta`` None means a frozen drag
    coefficient."""
    t1 = ssa_matvec_halo_plain(west, south, dup, dvp, nuH_e, nuH_n, beta,
                               dx, dy)
    mx_, my_ = _minus_div_halo(up, vp, dnuH_e, dnuH_n, west, south, dx, dy)
    if dbeta is not None:
        mx_, my_ = mx_ + dbeta * up[2:-2, 2:-2], my_ + dbeta * vp[2:-2, 2:-2]
    return t1[0] + mx_, t1[1] + my_


def _neighbours(p, o, ny, nx):
    """The views c, e, w, n, ne, nw, s, se of the padded array ``p`` (its
    last two axes) over an ny x nx region whose first cell is ``p[o, o]``."""
    def at(dj, di):
        return p[..., o + dj:o + dj + ny, o + di:o + di + nx]
    return {"c": at(0, 0), "e": at(0, 1), "w": at(0, -1), "n": at(1, 0),
            "ne": at(1, 1), "nw": at(1, -1), "s": at(-1, 0), "se": at(-1, 1)}


def _tangent(fu, fv, coef_e, coef_n, dx, dy):
    """d nuH on the east and north faces of a region (the neighbour views
    of the direction, ``_neighbours``): the tangent of ``ops/ssa.py``
    ``linearize_nuH`` statement for statement, from its coefficients
    (a1, a2, a3, k) on a last axis."""
    a1, a2, a3, k = coef_e.unbind(-1)
    dux = (fu["e"] - fu["c"]) / dx
    dvy = (fv["n"] + fv["ne"] - fv["s"] - fv["se"]) / (4.0 * dy)
    duy = (fu["n"] + fu["ne"] - fu["s"] - fu["se"]) / (4.0 * dy)
    dvx = (fv["e"] - fv["c"]) / dx
    dnuH_e = (a1 * dux + a2 * dvy + a3 * (duy + dvx)) * k
    a1, a2, a3, k = coef_n.unbind(-1)
    dux = (fu["e"] + fu["ne"] - fu["w"] - fu["nw"]) / (4.0 * dx)
    dvy = (fv["n"] - fv["c"]) / dy
    duy = (fu["n"] - fu["c"]) / dy
    dvx = (fv["e"] + fv["ne"] - fv["w"] - fv["nw"]) / (4.0 * dx)
    dnuH_n = (a1 * dux + a2 * dvy + a3 * (duy + dvx)) * k
    return dnuH_e, dnuH_n


def _free_rows(t1u, t1v, mx, my, u, v, fu, fv, drag):
    """The free rows t1 + (-div T(u; dnuH)) of the Newton matvec, with the
    drag tangent dbeta (u, v), dbeta = drag (u fu + v fv), added to the
    second term when ``drag`` is given (the kernel's order)."""
    if drag is None:
        return t1u + mx, t1v + my
    db = drag * (u * fu + v * fv)
    return t1u + (mx + db * u), t1v + (my + db * v)


def ssa_newton_matvec_plain(u, v, du, dv, nuH_e, nuH_n, coef_e, coef_n,
                            beta, bc_mask, dx, dy, drag=None):
    """The Newton matvec in plain torch (any device), as the kernel forms
    it: fd = (du, dv) zeroed on ``bc_mask``; dnuH of fd from the per-face
    coefficients ``coef_e``, ``coef_n`` ((My, Mx, 4): a1, a2, a3, k);
    A(fd; nuH, beta) + A(u, v; dnuH, dbeta) on the free rows, (du, dv) on
    the Dirichlet rows; dbeta = drag (u fu + v fv) with ``drag`` the drag
    tangent's plane, or 0 without one. On the member axis every field has
    a leading (B,)."""
    My, Mx = u.shape[-2:]
    fu = torch.where(bc_mask, 0.0, du)
    fv = torch.where(bc_mask, 0.0, dv)
    dnuH_e, dnuH_n = _tangent(_neighbours(_pad_edge(fu), 1, My, Mx),
                              _neighbours(_pad_edge(fv), 1, My, Mx),
                              coef_e, coef_n, dx, dy)
    t1u, t1v = ssa_matvec_plain(fu, fv, nuH_e, nuH_n, beta, dx, dy)
    mx, my = _minus_div(u, v, dnuH_e, dnuH_n, dx, dy)
    Ju, Jv = _free_rows(t1u, t1v, mx, my, u, v, fu, fv, drag)
    return torch.where(bc_mask, du, Ju), torch.where(bc_mask, dv, Jv)


def ssa_newton_matvec_halo_plain(west, south, up, vp, dup, dvp, nuH_e, nuH_n,
                                 coef_e, coef_n, beta, bcp, dx, dy,
                                 drag=None):
    """The Newton matvec on one shard in plain torch (any device): blocks
    as K5's, with ``bcp`` and the direction's given two ghosts and the
    coefficients one; dnuH is formed on the faces of K5's extended region,
    the west column and south row of faces included, from the ghosts.
    ``drag``: the drag tangent's plane, (my, mx) as beta, or None."""
    my, mx = beta.shape
    fup = torch.where(bcp, 0.0, dup)
    fvp = torch.where(bcp, 0.0, dvp)
    dnuH_e, dnuH_n = _tangent(_neighbours(fup, 1, my + 1, mx + 1),
                              _neighbours(fvp, 1, my + 1, mx + 1),
                              coef_e[0:my + 1, 0:mx + 1],
                              coef_n[0:my + 1, 0:mx + 1], dx, dy)
    t1u, t1v = ssa_matvec_halo_plain(west, south, fup, fvp, nuH_e, nuH_n,
                                     beta, dx, dy)
    mx_, my_ = _minus_div_ext(up, vp, dnuH_e, dnuH_n, west, south, dx, dy)
    bc, du, dv = bcp[2:-2, 2:-2], dup[2:-2, 2:-2], dvp[2:-2, 2:-2]
    Ju, Jv = _free_rows(t1u, t1v, mx_, my_, up[2:-2, 2:-2], vp[2:-2, 2:-2],
                        fup[2:-2, 2:-2], fvp[2:-2, 2:-2], drag)
    return torch.where(bc, du, Ju), torch.where(bc, dv, Jv)


def _vjp_plain(fn, primals, gu, gv, need):
    """``torch.func.vjp`` of ``fn`` at ``primals`` = (u, v, nuH_e, nuH_n,
    beta) applied to (gu, gv): (ubar, vbar, nuH_e_bar, nuH_n_bar, beta_bar),
    None where ``need`` = (velocities, nuH, beta) leaves a pair out."""
    global PLAIN_VJP_CALLS
    PLAIN_VJP_CALLS += 1
    _, vjp = torch.func.vjp(fn, *primals)
    ub, vb, nb_e, nb_n, bb = vjp((gu, gv))
    vel, nuh, beta = need
    return (ub if vel else None, vb if vel else None,
            nb_e if nuh else None, nb_n if nuh else None,
            bb if beta else None)


def ssa_matvec_vjp_plain(u, v, nuH_e, nuH_n, beta, gu, gv, dx, dy,
                         need=(True, True, True)):
    """The cotangents of (u, v, nuH_e, nuH_n, beta) from those (gu, gv) of
    A(u, v) in plain torch (any device): ``torch.func.vjp`` of
    ``ssa_matvec_plain``; ``need`` as ``_vjp_plain``."""
    return _vjp_plain(lambda *a: ssa_matvec_plain(*a, dx, dy),
                      (u, v, nuH_e, nuH_n, beta), gu, gv, need)


def ssa_matvec_halo_vjp_plain(west, south, up, vp, nuH_e, nuH_n, beta, gu,
                              gv, dx, dy, need=(True, True, True)):
    """K5's VJP in plain torch: the cotangents of the padded blocks (up, vp
    with two ghosts, nuH with one) and of beta from those of K5's (my, mx)
    outputs; ``torch.func.vjp`` of ``ssa_matvec_halo_plain``."""
    return _vjp_plain(
        lambda *a: ssa_matvec_halo_plain(west, south, *a, dx, dy),
        (up, vp, nuH_e, nuH_n, beta), gu, gv, need)


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    """The kernel library (built at first use by ``_build``), with the
    argument types of its entry points set."""
    lib = _build.library("ssa_matvec")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for prec in ("f32", "f64"):
        fn = getattr(lib, f"pism_ssa_matvec_{prec}")
        fn.argtypes = [p] * 7 + [i, i, d, d, p]
        fn.restype = i
        fn = getattr(lib, f"pism_ssa_matvec_jvp_{prec}")
        fn.argtypes = [p] * 12 + [i, i, d, d, p]
        fn.restype = i
        fn = getattr(lib, f"pism_ssa_matvec_halo_{prec}")
        fn.argtypes = [p] * 7 + [i, i, i, i, d, d, p]
        fn.restype = i
        fn = getattr(lib, f"pism_ssa_matvec_halo_jvp_{prec}")
        fn.argtypes = [p] * 12 + [i, i, i, i, d, d, p]
        fn.restype = i
        fn = getattr(lib, f"pism_ssa_newton_matvec_{prec}")
        fn.argtypes = [p] * 13 + [i, i, d, d, p]
        fn.restype = i
        fn = getattr(lib, f"pism_ssa_newton_matvec_halo_{prec}")
        fn.argtypes = [p] * 13 + [i, i, i, i, d, d, p]
        fn.restype = i
        fn = getattr(lib, f"pism_ssa_matvec_members_{prec}")
        fn.argtypes = [p] * 7 + [i, i, i, d, d, p]
        fn.restype = i
        fn = getattr(lib, f"pism_ssa_newton_matvec_members_{prec}")
        fn.argtypes = [p] * 13 + [i, i, i, d, d, p]
        fn.restype = i
    return lib


def build() -> None:
    """Compile and load the kernel libraries now, both sources in parallel
    (they are built at first use otherwise)."""
    _build.build("ssa_matvec", "ssa_matvec_vjp")
    _library()
    _vjp_library()


@functools.lru_cache(maxsize=1)
def _vjp_library() -> ctypes.CDLL:
    """The reverse-mode kernels' library (``csrc/ssa_matvec_vjp.cu``)."""
    lib = _build.library("ssa_matvec_vjp")
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for prec in ("f32", "f64"):
        fn = getattr(lib, f"pism_ssa_matvec_vjp_{prec}")
        fn.argtypes = [p] * 12 + [i, i, d, d, p]
        fn.restype = i
        fn = getattr(lib, f"pism_ssa_matvec_halo_vjp_{prec}")
        fn.argtypes = [p] * 12 + [i, i, i, i, d, d, p]
        fn.restype = i
    return lib


def _check(*tensors, members=False):
    """Raise unless the tensors are 2D (3D with ``members``: a leading
    member axis) and of one shape."""
    _build.check("ssa_matvec", *tensors)
    dim = 3 if members else 2
    for t in tensors:
        if t.dim() != dim or t.shape != tensors[0].shape:
            raise ValueError(
                f"ssa_matvec takes {dim}D tensors of one shape, got "
                f"{tuple(t.shape)} and {tuple(tensors[0].shape)}")


def _launch(name, inputs, outputs, ints, dx, dy):
    """Launch ``pism_<name>_<f32|f64>`` with the pointers of ``inputs``
    (None for a null one) and ``outputs``, then ``ints``, dx and dy."""
    prec = "f32" if outputs[0].dtype == torch.float32 else "f64"
    fn = getattr(_library(), f"pism_{name}_{prec}")
    _build.launch(fn, name, outputs[0].device,
                  *[None if t is None else t.data_ptr() for t in inputs],
                  *[t.data_ptr() for t in outputs],
                  *[int(i) for i in ints], float(dx), float(dy))


def ssa_matvec(u, v, nuH_e, nuH_n, beta, dx, dy):
    """A(u, v) = -div T + beta (u, v) on (My, Mx) tensors, or on (B, My,
    Mx) tensors of an ensemble's members (one launch for all).

    CUDA tensors launch the kernel; CPU tensors run ``ssa_matvec_plain``."""
    members = u.dim() == 3
    _check(u, v, nuH_e, nuH_n, beta, members=members)
    if u.device.type == "cpu":
        return ssa_matvec_plain(u, v, nuH_e, nuH_n, beta, dx, dy)
    global LAUNCHES, MEMBER_LAUNCHES
    Au, Av = torch.empty_like(u), torch.empty_like(v)
    name = "ssa_matvec_members" if members else "ssa_matvec"
    _launch(name, (u, v, nuH_e, nuH_n, beta), (Au, Av), u.shape, dx, dy)
    if members:
        MEMBER_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return Au, Av


def ssa_matvec_jvp(u, v, du, dv, nuH_e, nuH_n, dnuH_e, dnuH_n, beta, dbeta,
                   dx, dy):
    """Forward-mode derivative of the operator in one pass:
    A(du, dv; nuH, beta) + A(u, v; dnuH, dbeta), with ``dbeta`` None for a
    frozen drag coefficient. CUDA tensors launch the fused kernel; CPU
    tensors run ``ssa_matvec_jvp_plain``."""
    ts = (u, v, du, dv, nuH_e, nuH_n, dnuH_e, dnuH_n, beta)
    _check(*ts, *(() if dbeta is None else (dbeta,)))
    if u.device.type == "cpu":
        return ssa_matvec_jvp_plain(*ts, dbeta, dx, dy)
    global JVP_LAUNCHES
    Ju, Jv = torch.empty_like(u), torch.empty_like(v)
    _launch("ssa_matvec_jvp", (*ts, dbeta), (Ju, Jv), u.shape, dx, dy)
    JVP_LAUNCHES += 1
    return Ju, Jv


def _check_halo(vel, nuH, flat):
    """Raise unless the blocks of one shard have K5's shapes: velocities
    (my+4, mx+4), nuH (my+2, mx+2), beta and dbeta (my, mx)."""
    _build.check("ssa_matvec_halo", *vel, *nuH, *flat)
    my, mx = flat[0].shape
    for ts, g in ((vel, 2), (nuH, 1), (flat, 0)):
        for t in ts:
            if tuple(t.shape) != (my + 2 * g, mx + 2 * g):
                raise ValueError(
                    f"ssa_matvec_halo takes blocks with {g} ghost(s) around "
                    f"a {my}x{mx} shard, got {tuple(t.shape)}")


def ssa_matvec_halo(west, south, up, vp, nuH_e, nuH_n, beta, dx, dy):
    """K5: (Au, Av) of one shard's (my, mx) cells from its padded blocks
    (``_check_halo``); west/south: the shard owns that edge of the grid.
    CUDA tensors launch the kernel; CPU tensors run
    ``ssa_matvec_halo_plain``."""
    _check_halo((up, vp), (nuH_e, nuH_n), (beta,))
    if up.device.type == "cpu":
        return ssa_matvec_halo_plain(west, south, up, vp, nuH_e, nuH_n, beta,
                                     dx, dy)
    global HALO_LAUNCHES
    Au, Av = torch.empty_like(beta), torch.empty_like(beta)
    _launch("ssa_matvec_halo", (up, vp, nuH_e, nuH_n, beta), (Au, Av),
            (*beta.shape, west, south), dx, dy)
    HALO_LAUNCHES += 1
    return Au, Av


def ssa_matvec_halo_jvp(west, south, up, vp, dup, dvp, nuH_e, nuH_n, dnuH_e,
                        dnuH_n, beta, dbeta, dx, dy):
    """K5's fused JVP on one shard: A(du, dv; nuH, beta) + A(u, v; dnuH,
    dbeta), with ``dbeta`` None for a frozen drag coefficient. CUDA tensors
    launch the kernel; CPU tensors run ``ssa_matvec_halo_jvp_plain``."""
    _check_halo((up, vp, dup, dvp), (nuH_e, nuH_n, dnuH_e, dnuH_n),
                (beta,) if dbeta is None else (beta, dbeta))
    if up.device.type == "cpu":
        return ssa_matvec_halo_jvp_plain(west, south, up, vp, dup, dvp,
                                         nuH_e, nuH_n, dnuH_e, dnuH_n, beta,
                                         dbeta, dx, dy)
    global HALO_JVP_LAUNCHES
    Ju, Jv = torch.empty_like(beta), torch.empty_like(beta)
    _launch("ssa_matvec_halo_jvp",
            (up, vp, dup, dvp, nuH_e, nuH_n, dnuH_e, dnuH_n, beta, dbeta),
            (Ju, Jv), (*beta.shape, west, south), dx, dy)
    HALO_JVP_LAUNCHES += 1
    return Ju, Jv


def _check_faces_and_mask(name, like, coefs, face_shape, bc, bc_shape):
    """Raise unless the coefficient planes are (face_shape, 4) tensors of
    ``like``'s dtype and device, and ``bc`` a contiguous bool tensor of
    ``bc_shape`` on that device."""
    _build.check(name, like, *coefs)
    for c in coefs:
        if tuple(c.shape) != (*face_shape, 4):
            raise ValueError(f"{name} takes coefficients of shape "
                             f"{(*face_shape, 4)}, got {tuple(c.shape)}")
    if bc.dtype != torch.bool or bc.device != like.device \
            or not bc.is_contiguous() or tuple(bc.shape) != tuple(bc_shape):
        raise ValueError(f"{name} takes a contiguous bool mask of shape "
                         f"{tuple(bc_shape)} on {like.device}")


def ssa_newton_matvec(u, v, du, dv, nuH_e, nuH_n, coef_e, coef_n, beta,
                      bc_mask, dx, dy, drag=None):
    """The Newton matvec of a sweep linearized at (u, v), one launch: see
    ``ssa_newton_matvec_plain``. (My, Mx) fields; ``coef_e``, ``coef_n``
    (My, Mx, 4); ``bc_mask`` bool; ``drag`` the drag tangent's (My, Mx)
    plane or None; on an ensemble's member axis each with a leading (B,),
    one launch for all members (without a drag tangent). CUDA tensors
    launch the kernel; CPU tensors run ``ssa_newton_matvec_plain``."""
    members = u.dim() == 3
    _check(u, v, du, dv, nuH_e, nuH_n, beta,
           *(() if drag is None else (drag,)), members=members)
    _check_faces_and_mask("ssa_newton_matvec", u, (coef_e, coef_n), u.shape,
                          bc_mask, u.shape)
    if members and drag is not None:
        raise NotImplementedError(
            "the Newton matvec's drag tangent on an ensemble's member axis is "
            "not implemented in pism_tpu_torch (ROADMAP Queue 1 item 3)")
    ts = (u, v, du, dv, nuH_e, nuH_n, coef_e, coef_n, beta)
    if u.device.type == "cpu":
        return ssa_newton_matvec_plain(*ts, bc_mask, dx, dy, drag)
    global NEWTON_LAUNCHES, NEWTON_MEMBER_LAUNCHES, NEWTON_DRAG_LAUNCHES
    Ju, Jv = torch.empty_like(u), torch.empty_like(v)
    if members:
        _launch("ssa_newton_matvec_members", (*ts, None, bc_mask), (Ju, Jv),
                u.shape, dx, dy)
        NEWTON_MEMBER_LAUNCHES += 1
    else:
        _launch("ssa_newton_matvec", (*ts, drag, bc_mask), (Ju, Jv), u.shape,
                dx, dy)
        if drag is None:
            NEWTON_LAUNCHES += 1
        else:
            NEWTON_DRAG_LAUNCHES += 1
    return Ju, Jv


def ssa_newton_matvec_halo(west, south, up, vp, dup, dvp, nuH_e, nuH_n,
                           coef_e, coef_n, beta, bcp, dx, dy, drag=None):
    """The Newton matvec on one shard's (my, mx) cells from K5's blocks
    (``_check_halo``), ``bcp`` (my+4, mx+4) and the coefficients
    (my+2, mx+2, 4); west/south: the shard owns that edge of the grid;
    ``drag`` the drag tangent's (my, mx) plane or None. CUDA tensors launch
    the kernel; CPU tensors run ``ssa_newton_matvec_halo_plain``."""
    _check_halo((up, vp, dup, dvp), (nuH_e, nuH_n),
                (beta,) if drag is None else (beta, drag))
    my, mx = beta.shape
    _check_faces_and_mask("ssa_newton_matvec_halo", beta, (coef_e, coef_n),
                          (my + 2, mx + 2), bcp, (my + 4, mx + 4))
    ts = (up, vp, dup, dvp, nuH_e, nuH_n, coef_e, coef_n, beta)
    if up.device.type == "cpu":
        return ssa_newton_matvec_halo_plain(west, south, *ts, bcp, dx, dy,
                                            drag)
    global HALO_NEWTON_LAUNCHES, HALO_NEWTON_DRAG_LAUNCHES
    Ju, Jv = torch.empty_like(beta), torch.empty_like(beta)
    _launch("ssa_newton_matvec_halo", (*ts, drag, bcp), (Ju, Jv),
            (my, mx, west, south), dx, dy)
    if drag is None:
        HALO_NEWTON_LAUNCHES += 1
    else:
        HALO_NEWTON_DRAG_LAUNCHES += 1
    return Ju, Jv


def _vjp_outputs(like_vel, like_nuh, like_beta, need):
    """Empty outputs of a VJP launch, None where ``need`` leaves them out."""
    want_vel, want_nuh, want_beta = need
    e = torch.empty_like
    return (e(like_vel) if want_vel else None,
            e(like_vel) if want_vel else None,
            e(like_nuh) if want_nuh else None,
            e(like_nuh) if want_nuh else None,
            e(like_beta) if want_beta else None)


def ssa_matvec_vjp(u, v, nuH_e, nuH_n, beta, gu, gv, dx, dy,
                   need=(True, True, True)):
    """Reverse mode of K1: (ubar, vbar, nuH_e_bar, nuH_n_bar, beta_bar)
    from the cotangents (gu, gv) of A(u, v) on (My, Mx) tensors; ``need`` =
    (velocities, nuH, beta) says which pairs to compute (None for the
    others, which a launch does not write). CUDA tensors launch the kernel;
    CPU tensors run ``ssa_matvec_vjp_plain``."""
    _check(u, v, nuH_e, nuH_n, beta, gu, gv)
    if u.device.type == "cpu":
        return ssa_matvec_vjp_plain(u, v, nuH_e, nuH_n, beta, gu, gv, dx, dy,
                                    need)
    global VJP_LAUNCHES
    out = _vjp_outputs(u, u, u, need)
    prec = "f32" if u.dtype == torch.float32 else "f64"
    fn = getattr(_vjp_library(), f"pism_ssa_matvec_vjp_{prec}")
    _build.launch(fn, "ssa_matvec_vjp", u.device,
                  *[t.data_ptr() for t in (u, v, nuH_e, nuH_n, beta, gu, gv)],
                  *[None if t is None else t.data_ptr() for t in out],
                  int(u.shape[0]), int(u.shape[1]), float(dx), float(dy))
    VJP_LAUNCHES += 1
    return out


def ssa_matvec_halo_vjp(west, south, up, vp, nuH_e, nuH_n, beta, gu, gv, dx,
                        dy, need=(True, True, True)):
    """Reverse mode of K5 on one padded region (``_check_halo``'s blocks):
    the cotangents of up, vp ((my+4, mx+4)), nuH_e, nuH_n ((my+2, mx+2))
    and beta ((my, mx)) from those (gu, gv) of its (my, mx) outputs;
    ``need`` as ``ssa_matvec_vjp``. CUDA tensors launch the kernel; CPU
    tensors run ``ssa_matvec_halo_vjp_plain``."""
    _check_halo((up, vp), (nuH_e, nuH_n), (beta, gu, gv))
    if up.device.type == "cpu":
        return ssa_matvec_halo_vjp_plain(west, south, up, vp, nuH_e, nuH_n,
                                         beta, gu, gv, dx, dy, need)
    global HALO_VJP_LAUNCHES
    out = _vjp_outputs(up, nuH_e, beta, need)
    prec = "f32" if up.dtype == torch.float32 else "f64"
    fn = getattr(_vjp_library(), f"pism_ssa_matvec_halo_vjp_{prec}")
    my, mx = beta.shape
    _build.launch(fn, "ssa_matvec_halo_vjp", up.device,
                  *[t.data_ptr() for t in (up, vp, nuH_e, nuH_n, beta, gu,
                                           gv)],
                  *[None if t is None else t.data_ptr() for t in out],
                  int(my), int(mx), int(bool(west)), int(bool(south)),
                  float(dx), float(dy))
    HALO_VJP_LAUNCHES += 1
    return out


def _need(ctx, first):
    """(velocities, nuH, beta) of ``ctx.needs_input_grad`` from the index
    of u among the Function's inputs."""
    n = ctx.needs_input_grad[first:first + 5]
    return (n[0] or n[1], n[2] or n[3], n[4])


def _grads(gu, gv):
    """Output cotangents as the kernels take them (contiguous; autograd may
    hand over an expanded zero)."""
    return gu.contiguous(), gv.contiguous()


class SSAMatvecHalo(torch.autograd.Function):
    """K5 on one padded region as a differentiable function of its blocks
    (the periodic route's operator on the wrap-padded field): reverse mode
    under ``torch.autograd`` through the VJP kernel
    ``ssa_matvec_halo_vjp``. Forward mode is not provided."""

    @staticmethod
    def forward(west, south, up, vp, nuH_e, nuH_n, beta, dx, dy):
        return ssa_matvec_halo(west, south, up, vp, nuH_e, nuH_n, beta, dx,
                               dy)

    @staticmethod
    def setup_context(ctx, inputs, output):
        west, south, up, vp, nuH_e, nuH_n, beta, dx, dy = inputs
        ctx.save_for_backward(up, vp, nuH_e, nuH_n, beta)
        ctx.args = (west, south, dx, dy)

    @staticmethod
    def backward(ctx, gu, gv):
        west, south, dx, dy = ctx.args
        bars = ssa_matvec_halo_vjp(west, south, *ctx.saved_tensors,
                                   *_grads(gu, gv), dx, dy, _need(ctx, 2))
        return (None, None, *bars, None, None)


class _SSAMatvecJVP(torch.autograd.Function):
    """The fused JVP kernel as a Function of its own. Under ``torch.func``
    transforms a Function's ``forward`` receives plain tensors, while its
    ``jvp`` sees the transform's wrapped tensors, which have no storage for
    a kernel to read; so ``SSAMatvec.jvp`` reaches the kernel through this
    ``forward``. Its own derivative is not provided."""

    @staticmethod
    def forward(*args):
        return ssa_matvec_jvp(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass


class SSAMatvec(torch.autograd.Function):
    """The operator as a differentiable function of (u, v, nuH_e, nuH_n,
    beta): forward mode through the fused JVP kernel (the bilinear rule of
    the TPU kernel's custom JVP), under ``torch.autograd.forward_ad`` and
    ``torch.func.jvp`` alike; reverse mode under ``torch.autograd`` through
    the VJP kernel (``ssa_matvec_vjp``), which computes only the
    cotangents of the inputs that need one. (Reverse mode under
    ``torch.func`` would hand the kernel wrapped tensors without storage,
    and raises.)"""

    @staticmethod
    def forward(u, v, nuH_e, nuH_n, beta, dx, dy):
        return ssa_matvec(u, v, nuH_e, nuH_n, beta, dx, dy)

    @staticmethod
    def setup_context(ctx, inputs, output):
        u, v, nuH_e, nuH_n, beta, dx, dy = inputs
        ctx.save_for_forward(u, v, nuH_e, nuH_n, beta)
        ctx.save_for_backward(u, v, nuH_e, nuH_n, beta)
        ctx.dx, ctx.dy = dx, dy

    @staticmethod
    def backward(ctx, gu, gv):
        bars = ssa_matvec_vjp(*ctx.saved_tensors, *_grads(gu, gv), ctx.dx,
                              ctx.dy, _need(ctx, 0))
        return (*bars, None, None)

    @staticmethod
    def jvp(ctx, du, dv, dnuH_e, dnuH_n, dbeta, _ddx, _ddy):
        u, v, nuH_e, nuH_n, beta = ctx.saved_tensors
        z = lambda t, like: torch.zeros_like(like) if t is None else t
        return _SSAMatvecJVP.apply(u, v, z(du, u), z(dv, v), nuH_e, nuH_n,
                                   z(dnuH_e, nuH_e), z(dnuH_n, nuH_n), beta,
                                   dbeta, ctx.dx, ctx.dy)
