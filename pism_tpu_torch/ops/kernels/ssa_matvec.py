"""SSA operator matvec: the hand-written CUDA kernel and its plain version.

Replaces the TPU kernel ``_ssa_matvec_kernel``
(``pism_tpu/ops/pallas_kernels.py:325``, reached through
``_ssa_matvec_raw`` and ``ssa_matvec_pallas`` with the custom JVP at
``:407-426``). The kernel, ``pism_tpu_torch/csrc/ssa_matvec.cu``, runs one
thread per cell with clamped neighbour indexing; its notes say what bounds
it. In float32 it moves 28 B/cell (0.3 MB at 20 km, 4.7 MB at 5 km), so at
the chain's shapes it is bound by launch latency, not by bandwidth. The
forward-mode derivative is fused into one pass (``ssa_matvec_jvp``), which
halves the launches of every Newton matvec; cutting the launches of a whole
Krylov iteration (a CUDA graph) is the next step.

Routing: a CUDA tensor launches the kernel (built with ``nvcc`` at first use
by ``_build.py`` and loaded with ctypes); a CPU tensor runs the plain torch
version in this module. There is no fallback from one to the other.
``LAUNCHES`` counts launches of the matvec kernel and ``JVP_LAUNCHES``
those of the fused JVP kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

LAUNCHES = 0
JVP_LAUNCHES = 0


# ---------------------------------------------------------------------------
# plain torch versions (CPU path, tests, and the reference on the card)
# ---------------------------------------------------------------------------

def _pad_edge(a):
    return F.pad(a[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]


def _minus_div(u, v, nuH_e, nuH_n, dx, dy):
    up, vp = _pad_edge(u), _pad_edge(v)
    c = (slice(1, -1), slice(1, -1))
    e = (slice(1, -1), slice(2, None))
    nn = (slice(2, None), slice(1, -1))
    ne = (slice(2, None), slice(2, None))
    s_ = (slice(0, -2), slice(1, -1))
    se = (slice(0, -2), slice(2, None))
    w = (slice(1, -1), slice(0, -2))
    nw = (slice(2, None), slice(0, -2))

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
        return torch.cat([T[:, :1], T[:, :-1]], dim=1)

    def shift_s(T):   # clamp-shift one row south
        return torch.cat([T[:1, :], T[:-1, :]], dim=0)

    div_x = (Txx_e - shift_w(Txx_e)) / dx + (Txy_n - shift_s(Txy_n)) / dy
    div_y = (Txy_e - shift_w(Txy_e)) / dx + (Tyy_n - shift_s(Tyy_n)) / dy
    return -div_x, -div_y


def ssa_matvec_plain(u, v, nuH_e, nuH_n, beta, dx, dy):
    """A(u, v) = -div T + beta (u, v) in plain torch (any device)."""
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
    return lib


def build() -> None:
    """Compile and load the kernel library now (it is built at first use
    otherwise)."""
    _library()


def _check(*tensors):
    _build.check("ssa_matvec", *tensors)
    for t in tensors:
        if t.dim() != 2 or t.shape != tensors[0].shape:
            raise ValueError(
                f"ssa_matvec takes 2D tensors of one shape, got {tuple(t.shape)} "
                f"and {tuple(tensors[0].shape)}")


def _launch(name, inputs, outputs, shape, dx, dy):
    prec = "f32" if outputs[0].dtype == torch.float32 else "f64"
    fn = getattr(_library(), f"pism_{name}_{prec}")
    _build.launch(fn, name, outputs[0].device,
                  *[None if t is None else t.data_ptr() for t in inputs],
                  *[t.data_ptr() for t in outputs],
                  int(shape[0]), int(shape[1]), float(dx), float(dy))


def ssa_matvec(u, v, nuH_e, nuH_n, beta, dx, dy):
    """A(u, v) = -div T + beta (u, v) on (My, Mx) tensors.

    CUDA tensors launch the kernel; CPU tensors run ``ssa_matvec_plain``."""
    _check(u, v, nuH_e, nuH_n, beta)
    if u.device.type == "cpu":
        return ssa_matvec_plain(u, v, nuH_e, nuH_n, beta, dx, dy)
    global LAUNCHES
    Au, Av = torch.empty_like(u), torch.empty_like(v)
    _launch("ssa_matvec", (u, v, nuH_e, nuH_n, beta), (Au, Av), u.shape, dx, dy)
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
    ``torch.func.jvp`` alike. Reverse mode is not provided."""

    @staticmethod
    def forward(u, v, nuH_e, nuH_n, beta, dx, dy):
        return ssa_matvec(u, v, nuH_e, nuH_n, beta, dx, dy)

    @staticmethod
    def setup_context(ctx, inputs, output):
        u, v, nuH_e, nuH_n, beta, dx, dy = inputs
        ctx.save_for_forward(u, v, nuH_e, nuH_n, beta)
        ctx.dx, ctx.dy = dx, dy

    @staticmethod
    def jvp(ctx, du, dv, dnuH_e, dnuH_n, dbeta, _ddx, _ddy):
        u, v, nuH_e, nuH_n, beta = ctx.saved_tensors
        z = lambda t, like: torch.zeros_like(like) if t is None else t
        return _SSAMatvecJVP.apply(u, v, z(du, u), z(dv, v), nuH_e, nuH_n,
                                   z(dnuH_e, nuH_e), z(dnuH_n, nuH_n), beta,
                                   dbeta, ctx.dx, ctx.dy)
