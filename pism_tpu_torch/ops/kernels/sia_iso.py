"""Fused isothermal SIA diffusivity and flux: the hand-written CUDA kernel
and its plain version.

Replaces the TPU kernel ``sia_flux_pallas_padded``
(``pism_tpu/ops/pallas_kernels.py:300``, body ``_sia_kernel`` at ``:38``,
wrapper ``sia_flux_pallas`` at ``:281``): Mahaffy face gradients,
D = gamma H^(n+2) |grad s|^(n-1) capped at ``d_cap`` with
gamma = 2 e A (rho g)^n / (n+2), and q = -D grad s on the east and north
faces, in one pass, with max(D) in the same launch. The kernel,
``pism_tpu_torch/csrc/sia_iso.cu``, runs a thread per few cells of one
column for both faces of each and reads H and s unpadded with clamped
indices; its notes say what bounds it.

An ensemble's members go in with a leading member axis (H, s ``(B, My,
Mx)``): one launch for all of them, with a ``(B,)`` max(D) from that
launch, each member computed as a launch of it alone computes it (the JAX
package's ``pallas_call`` under ``vmap``).

Routing: a CUDA tensor launches the kernel (built by ``_build.py``); a CPU
tensor runs the plain torch version. There is no fallback from one to the
other. ``LAUNCHES`` counts launches of the kernel, ``MEMBER_LAUNCHES``
those of them with a member axis.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build
from .sia_thermo import _faces_max, _pad_edge2

LAUNCHES = 0
MEMBER_LAUNCHES = 0


def gamma(A, n=3.0, enhancement=1.0, rho=910.0, g=9.81) -> float:
    """2 e A (rho g)^n / (n+2) in float64 (``pallas_kernels.py:290``)."""
    return 2.0 * enhancement * A * (rho * g) ** n / (n + 2.0)


def _constants(gamma_, n, dx, dy, d_cap):
    """The kernel's constants in the order of ``struct Params`` of the CUDA
    source."""
    return (float(gamma_), n + 2.0, (n - 1.0) / 2.0, float(dx), float(dy),
            4.0 * dx, 4.0 * dy, math.inf if d_cap is None else float(d_cap))


# ---------------------------------------------------------------------------
# plain torch version (CPU path, tests, and the reference on the card)
# ---------------------------------------------------------------------------

def sia_flux_plain(H, s, *, gamma, n=3.0, dx, dy, d_cap=None):
    """(qe, qn, De, Dn) on (My, Mx) from H and s (My, Mx): ``_sia_kernel``
    statement for statement on edge-padded copies, in plain torch (any
    device); with a leading member axis, each member on its own."""
    Hp, sp = _pad_edge2(H), _pad_edge2(s)
    c = (..., slice(1, -1), slice(1, -1))
    e = (..., slice(1, -1), slice(2, None))
    nn = (..., slice(2, None), slice(1, -1))
    ne = (..., slice(2, None), slice(2, None))
    s_ = (..., slice(0, -2), slice(1, -1))
    se = (..., slice(0, -2), slice(2, None))
    w = (..., slice(1, -1), slice(0, -2))
    nw = (..., slice(2, None), slice(0, -2))

    H_e = 0.5 * (Hp[c] + Hp[e])
    H_n = 0.5 * (Hp[c] + Hp[nn])

    sx_e = (sp[e] - sp[c]) / dx
    sy_e = (sp[nn] + sp[ne] - sp[s_] - sp[se]) / (4.0 * dy)
    sy_n = (sp[nn] - sp[c]) / dy
    sx_n = (sp[e] + sp[ne] - sp[w] - sp[nw]) / (4.0 * dx)

    slope2_e = sx_e * sx_e + sy_e * sy_e
    slope2_n = sx_n * sx_n + sy_n * sy_n

    De = gamma * H_e ** (n + 2.0) * slope2_e ** ((n - 1.0) / 2.0)
    Dn = gamma * H_n ** (n + 2.0) * slope2_n ** ((n - 1.0) / 2.0)
    cap = torch.tensor(math.inf if d_cap is None else float(d_cap),
                       dtype=De.dtype, device=De.device)
    De = torch.minimum(De, cap)
    Dn = torch.minimum(Dn, cap)
    return -De * sx_e, -Dn * sy_n, De, Dn


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.library("sia_iso")
    p, i = ctypes.c_void_p, ctypes.c_int
    for prec in ("f32", "f64"):
        fn = getattr(lib, f"pism_sia_flux_members_{prec}")
        fn.argtypes = [p] * 8 + [i, i, i, ctypes.POINTER(ctypes.c_double), p]
        fn.restype = i
    lib.pism_sia_iso_nparams.restype = i
    return lib


def _check(H, s):
    _build.check("sia_flux", H, s)
    if H.dim() not in (2, 3) or s.shape != H.shape:
        raise ValueError(f"sia_flux takes H and s of one ([B,] My, Mx) shape, "
                         f"got {tuple(H.shape)} and {tuple(s.shape)}")


def _launch(H, s, with_max, *, A, n=3.0, enhancement=1.0, rho=910.0,
            g=9.81, dx, dy, d_cap=None):
    """One launch on CUDA tensors, for every member of a leading member
    axis: (qe, qn, De, Dn, max_D), max_D None unless ``with_max``."""
    global LAUNCHES, MEMBER_LAUNCHES
    lib = _library()
    consts = _constants(gamma(A, n, enhancement, rho, g), n, dx, dy, d_cap)
    if len(consts) != lib.pism_sia_iso_nparams():
        raise RuntimeError("sia_iso.cu takes another set of constants")
    members = H.shape[0] if H.dim() == 3 else 0
    My, Mx = H.shape[-2:]
    qe, qn, De, Dn = (torch.empty_like(H) for _ in range(4))
    max_D, scratch = _build.max_out("sia_flux", H, with_max, members)
    fn = lib.pism_sia_flux_members_f32 if H.dtype == torch.float32 \
        else lib.pism_sia_flux_members_f64
    _build.launch(fn, "sia_flux", H.device, H.data_ptr(), s.data_ptr(),
                  qe.data_ptr(), qn.data_ptr(), De.data_ptr(),
                  Dn.data_ptr(), *scratch, max(members, 1), My, Mx,
                  (ctypes.c_double * len(consts))(*consts))
    LAUNCHES += 1
    MEMBER_LAUNCHES += members > 0
    return qe, qn, De, Dn, max_D


def _plain(H, s, *, A, n=3.0, enhancement=1.0, rho=910.0, g=9.81, dx, dy,
           d_cap=None):
    return sia_flux_plain(H, s, gamma=gamma(A, n, enhancement, rho, g), n=n,
                          dx=dx, dy=dy, d_cap=d_cap)


def sia_flux_faces(H, s, **kw):
    """(qe, qn, De, Dn) on ([B,] My, Mx) from H and s ([B,] My, Mx).
    Keywords: ``A``,
    the softness as a Python float (the caller rounds it to the field dtype
    first, as the JAX package does), ``n``, ``enhancement``, ``rho``,
    ``g``, ``dx``, ``dy``, ``d_cap``. CUDA tensors launch the kernel
    (without its max of D); CPU tensors run ``sia_flux_plain``."""
    _check(H, s)
    if H.device.type == "cpu":
        return _plain(H, s, **kw)
    return _launch(H, s, False, **kw)[:4]


def sia_flux(H, s, **kw):
    """(De, Dn, qe, qn, max_D), the return of ``sia_flux_pallas`` (same
    arguments as :func:`sia_flux_faces`; ``max_D`` 0-dim, or ``(B,)`` with
    a member axis). On CUDA tensors ``max_D`` comes from the kernel's own
    launch; on CPU tensors it is the larger of the two faces' maxima, as
    the JAX wrapper takes it."""
    _check(H, s)
    if H.device.type == "cpu":
        qe, qn, De, Dn = _plain(H, s, **kw)
        return De, Dn, qe, qn, _faces_max(De, Dn)
    qe, qn, De, Dn, max_D = _launch(H, s, True, **kw)
    return De, Dn, qe, qn, max_D
