"""Fused thermomechanical SIA diffusivity and flux: the hand-written CUDA
kernel and its plain version.

Replaces the TPU kernel ``sia_flux_thermo_pallas_padded``
(``pism_tpu/ops/pallas_kernels.py:195``, body ``_sia_thermo_body`` at
``:80``, wrapper ``sia_flux_thermo_pallas`` at ``:176``): Mahaffy face
gradients, the Paterson-Budd (or GPBLD) softness of each level from the
enthalpy, the trapezoid K = int A (H - z)^(n+1) dz over levels clipped to
H, D = 2 (rho g)^n |grad s|^(n-1) K capped at ``d_cap``, and q = -D grad s,
in one pass. The kernel, ``pism_tpu_torch/csrc/sia_thermo.cu``, runs one
thread per cell for both of its faces; its notes say what bounds it.

An ensemble's members go in with a leading member axis (H, s ``(B, My,
Mx)``, E ``(B, My, Mx, Mz)``): one launch for all of them, with a ``(B,)``
max(D) from that launch, each member computed as a launch of it alone
computes it (the JAX package's ``pallas_call`` under ``vmap``).

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
import torch.nn.functional as F

from . import _build

LAUNCHES = 0
MEMBER_LAUNCHES = 0


def _constants(n, enhancement, rho, g, dx, dy, EC, pb_law, d_cap):
    """The kernel's constants (``pallas_kernels.py:229-234``), in the order
    of ``struct Params`` of the CUDA source."""
    return (float(n), 2.0 * (rho * g) ** n, float(dx), float(dy),
            EC.T_melting, EC.T_ref, EC.c_i, EC.L0, EC.beta, rho * g,
            pb_law.A_cold * enhancement, pb_law.A_warm * enhancement,
            pb_law.Q_cold, pb_law.Q_warm, pb_law.T_critical, pb_law.R,
            getattr(pb_law, "water_frac_coeff", 0.0),
            getattr(pb_law, "water_frac_observed_limit", 0.0),
            math.inf if d_cap is None else float(d_cap))


# ---------------------------------------------------------------------------
# plain torch version (CPU path, tests, and the reference on the card)
# ---------------------------------------------------------------------------

def _pad_edge2(a):
    """``a`` (..., My, Mx) with one edge-repeating ghost on each side of
    its last two dims."""
    My, Mx = a.shape[-2:]
    return F.pad(a.reshape(-1, 1, My, Mx), (1, 1, 1, 1),
                 mode="replicate").reshape(*a.shape[:-2], My + 2, Mx + 2)


def sia_flux_thermo_plain(H, s, E, z, *, n=3.0, enhancement=1.0, rho=910.0,
                          g=9.81, dx, dy, EC, pb_law, d_cap=None):
    """(qe, qn, De, Dn) on (My, Mx) from H, s (My, Mx), E (My, Mx, Mz) and
    the levels z (Mz,), in plain torch (any device); with a leading member
    axis on H, s, E and the results, each member on its own."""
    (_, C, _, _, T_melting, T_ref, c_i, L0, beta, rho_g, A_cold, A_warm,
     Q_cold, Q_warm, T_crit, R, wfc, wfl, cap) = _constants(
        n, enhancement, rho, g, dx, dy, EC, pb_law, d_cap)
    Hp, sp = _pad_edge2(H), _pad_edge2(s)
    Ep = _pad_edge2(E.movedim(-1, -3)).movedim(-3, -1)
    # (y, x) slices of the padded fields: the cell and its neighbours
    c = (..., slice(1, -1), slice(1, -1))
    e = (..., slice(1, -1), slice(2, None))
    nn = (..., slice(2, None), slice(1, -1))
    ne = (..., slice(2, None), slice(2, None))
    s_ = (..., slice(0, -2), slice(1, -1))
    se = (..., slice(0, -2), slice(2, None))
    w = (..., slice(1, -1), slice(0, -2))
    nw = (..., slice(2, None), slice(0, -2))

    def at3(k):   # the same slice of the padded enthalpy, all levels
        return Ep[(*k, slice(None))]

    H_e = 0.5 * (Hp[c] + Hp[e])
    H_n = 0.5 * (Hp[c] + Hp[nn])
    E_e = 0.5 * (at3(c) + at3(e))
    E_n = 0.5 * (at3(c) + at3(nn))
    sx_e = (sp[e] - sp[c]) / dx
    sy_e = (sp[nn] + sp[ne] - sp[s_] - sp[se]) / (4.0 * dy)
    sy_n = (sp[nn] - sp[c]) / dy
    sx_n = (sp[e] + sp[ne] - sp[w] - sp[nw]) / (4.0 * dx)

    def K_integral(E3, Hf):
        Hc = Hf[..., None]
        depth = torch.clamp(Hc - z, min=0.0)
        p = 101325.0 + rho_g * depth
        Tm = T_melting - beta * p
        Es = c_i * (Tm - T_ref)
        T = torch.where(E3 < Es, T_ref + E3 / c_i, Tm)
        T_pa = T - Tm + T_melting
        cold = T_pa < T_crit
        A = torch.where(cold, torch.full_like(T_pa, A_cold), A_warm)
        Q = torch.where(cold, torch.full_like(T_pa, Q_cold), Q_warm)
        soft = A * torch.exp(-Q / (R * T_pa))
        omega = torch.clamp(torch.clamp((E3 - Es) / L0, 0.0, 1.0), max=wfl)
        f = soft * (1.0 + wfc * omega) * depth ** (n + 1.0)
        zc = torch.minimum(z, Hc)
        return torch.sum(0.5 * (f[..., :-1] + f[..., 1:])
                         * (zc[..., 1:] - zc[..., :-1]), dim=-1)

    De = torch.clamp(C * (sx_e * sx_e + sy_e * sy_e) ** ((n - 1.0) / 2.0)
                     * K_integral(E_e, H_e), max=cap)
    Dn = torch.clamp(C * (sx_n * sx_n + sy_n * sy_n) ** ((n - 1.0) / 2.0)
                     * K_integral(E_n, H_n), max=cap)
    return -De * sx_e, -Dn * sy_n, De, Dn


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.library("sia_thermo")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for prec in ("f32", "f64"):
        fn = getattr(lib, f"pism_sia_flux_thermo_members_{prec}")
        fn.argtypes = [p] * 10 + [i, i, i, i, ll, ll, ll, ll,
                                  ctypes.POINTER(ctypes.c_double), p]
        fn.restype = i
    lib.pism_sia_thermo_nparams.restype = i
    return lib


def _check(H, s, E, z):
    _build.check("sia_flux_thermo", H, s, z, strided=(E,))
    if H.dim() not in (2, 3) or s.shape != H.shape \
            or E.dim() != H.dim() + 1 or E.shape[:-1] != H.shape \
            or z.shape != (E.shape[-1],):
        raise ValueError(
            f"sia_flux_thermo takes H, s ([B,] My, Mx), E ([B,] My, Mx, Mz) "
            f"and z (Mz,), got {tuple(H.shape)}, {tuple(s.shape)}, "
            f"{tuple(E.shape)}, {tuple(z.shape)}")


def _faces_max(De, Dn):
    """max(D) over both faces: 0-dim, or per member with a member axis."""
    if De.dim() == 2:
        return torch.maximum(torch.max(De), torch.max(Dn))
    return torch.maximum(torch.amax(De, dim=(-2, -1)),
                         torch.amax(Dn, dim=(-2, -1)))


def _launch(H, s, E, z, with_max, *, n=3.0, enhancement=1.0, rho=910.0,
            g=9.81, dx, dy, EC, pb_law, d_cap=None):
    """One launch on CUDA tensors, for every member of a leading member
    axis: (qe, qn, De, Dn, max_D), max_D None unless ``with_max``."""
    global LAUNCHES, MEMBER_LAUNCHES
    lib = _library()
    consts = _constants(n, enhancement, rho, g, dx, dy, EC, pb_law, d_cap)
    if len(consts) != lib.pism_sia_thermo_nparams():
        raise RuntimeError("sia_thermo.cu takes another set of constants")
    members = H.shape[0] if H.dim() == 3 else 0
    My, Mx = H.shape[-2:]
    strides = E.stride() if members else (0, *E.stride())
    qe, qn, De, Dn = (torch.empty_like(H) for _ in range(4))
    max_D, scratch = _build.max_out("sia_flux_thermo", H, with_max, members)
    fn = lib.pism_sia_flux_thermo_members_f32 if H.dtype == torch.float32 \
        else lib.pism_sia_flux_thermo_members_f64
    _build.launch(fn, "sia_flux_thermo", H.device, H.data_ptr(),
                  s.data_ptr(), E.data_ptr(), z.data_ptr(), qe.data_ptr(),
                  qn.data_ptr(), De.data_ptr(), Dn.data_ptr(), *scratch,
                  max(members, 1), My, Mx, E.shape[-1], *strides,
                  (ctypes.c_double * len(consts))(*consts))
    LAUNCHES += 1
    MEMBER_LAUNCHES += members > 0
    return qe, qn, De, Dn, max_D


def sia_flux_thermo_faces(H, s, E, z, **kw):
    """(qe, qn, De, Dn) on ([B,] My, Mx) from H, s ([B,] My, Mx,
    contiguous), E ([B,] My, Mx, Mz, any strides) and z (Mz,); keywords of
    :func:`sia_flux_thermo_plain`. CUDA tensors launch the kernel (without
    its max of D); CPU tensors run ``sia_flux_thermo_plain``."""
    _check(H, s, E, z)
    if H.device.type == "cpu":
        return sia_flux_thermo_plain(H, s, E, z, **kw)
    return _launch(H, s, E, z, False, **kw)[:4]


def sia_flux_thermo(H, s, E, z, **kw):
    """(De, Dn, qe, qn, max_D), the return of ``sia_flux_thermo_pallas``
    (same arguments as :func:`sia_flux_thermo_faces`; ``max_D`` 0-dim, or
    ``(B,)`` with a member axis). On CUDA tensors ``max_D`` comes from the
    kernel's own launch; on CPU tensors it is the larger of the two faces'
    maxima, as the JAX wrapper takes it."""
    _check(H, s, E, z)
    if H.device.type == "cpu":
        qe, qn, De, Dn = sia_flux_thermo_plain(H, s, E, z, **kw)
        return De, Dn, qe, qn, _faces_max(De, Dn)
    qe, qn, De, Dn, max_D = _launch(H, s, E, z, True, **kw)
    return De, Dn, qe, qn, max_D
