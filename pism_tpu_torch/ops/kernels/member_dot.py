"""Per-member sums on an ensemble's member axis: the dot products of the
SSA's Krylov solver and PICO's basin sums, the hand-written CUDA kernel
and its plain versions.

``member_dot((a0, a1), (b0, b1))`` of pairs of (B, My, Mx) fields is the
(B,) tensor sum(a0 b0) + sum(a1 b1) over each member's cells: the dot
product of ``ops/ssa.py`` ``_dot`` for every member at once, as the JAX
package's BiCGStab (``pism_tpu/ops/ssa.py`` ``bicgstab_solve``) takes it
member by member under ``jax.vmap``. ``member_dots(x, y, which)`` gives
the dots of two pairs that ``which`` names among x.x, x.y and y.y, in one
launch that reads each field once, each equal to the bit to ``member_dot``
of its pair (the Krylov loop's r.r with rhat.r, and t.t with t.s).
``member_sum(x)`` is the (B,) sum of one field per member (PICO's basin
sums on the member axis).

The kernel, ``pism_tpu_torch/csrc/member_dot.cu``, adds each member's
values in an order fixed by its cell count alone, whatever the number of
members, so that a member's solve is the same in any batch; its notes say
why torch's own sum is not.

Routing: CUDA tensors launch the kernel (built by ``_build.py``); CPU
tensors run the plain versions. There is no fallback from one to the
other. ``LAUNCHES``, ``DOTS_LAUNCHES`` and ``SUM_LAUNCHES`` count the
launches of the three.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

LAUNCHES = 0
DOTS_LAUNCHES = 0
SUM_LAUNCHES = 0

F32, F64 = torch.float32, torch.float64
# form: (C entry point, fields read, results a member, sums kept a member,
# index for the chunk width)
_FORMS = {"member_dot": ("dot", 4, 1, 2, 0),
          "member_dots": ("dots", 4, 3, 6, 1),
          "member_sum": ("sum", 1, 1, 1, 2)}
_DOTS = ("xx", "xy", "yy")
_FN = {}       # (form, precision) -> the loaded C function
_CHUNK = {}    # form -> W, the cells of a chunk


def pairs(x, y, which=_DOTS):
    """The pairs of fields of the dots that ``which`` names among "xx"
    (x.x), "xy" (x.y) and "yy" (y.y), in that order."""
    named = {"xx": (x, x), "xy": (x, y), "yy": (y, y)}
    return [named[w] for w in _DOTS if w in which]


def member_dot_plain(a, b, dot_dtype=None):
    """sum(a0 b0) + sum(a1 b1) over the last two axes, per member; with
    ``dot_dtype`` the products and sums in that dtype."""
    if dot_dtype is not None:
        a = tuple(x.to(dot_dtype) for x in a)
        b = tuple(x.to(dot_dtype) for x in b)
    return (torch.sum(a[0] * b[0], dim=(-2, -1))
            + torch.sum(a[1] * b[1], dim=(-2, -1)))


def member_dots_plain(x, y, dot_dtype=None, which=_DOTS):
    """The dots ``which`` names among "xx", "xy", "yy", in that order:
    ``member_dot_plain`` of each pair."""
    return tuple(member_dot_plain(p, q, dot_dtype)
                 for p, q in pairs(x, y, which))


def member_sum_plain(x):
    """The sum of x over the last two axes, per member."""
    return torch.sum(x, dim=(-2, -1))


def build() -> None:
    """Compile and load the kernel library now (it is built at first use
    otherwise)."""
    if _FN:
        return
    lib = _build.library("member_dot")
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.pism_member_chunk_cells.argtypes = [i]
    lib.pism_member_chunk_cells.restype = i
    for name, (form, nf, nout, _, k) in _FORMS.items():
        _CHUNK[name] = lib.pism_member_chunk_cells(k)
        for prec in ("f32", "f64") + (("f32_f64",) if nf == 4 else ()):
            fn = getattr(lib, f"pism_member_{form}_{prec}")
            fn.argtypes = [p] * (nf + nout) + [q, i, p, p]
            fn.restype = i
            _FN[name, prec] = fn


def _check(name, fields, acc_dtype):
    """The device index of ``fields`` (-1 on the CPU): contiguous (B, My,
    Mx) float32 or float64 tensors of one shape, dtype and device (cpu or
    cuda), summed in ``acc_dtype`` (None, their dtype or float64); raises
    otherwise."""
    _build.check(name, *fields)
    t0 = fields[0]
    if t0.dim() != 3:
        raise ValueError(f"{name} takes (B, My, Mx) tensors, got "
                         f"{tuple(t0.shape)}")
    for t in fields:
        if t.shape != t0.shape:
            raise ValueError(f"{name} takes tensors of one shape, got "
                             f"{tuple(t.shape)} and {tuple(t0.shape)}")
    if not (acc_dtype is None or acc_dtype is t0.dtype or acc_dtype is F64):
        raise TypeError(f"{name} sums {t0.dtype} in {t0.dtype} or float64, "
                        f"not {acc_dtype}")
    return t0.get_device()


def _launch(name, fields, outs, index, acc) -> bool:
    """Launches form ``name`` on the checked CUDA ``fields`` of device
    ``index`` into ``outs`` ((B,) tensors of dtype ``acc``, or None for a
    sum not wanted); False if there was nothing to launch (the sums are
    0)."""
    build()
    B, My, Mx = fields[0].shape
    n = My * Mx
    if B * n == 0:
        for o in outs:
            if o is not None:
                o.zero_()
        return False
    if B > 65535:
        raise ValueError(f"{name} takes at most 65535 members, got {B}")
    # B tickets (0 between launches), then the (B, C, S) chunk sums
    work = _build.workspace(
        name, index, B, B + B * -(-n // _CHUNK[name]) * _FORMS[name][3])
    dtype = fields[0].dtype
    prec = "f64" if dtype is F64 else ("f32_f64" if acc is F64 else "f32")
    _build.launch(_FN[name, prec], name, index,
                  *[t.data_ptr() for t in fields],
                  *[None if o is None else o.data_ptr() for o in outs],
                  n, B, work.data_ptr())
    return True


def member_dot(a, b, dot_dtype=None):
    """The (B,) dot products of the pairs ``a`` = (a0, a1) and ``b`` = (b0,
    b1) of contiguous (B, My, Mx) tensors of one dtype; ``dot_dtype``
    float64 forms float32 fields' products and sums in float64.

    CUDA tensors launch the kernel; CPU tensors run ``member_dot_plain``."""
    global LAUNCHES
    fields = (a[0], b[0], a[1], b[1])
    index = _check("member_dot", fields, dot_dtype)
    if index < 0:
        return member_dot_plain(a, b, dot_dtype)
    acc = dot_dtype or a[0].dtype
    out = torch.empty(a[0].shape[0], dtype=acc, device=index)
    if _launch("member_dot", fields, (out,), index, acc):
        LAUNCHES += 1
    return out


def member_dots(x, y, dot_dtype=None, which=_DOTS):
    """The (B,) dot products that ``which`` names among "xx" (x.x), "xy"
    (x.y) and "yy" (y.y), returned in that order, of the pairs ``x`` = (x0,
    x1) and ``y`` = (y0, y1) of contiguous (B, My, Mx) tensors, in one
    launch that reads each field once; each equals ``member_dot`` of its
    pair to the bit. ``dot_dtype`` as for ``member_dot``.

    CUDA tensors launch the kernel; CPU tensors run ``member_dots_plain``."""
    global DOTS_LAUNCHES
    flags = ("xx" in which, "xy" in which, "yy" in which)
    if len(which) != flags.count(True):
        raise ValueError(f"member_dots takes distinct names of {_DOTS}, not "
                         f"{which}")
    fields = (x[0], x[1], y[0], y[1])
    index = _check("member_dots", fields, dot_dtype)
    if index < 0:
        return member_dots_plain(x, y, dot_dtype, which)
    acc = dot_dtype or x[0].dtype
    outs = [torch.empty(x[0].shape[0], dtype=acc, device=index) if f
            else None for f in flags]
    if _launch("member_dots", fields, outs, index, acc):
        DOTS_LAUNCHES += 1
    return tuple([o for o in outs if o is not None])


def member_sum(x):
    """The (B,) sums of a contiguous (B, My, Mx) field over each member's
    cells in an order that does not depend on B.

    CUDA tensors launch the kernel; CPU tensors run ``member_sum_plain``."""
    global SUM_LAUNCHES
    index = _check("member_sum", (x,), None)
    if index < 0:
        return member_sum_plain(x)
    out = torch.empty(x.shape[0], dtype=x.dtype, device=index)
    if _launch("member_sum", (x,), (out,), index, x.dtype):
        SUM_LAUNCHES += 1
    return out
