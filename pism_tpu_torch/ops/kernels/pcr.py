"""Batched tridiagonal PCR line solves, factored once and applied to many
right-hand sides: the hand-written CUDA kernels and their plain versions.

Replaces the TPU kernels ``pcr_fused_sub`` (``pism_tpu/ops/pallas_kernels.py:539``,
body ``_pcr_kernel_sub`` at ``:506``; the system on axis -2) and
``pcr_fused`` (``:482``, body ``_pcr_kernel`` at ``:435``; the system on the
last axis). Of the elimination's four recurrences only the one of d depends
on the right-hand side, and the line preconditioner solves twenty to thirty
right-hand sides per set of coefficients. So the kernels,
``pism_tpu_torch/csrc/pcr.cu``, come in pairs:

- factor, ``pcr_factor_lines`` / ``pcr_factor_lines_sub``: (a, b, c) to a
  :class:`LineFactor` that holds alpha and gamma of every round and the
  last b (``b=None`` is the unit diagonal, never read from memory);
- apply, ``pcr_apply(factor, r, scale=None)``: x with the factored systems
  and d = r / scale, one launch that forms d, runs the d recurrence with d
  in registers and shared memory, and divides by the last b.

``pcr_lines(a, b, c, d)`` and ``pcr_lines_sub`` are the one-shot form, a
factor followed by an apply. All of them round exactly as
``util.tridiag.solve_batched_pcr`` does; the source's notes say what bounds
the kernels and how they are laid out.

The JAX package launches its kernel only for float32 on the TPU
(``pism_tpu/ops/ssa.py:230-232``). Here CUDA tensors of either float dtype
launch the kernels, because the arithmetic is the same in both.

On an ensemble's member axis the systems come as (B, batch, n) or (B, n,
batch) tensors, all members in one launch: on the last axis the members
fold into the batch (B batch lines, the kernels' own indexing), on axis -2
the ``*_sub_members`` entries take a member stride. Member b equals a
single launch on member b's systems to the bit.

Routing: CUDA tensors launch the kernels (built by ``_build.py``); CPU
tensors run the plain torch versions (``*_plain``). There is no fallback
from one to the other. ``LAUNCHES`` counts apply launches on the last axis
and ``SUB_LAUNCHES`` those on axis -2; ``FACTOR_LAUNCHES`` and
``SUB_FACTOR_LAUNCHES`` count the factor launches; the ``MEMBER_`` counts
(``MEMBER_LAUNCHES``, ``SUB_MEMBER_LAUNCHES``, ``MEMBER_FACTOR_LAUNCHES``,
``SUB_MEMBER_FACTOR_LAUNCHES``) the same launches on a member axis.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import _build
from ...util.tridiag import _shift_z, solve_batched_pcr

LAUNCHES = 0
SUB_LAUNCHES = 0
FACTOR_LAUNCHES = 0
SUB_FACTOR_LAUNCHES = 0
MEMBER_LAUNCHES = 0
SUB_MEMBER_LAUNCHES = 0
MEMBER_FACTOR_LAUNCHES = 0
SUB_MEMBER_FACTOR_LAUNCHES = 0


@dataclasses.dataclass(frozen=True)
class LineFactor:
    """Factored line systems of one shape, dtype and device.

    ``sub``: the systems run along axis -2 of (n, batch) tensors, else along
    the last axis of (batch, n) tensors; a leading member axis, (B, ...),
    holds an ensemble's members. A factor made by the kernel holds
    ``table``, (2 rounds + 1, [B,] batch, n): alpha and gamma of each round
    in turn, then the last b, line by line in both layouts; a plain one
    holds ``plain`` = (alpha, gamma, b), the rounds leading, with the system
    on the last axis."""
    sub: bool
    shape: tuple
    dtype: torch.dtype
    device: torch.device
    table: torch.Tensor | None = None
    plain: tuple | None = None

    @property
    def n(self) -> int:
        return self.shape[-2] if self.sub else self.shape[-1]

    @property
    def batch(self) -> int:
        return self.shape[-1] if self.sub else self.shape[-2]

    @property
    def members(self) -> int:
        """B on a member axis, else 0."""
        return self.shape[0] if len(self.shape) == 3 else 0

    def coefficients(self):
        """(alpha, gamma, b): alpha and gamma (rounds, \\*shape), the last b
        (\\*shape), in the layout of the tensors that were factored."""
        t = self.table
        parts = (t[0:-1:2], t[1:-1:2], t[-1]) if self.plain is None else self.plain
        return tuple(x.transpose(-1, -2) if self.sub else x for x in parts)


def _t(x):
    """The last two axes swapped (a 2D tensor's transpose)."""
    return x.transpose(-1, -2)


def _rounds(n: int) -> int:
    return math.ceil(math.log2(n)) if n > 1 else 0


# ---------------------------------------------------------------------------
# plain torch versions (CPU path, tests, and the reference on the card)
# ---------------------------------------------------------------------------

def pcr_lines_plain(a, b, c, d):
    """x with a[k] x[k-1] + b[k] x[k] + c[k] x[k+1] = d[k] along the last
    axis of (batch, n) tensors (a[..., 0] and c[..., -1] ignored)."""
    return solve_batched_pcr(a, b, c, d)


def pcr_lines_sub_plain(a, b, c, d):
    """The same solve along axis -2 of (n, batch) tensors."""
    return _t(solve_batched_pcr(_t(a), _t(b), _t(c), _t(d)))


def _factor_plain(a, b, c):
    """The a, b, c recurrences of ``solve_batched_pcr`` along the last
    axis: (alpha, gamma) of every round, stacked, and the last b."""
    a = a.clone()
    c = c.clone()
    a[..., 0] = 0.0
    c[..., -1] = 0.0
    b = torch.ones_like(a) if b is None else b
    alphas, gammas = [a.new_empty((0, *a.shape))], [a.new_empty((0, *a.shape))]
    s = 1
    for _ in range(_rounds(a.shape[-1])):
        alpha = -a / _shift_z(b, -s, 1.0)
        gamma = -c / _shift_z(b, +s, 1.0)
        b = b + alpha * _shift_z(c, -s) + gamma * _shift_z(a, +s)
        a = alpha * _shift_z(a, -s)
        c = gamma * _shift_z(c, +s)
        alphas.append(alpha[None])
        gammas.append(gamma[None])
        s *= 2
    return torch.cat(alphas), torch.cat(gammas), b


def pcr_factor_lines_plain(a, b, c) -> LineFactor:
    """Plain factor of ([B,] batch, n) systems on the last axis;
    ``b=None`` is the unit diagonal."""
    return LineFactor(False, tuple(a.shape), a.dtype, a.device,
                      plain=_factor_plain(a, b, c))


def pcr_factor_lines_sub_plain(a, b, c) -> LineFactor:
    """Plain factor of ([B,] n, batch) systems on axis -2."""
    return LineFactor(True, tuple(a.shape), a.dtype, a.device,
                      plain=_factor_plain(_t(a), None if b is None else _t(b),
                                          _t(c)))


def pcr_apply_plain(factor: LineFactor, r, scale=None):
    """x of the factored systems with d = r / scale (d = r without a
    scale): the d recurrence of ``solve_batched_pcr``, operation for
    operation."""
    alphas, gammas, b = factor.plain
    d = r if scale is None else r / scale
    if factor.sub:
        d = _t(d)
    s = 1
    for alpha, gamma in zip(alphas, gammas):
        d = d + alpha * _shift_z(d, -s) + gamma * _shift_z(d, +s)
        s *= 2
    x = d / b
    return _t(x).contiguous() if factor.sub else x


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.library("pcr")
    p, i = ctypes.c_void_p, ctypes.c_int
    for entry in ("lines", "lines_sub"):
        for prec in ("f32", "f64"):
            fn = getattr(lib, f"pism_pcr_factor_{entry}_{prec}")
            fn.argtypes = [p] * 4 + [i, i, p]
            fn.restype = i
            fn = getattr(lib, f"pism_pcr_apply_{entry}_{prec}")
            fn.argtypes = [p] * 4 + [i, i, p]
            fn.restype = i
            for kind in ("factor", "apply"):
                if entry == "lines_sub":
                    fn = getattr(lib, f"pism_pcr_{kind}_lines_sub_members_{prec}")
                    fn.argtypes = [p] * 4 + [i, i, i, p]
                    fn.restype = i
    return lib


def _check(entry, *tensors):
    """Raise unless the tensors are 2D, or 3D (a member axis), of one
    shape."""
    _build.check(f"pcr_{entry}", *tensors)
    for t in tensors:
        if t.dim() not in (2, 3) or t.shape != tensors[0].shape:
            raise ValueError(f"pcr_{entry} takes 2D (or, with a member axis, "
                             f"3D) tensors of one shape, got {tuple(t.shape)} "
                             f"and {tuple(tensors[0].shape)}")


def _entry(kind, sub, dtype, members):
    """(name, C function) of a launch: on axis -2 with members, the
    ``*_sub_members`` entry; on the last axis members fold into the batch."""
    prec = "f32" if dtype == torch.float32 else "f64"
    name = f"pcr_{kind}_lines_sub" if sub else f"pcr_{kind}_lines"
    c_name = name + ("_members" if sub and members else "")
    return name, getattr(_library(), f"pism_{c_name}_{prec}")


def _sizes(f: LineFactor, sub):
    """(n, batch, members) of a launch on ``f``'s systems; the last axis
    folds the members into the batch (line b batch + l of a (B batch, n)
    array)."""
    if f.members and not sub:
        return f.n, f.members * f.batch, 0
    return f.n, f.batch, f.members


def _factor(sub, a, b, c):
    global FACTOR_LAUNCHES, SUB_FACTOR_LAUNCHES
    global MEMBER_FACTOR_LAUNCHES, SUB_MEMBER_FACTOR_LAUNCHES
    given = (a, c) if b is None else (a, b, c)
    _check("factor_lines_sub" if sub else "factor_lines", *given)
    if a.device.type == "cpu":
        return (pcr_factor_lines_sub_plain if sub
                else pcr_factor_lines_plain)(a, b, c)
    f = LineFactor(sub, tuple(a.shape), a.dtype, a.device)
    lead = (f.members,) if f.members else ()
    table = torch.empty((2 * _rounds(f.n) + 1, *lead, f.batch, f.n),
                        dtype=a.dtype, device=a.device)
    name, fn = _entry("factor", sub, a.dtype, f.members)
    n, batch, members = _sizes(f, sub)
    _build.launch(fn, name, a.device, a.data_ptr(),
                  None if b is None else b.data_ptr(), c.data_ptr(),
                  table.data_ptr(), n, batch, *((members,) if members else ()))
    if f.members:
        if sub:
            SUB_MEMBER_FACTOR_LAUNCHES += 1
        else:
            MEMBER_FACTOR_LAUNCHES += 1
    elif sub:
        SUB_FACTOR_LAUNCHES += 1
    else:
        FACTOR_LAUNCHES += 1
    return dataclasses.replace(f, table=table)


def pcr_factor_lines(a, b, c) -> LineFactor:
    """Factor the tridiagonal systems along the last axis of ([B,] batch,
    n) tensors; ``b=None`` is the unit diagonal.

    CUDA tensors launch the kernel; CPU tensors run
    ``pcr_factor_lines_plain``."""
    return _factor(False, a, b, c)


def pcr_factor_lines_sub(a, b, c) -> LineFactor:
    """Factor the tridiagonal systems along axis -2 of ([B,] n, batch)
    tensors, the lines strided by the batch width.

    CUDA tensors launch the kernel; CPU tensors run
    ``pcr_factor_lines_sub_plain``."""
    return _factor(True, a, b, c)


def pcr_apply(factor: LineFactor, r, scale=None):
    """x of the factored systems for the right-hand side r / scale (r
    itself without a scale), in r's layout.

    A factor made on the card launches the apply kernel on CUDA tensors; a
    plain factor runs ``pcr_apply_plain`` on CPU tensors."""
    global LAUNCHES, SUB_LAUNCHES, MEMBER_LAUNCHES, SUB_MEMBER_LAUNCHES
    given = (r,) if scale is None else (r, scale)
    _check("apply", *given)
    if (tuple(r.shape), r.dtype, r.device) != (factor.shape, factor.dtype,
                                               factor.device):
        raise ValueError(
            f"pcr_apply: r is {tuple(r.shape)} {r.dtype} on {r.device}, the "
            f"factor {factor.shape} {factor.dtype} on {factor.device}")
    if r.device.type == "cpu":
        return pcr_apply_plain(factor, r, scale)
    if factor.table is None:
        raise ValueError("pcr_apply: a plain factor of CUDA tensors goes "
                         "through pcr_apply_plain")
    x = torch.empty_like(r)
    name, fn = _entry("apply", factor.sub, r.dtype, factor.members)
    n, batch, members = _sizes(factor, factor.sub)
    _build.launch(fn, name, r.device, factor.table.data_ptr(), r.data_ptr(),
                  None if scale is None else scale.data_ptr(), x.data_ptr(),
                  n, batch, *((members,) if members else ()))
    if factor.members:
        if factor.sub:
            SUB_MEMBER_LAUNCHES += 1
        else:
            MEMBER_LAUNCHES += 1
    elif factor.sub:
        SUB_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return x


def pcr_lines(a, b, c, d):
    """Tridiagonal solve along the last axis of (batch, n) tensors: a
    factor and an apply (their plain versions on CPU tensors)."""
    _check("lines", a, b, c, d)
    return pcr_apply(pcr_factor_lines(a, b, c), d)


def pcr_lines_sub(a, b, c, d):
    """Tridiagonal solve along axis -2 of (n, batch) tensors, the lines
    strided by the batch width: a factor and an apply (their plain versions
    on CPU tensors)."""
    _check("lines_sub", a, b, c, d)
    return pcr_apply(pcr_factor_lines_sub(a, b, c), d)
