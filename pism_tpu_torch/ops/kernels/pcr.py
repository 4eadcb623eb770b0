"""Batched tridiagonal PCR line solves: the hand-written CUDA kernels and
their plain versions.

Replaces the TPU kernels ``pcr_fused_sub`` (``pism_tpu/ops/pallas_kernels.py:539``,
body ``_pcr_kernel_sub`` at ``:506``; the system on axis -2) and
``pcr_fused`` (``:482``, body ``_pcr_kernel`` at ``:435``; the system on the
last axis). The kernels, ``pism_tpu_torch/csrc/pcr.cu``, keep each line in
shared memory through all ceil(log2 n) elimination rounds, so a solve is one
launch and one pass over device memory where the plain version is some
twenty elementwise launches per round; the source's notes say what bounds
them. They round exactly as ``util.tridiag.solve_batched_pcr`` does.

The JAX package launches its kernel only for float32 on the TPU
(``pism_tpu/ops/ssa.py:230-232``). Here CUDA tensors of either float dtype
launch the kernel, because the arithmetic is the same in both.

Routing: a CUDA tensor launches the kernel (built by ``_build.py``); a CPU
tensor runs the plain torch version. There is no fallback from one to the
other. ``LAUNCHES`` counts launches of ``pcr_lines`` and ``SUB_LAUNCHES``
those of ``pcr_lines_sub``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from ...util.tridiag import solve_batched_pcr

LAUNCHES = 0
SUB_LAUNCHES = 0


# ---------------------------------------------------------------------------
# plain torch versions (CPU path, tests, and the reference on the card)
# ---------------------------------------------------------------------------

def pcr_lines_plain(a, b, c, d):
    """x with a[k] x[k-1] + b[k] x[k] + c[k] x[k+1] = d[k] along the last
    axis of (batch, n) tensors (a[..., 0] and c[..., -1] ignored)."""
    return solve_batched_pcr(a, b, c, d)


def pcr_lines_sub_plain(a, b, c, d):
    """The same solve along axis -2 of (n, batch) tensors."""
    return solve_batched_pcr(a.T, b.T, c.T, d.T).T


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.library("pcr")
    p, i = ctypes.c_void_p, ctypes.c_int
    for entry in ("lines", "lines_sub"):
        for prec in ("f32", "f64"):
            fn = getattr(lib, f"pism_pcr_{entry}_{prec}")
            fn.argtypes = [p] * 5 + [i, i, p]
            fn.restype = i
    return lib


def _check(entry, *tensors):
    _build.check(f"pcr_{entry}", *tensors)
    for t in tensors:
        if t.dim() != 2 or t.shape != tensors[0].shape:
            raise ValueError(f"pcr_{entry} takes 2D tensors of one shape, "
                             f"got {tuple(t.shape)} and {tuple(tensors[0].shape)}")


def _launch(entry, a, b, c, d, n, batch):
    x = torch.empty_like(d)
    prec = "f32" if d.dtype == torch.float32 else "f64"
    fn = getattr(_library(), f"pism_pcr_{entry}_{prec}")
    _build.launch(fn, f"pcr_{entry}", d.device, a.data_ptr(), b.data_ptr(),
                  c.data_ptr(), d.data_ptr(), x.data_ptr(), int(n), int(batch))
    return x


def pcr_lines(a, b, c, d):
    """Tridiagonal solve along the last axis of (batch, n) tensors.

    CUDA tensors launch the kernel; CPU tensors run ``pcr_lines_plain``."""
    _check("lines", a, b, c, d)
    if d.device.type == "cpu":
        return pcr_lines_plain(a, b, c, d)
    global LAUNCHES
    x = _launch("lines", a, b, c, d, d.shape[1], d.shape[0])
    LAUNCHES += 1
    return x


def pcr_lines_sub(a, b, c, d):
    """Tridiagonal solve along axis -2 of (n, batch) tensors, the lines
    strided by the batch width.

    CUDA tensors launch the kernel; CPU tensors run ``pcr_lines_sub_plain``."""
    _check("lines_sub", a, b, c, d)
    if d.device.type == "cpu":
        return pcr_lines_sub_plain(a, b, c, d)
    global SUB_LAUNCHES
    x = _launch("lines_sub", a, b, c, d, d.shape[0], d.shape[1])
    SUB_LAUNCHES += 1
    return x
