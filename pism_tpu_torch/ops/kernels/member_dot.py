"""Per-member dot products of the SSA's Krylov solver on an ensemble's
member axis: the hand-written CUDA kernel and its plain version.

``member_dot((a0, a1), (b0, b1))`` of pairs of (B, My, Mx) fields is the
(B,) tensor sum(a0 b0) + sum(a1 b1) over each member's cells: the dot
product of ``ops/ssa.py`` ``_dot`` for every member at once, as the JAX
package's BiCGStab (``pism_tpu/ops/ssa.py`` ``bicgstab_solve``) takes it
member by member under ``jax.vmap``. The kernel,
``pism_tpu_torch/csrc/member_dot.cu``, adds each member's products in one
fixed order whatever the number of members, so that a member's solve is
the same in any batch; its notes say why torch's own sum is not.

``member_sum(x)`` is the (B,) sum of one field per member in the same
order (PICO's basin sums on the member axis).

Routing: CUDA tensors launch the kernel (built by ``_build.py``); CPU
tensors run ``member_dot_plain``. There is no fallback from one to the
other. ``LAUNCHES`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

LAUNCHES = 0


def member_dot_plain(a, b, dot_dtype=None):
    """sum(a0 b0) + sum(a1 b1) over the last two axes, per member; with
    ``dot_dtype`` the products and sums in that dtype."""
    if dot_dtype is not None:
        a = tuple(x.to(dot_dtype) for x in a)
        b = tuple(x.to(dot_dtype) for x in b)
    return (torch.sum(a[0] * b[0], dim=(-2, -1))
            + torch.sum(a[1] * b[1], dim=(-2, -1)))


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _build.library("member_dot")
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for prec in ("f32", "f64", "f32_f64"):
        fn = getattr(lib, f"pism_member_dot_{prec}")
        fn.argtypes = [p] * 5 + [q, i, p]
        fn.restype = i
    return lib


def build() -> None:
    """Compile and load the kernel library now (it is built at first use
    otherwise)."""
    _library()


def member_dot(a, b, dot_dtype=None):
    """The (B,) dot products of the pairs ``a`` = (a0, a1) and ``b`` = (b0,
    b1) of contiguous (B, My, Mx) tensors of one dtype; ``dot_dtype``
    float64 forms float32 fields' products and sums in float64.

    CUDA tensors launch the kernel; CPU tensors run ``member_dot_plain``."""
    ts = (a[0], b[0], a[1], b[1])
    _build.check("member_dot", *ts)
    for t in ts:
        if t.dim() != 3 or t.shape != ts[0].shape:
            raise ValueError(f"member_dot takes (B, My, Mx) tensors of one "
                             f"shape, got {tuple(t.shape)} and "
                             f"{tuple(ts[0].shape)}")
    if dot_dtype is not None and dot_dtype not in (ts[0].dtype, torch.float64):
        raise TypeError(f"member_dot sums {ts[0].dtype} in {ts[0].dtype} or "
                        f"float64, not {dot_dtype}")
    if ts[0].device.type == "cpu":
        return member_dot_plain(a, b, dot_dtype)
    global LAUNCHES
    out_dtype = dot_dtype or ts[0].dtype
    out = torch.empty(ts[0].shape[0], dtype=out_dtype, device=ts[0].device)
    prec = "f64" if ts[0].dtype == torch.float64 else (
        "f32_f64" if out_dtype == torch.float64 else "f32")
    fn = getattr(_library(), f"pism_member_dot_{prec}")
    _build.launch(fn, "member_dot", ts[0].device,
                  *[t.data_ptr() for t in ts], out.data_ptr(),
                  ts[0].shape[1] * ts[0].shape[2], ts[0].shape[0])
    LAUNCHES += 1
    return out


def member_sum(x):
    """The (B,) sums of a contiguous (B, My, Mx) field over each member's
    cells in ``member_dot``'s fixed order, so that a member's sum does not
    depend on B: half of ``member_dot((x, x), (1, 1))``, which is exact (the
    two halves are the same sum, and x * 1 is x). CPU tensors sum with
    torch."""
    ones = torch.ones_like(x)
    return 0.5 * member_dot((x, x), (ones, ones))
