"""Bilinear regridding of a 2D field between rectilinear grids (port of
``regrid_bilinear``, ``pism_tpu/native/__init__.py:124-162``, and its C++
twin ``pism_tpu/native/pism_native.cpp:72-120``).

Host numpy code, run when input files are read (bootstrapping, forcing,
``-regrid_file``): no device work. Target points outside the source extent
take the nearest edge value (both routes of the JAX package clamp), and
source values that are NaN or equal to ``fill`` are dropped by
renormalizing the weights of the remaining corners; a point whose four
corners are all missing gets ``fill``.
"""

from __future__ import annotations

import numpy as np


def regrid_bilinear(src, xs, ys, xt, yt, fill=np.nan) -> np.ndarray:
    """Bilinearly regrid ``src(ys, xs)`` (ascending coordinates) onto the
    ``(yt, xt)`` grid; returns a float64 ``(yt.size, xt.size)`` array."""
    src = np.asarray(src, np.float64)
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    xt = np.asarray(xt, np.float64)
    yt = np.asarray(yt, np.float64)
    # fractional source indices of the target points, clamped at the edges
    fy = np.clip(np.interp(yt, ys, np.arange(ys.size)), 0, ys.size - 1)
    fx = np.clip(np.interp(xt, xs, np.arange(xs.size)), 0, xs.size - 1)
    j0 = np.floor(fy).astype(int)
    i0 = np.floor(fx).astype(int)
    j1 = np.minimum(j0 + 1, ys.size - 1)
    i1 = np.minimum(i0 + 1, xs.size - 1)
    wy = (fy - j0)[:, None]
    wx = (fx - i0)[None, :]
    vals = [src[np.ix_(j0, i0)], src[np.ix_(j0, i1)],
            src[np.ix_(j1, i0)], src[np.ix_(j1, i1)]]
    wts = [(1 - wy) * (1 - wx), (1 - wy) * wx, wy * (1 - wx), wy * wx]
    acc = np.zeros((yt.size, xt.size))
    wsum = np.zeros_like(acc)
    for v, w in zip(vals, wts):
        valid = ~(np.isnan(v) | (v == fill))
        acc += np.where(valid, w * v, 0.0)
        wsum += np.where(valid, w, 0.0)
    with np.errstate(invalid="ignore"):
        return np.where(wsum > 0, acc / np.maximum(wsum, 1e-300), fill)
