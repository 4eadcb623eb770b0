"""Batched tridiagonal solvers (port of ``pism_tpu/util/tridiag.py``).

- :func:`solve_batched_thomas`: forward sweep + back substitution, a host
  loop of 2n elementwise steps over whole batch planes.
- :func:`solve_batched_pcr`: parallel cyclic reduction, ceil(log2 n)
  full-tensor elimination rounds (the SSA line preconditioner's solver).

System per column: a[k] x[k-1] + b[k] x[k] + c[k] x[k+1] = d[k],
k = 0..n-1 (a[0] and c[n-1] ignored). Batch axes lead: (..., n).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def solve_batched_thomas(a, b, c, d):
    """Solve batched tridiagonal systems; all inputs (..., n)."""
    # system axis first so each step reads one contiguous batch plane
    am, bm, cm, dm = (x.movedim(-1, 0).contiguous() for x in (a, b, c, d))
    n = dm.shape[0]
    cps = torch.empty_like(dm)
    dps = torch.empty_like(dm)
    cp = torch.zeros_like(dm[0])
    dp = torch.zeros_like(dm[0])
    for k in range(n):
        ak = am[k] if k > 0 else torch.zeros_like(am[0])   # a[0] ignored
        ck = cm[k] if k < n - 1 else torch.zeros_like(cm[0])  # c[n-1] ignored
        denom = bm[k] - ak * cp
        cp = ck / denom
        dp = (dm[k] - ak * dp) / denom
        cps[k] = cp
        dps[k] = dp
    xs = torch.empty_like(dm)
    x = torch.zeros_like(dm[0])
    for k in range(n - 1, -1, -1):
        x = dps[k] - cps[k] * x
        xs[k] = x
    return xs.movedim(0, -1)


def _shift_z(x, s, fill=0.0):
    """x[..., k] -> x[..., k+s] with ``fill`` outside (s may be negative)."""
    n = x.shape[-1]
    if s >= n or -s >= n:
        return torch.full_like(x, fill)
    if s > 0:
        return F.pad(x[..., s:], (0, s), value=fill)
    if s < 0:
        return F.pad(x[..., :s], (-s, 0), value=fill)
    return x


def solve_batched_pcr(a, b, c, d):
    """Parallel cyclic reduction; same contract as the Thomas variant.

    Each round eliminates the sub/super-diagonals at distance s; after
    ceil(log2 n) rounds the system is diagonal. Out-of-range neighbors use
    b = 1, a = c = d = 0, which makes the eliminations no-ops at the ends.
    """
    a = a.clone()
    c = c.clone()
    a[..., 0] = 0.0
    c[..., -1] = 0.0
    n = a.shape[-1]
    s = 1
    rounds = math.ceil(math.log2(n)) if n > 1 else 0
    for _ in range(rounds):
        b_m = _shift_z(b, -s, 1.0)   # b[k-s]
        b_p = _shift_z(b, +s, 1.0)   # b[k+s]
        alpha = -a / b_m
        gamma = -c / b_p
        b = b + alpha * _shift_z(c, -s) + gamma * _shift_z(a, +s)
        d = d + alpha * _shift_z(d, -s) + gamma * _shift_z(d, +s)
        a = alpha * _shift_z(a, -s)
        c = gamma * _shift_z(c, +s)
        s *= 2
    return d / b


def solve_batched(a, b, c, d):
    """Batched solve for the column systems (energy): always Thomas. The
    JAX package switches to PCR only on the TPU for long, narrowly batched
    systems; the line preconditioner calls PCR directly, as there."""
    return solve_batched_thomas(a, b, c, d)
