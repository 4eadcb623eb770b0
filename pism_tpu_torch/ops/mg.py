"""Geometric multigrid V-cycle preconditioner for the SSA membrane operator
(port of ``pism_tpu/ops/mg.py``, the Jacobi smoother).

A classical geometric V-cycle on the Picard (frozen-coefficient) operator:

- coefficients: cell-centered viscosity restricted by 2x2 full weighting,
  re-averaged onto faces per level; drag (+ a large value on Dirichlet
  rows, which pins them) restricted the same way;
- smoother: damped Jacobi (weight 0.7), 2 pre + 2 post sweeps;
- transfer: full-weighting (2x2 mean) restriction, piecewise-constant
  prolongation;
- coarsest level (min dim <= 12, at most 5 levels): 10 damped-Jacobi
  sweeps.

Every operator application goes through ``ops/ssa.py`` ``apply_operator``:
on a CUDA tensor K1 on the clamped coarse levels, and the periodic route
(K5's padded-block instance on the wrap-padded field) on a periodic fine
level; on a CPU tensor their plain versions. A V-cycle over L levels is
5 (L - 1) + 10 operator launches, issued from the host with no host sync.
Used as the right preconditioner inside BiCGStab for both Picard sweeps
and Newton solves. The line smoother (``linemg``) is not ported (ROADMAP
Queue 1 item 11).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ssa as ssa_ops
from .stencils import shift

BIG = 1.0e30          # drag that pins the Dirichlet rows in the hierarchy
PRE = POST = 2        # Jacobi sweeps before and after the coarse correction
COARSE_SWEEPS = 10    # Jacobi sweeps on the coarsest level
MIN_SIZE = 12         # halve while the smaller side exceeds this
MAX_LEVELS = 5
OMEGA = 0.7           # Jacobi damping
CLAMPED = (False, False)


def _shifter(periodic):
    """The shift of a grid periodic along ``periodic`` = (y, x)."""
    return lambda a, jy, ix: shift(a, jy, ix, *periodic)


def _restrict(a):
    """2x2 full-weighting restriction with edge padding for odd dims."""
    My, Mx = a.shape
    if My % 2 or Mx % 2:
        a = F.pad(a[None, None], (0, Mx % 2, 0, My % 2),
                  mode="replicate")[0, 0]
    return 0.25 * (a[0::2, 0::2] + a[1::2, 0::2]
                   + a[0::2, 1::2] + a[1::2, 1::2])


def _prolong(a, shape):
    """Piecewise-constant prolongation (2x repeat, crop)."""
    b = a.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    return b[: shape[0], : shape[1]]


def build_levels(nuH, beta_eff, dx, dy, periodic):
    """Per-level coefficients from the fine-level faces.

    nuH: ``ssa_ops.NuH`` fine faces; beta_eff: drag + BIG on Dirichlet
    rows; ``periodic`` the fine grid's (y, x) periodic axes. Returns a
    list of dicts (finest first); the coarse levels are clamped."""
    sh = _shifter(periodic)
    nu_c = 0.25 * (nuH.e + sh(nuH.e, 0, -1) + nuH.n + sh(nuH.n, -1, 0))
    levels = [dict(nuH=nuH, beta=beta_eff, dx=dx, dy=dy, periodic=periodic,
                   shape=beta_eff.shape)]
    while min(levels[-1]["shape"]) > MIN_SIZE and len(levels) < MAX_LEVELS:
        nu_c = _restrict(nu_c)
        beta_eff = _restrict(beta_eff)
        dx, dy = 2.0 * dx, 2.0 * dy
        nuH_l = ssa_ops.NuH(e=0.5 * (nu_c + shift(nu_c, 0, 1)),
                            n=0.5 * (nu_c + shift(nu_c, 1, 0)))
        levels.append(dict(nuH=nuH_l, beta=beta_eff, dx=dx, dy=dy,
                           periodic=CLAMPED, shape=beta_eff.shape))
    for lv in levels:   # the Jacobi diagonal of each level, once
        du, dv = ssa_ops.operator_diagonal(lv["nuH"], lv["beta"], lv["dx"],
                                           lv["dy"], _shifter(lv["periodic"]))
        lv["diag"] = (torch.clamp(du, min=1e-30), torch.clamp(dv, min=1e-30))
    return levels


def _apply(lv, u, v):
    return ssa_ops.apply_operator(u, v, lv["nuH"], lv["beta"], lv["dx"],
                                  lv["dy"], lv["periodic"])


def _smooth(lv, x, b, sweeps):
    du, dv = lv["diag"]
    u, v = x
    for _ in range(sweeps):
        Au, Av = _apply(lv, u, v)
        u = u + OMEGA * (b[0] - Au) / du
        v = v + OMEGA * (b[1] - Av) / dv
    return (u, v)


def vcycle(levels, r, level=0):
    """One V(PRE, POST) cycle applied to the residual pair r = (ru, rv)."""
    lv = levels[level]
    zero = (torch.zeros_like(r[0]), torch.zeros_like(r[1]))
    if level == len(levels) - 1:
        return _smooth(lv, zero, r, COARSE_SWEEPS)
    x = _smooth(lv, zero, r, PRE)
    Au, Av = _apply(lv, x[0], x[1])
    res = (r[0] - Au, r[1] - Av)
    rc = (_restrict(res[0]), _restrict(res[1]))
    xc = vcycle(levels, rc, level + 1)
    x = (x[0] + _prolong(xc[0], lv["shape"]),
         x[1] + _prolong(xc[1], lv["shape"]))
    return _smooth(lv, x, r, POST)


def make_preconditioner(nuH, beta, bc_mask, dx, dy, periodic):
    """Right preconditioner r -> z for BiCGStab on the SSA system of a grid
    periodic along ``periodic`` = (y, x).

    Dirichlet rows are pinned with a huge drag in the hierarchy (their
    V-cycle output is ~0) and then restored to the identity (z = r), which
    matches the identity rows the solvers use for those cells."""
    levels = build_levels(nuH, torch.where(bc_mask, BIG, beta), dx, dy,
                          periodic)

    def precond(r):
        z = vcycle(levels, r)
        return (torch.where(bc_mask, r[0], z[0]),
                torch.where(bc_mask, r[1], z[1]))

    return precond
