"""Bounded L-BFGS with a TAO-style convergence ladder (the port's own copy
of ``pism_tpu/inverse/lbfgs.py``, numpy on the host).

The reference drives its inversions through PETSc/TAO (``blmvm`` —
bound-constrained limited-memory variable metric; ``src/inverse/TaoUtil.hh``,
``pismi.py``) with absolute/relative/step convergence tests and per-iterate
reporting. The same algorithm:

- two-loop-recursion L-BFGS direction from the last ``m`` curvature pairs,
- gradient projection for simple bound constraints (iterates stay in
  ``[lower, upper]``; curvature pairs use the projected step),
- Armijo backtracking line search along the projected path,
- convergence ladder: ``gatol`` (absolute projected-gradient norm),
  ``grtol`` (projected-gradient norm relative to the first iterate),
  ``steptol`` (relative objective decrease), ``max_iterations``,
- an iterate log (J, |proj grad|, step) the caller can print or save —
  the TAO monitor role.

The iterate stays a float64 numpy array on the host; ``value_and_grad``
may hand back torch tensors (on any device), which the driver turns into
numpy. The arithmetic is the JAX package's, statement for statement, so on
a numpy objective the two drivers take the same iterates to the bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, List, NamedTuple, Optional

import numpy as np


def _host(x):
    """A tensor (any device) or an array as a float64 numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


class IterateRecord(NamedTuple):
    iteration: int
    J: float
    J_misfit: float          # caller-supplied breakdown (NaN if not split)
    J_regularization: float
    pgrad_norm: float
    step: float


class LBFGSResult(NamedTuple):
    x: np.ndarray
    J: float
    converged: bool
    reason: str
    log: List[IterateRecord]


@dataclass
class BoundedLBFGS:
    value_and_grad: Callable    # x -> (J, grad): numpy or torch values
    lower: Optional[np.ndarray] = None
    upper: Optional[np.ndarray] = None
    history: int = 10
    max_iterations: int = 100
    gatol: float = 0.0          # absolute |proj grad| tolerance
    grtol: float = 1.0e-6      # |proj grad| / |proj grad_0|
    steptol: float = 1.0e-12   # relative J decrease per iterate
    armijo_c1: float = 1.0e-4
    max_linesearch: int = 25
    monitor: Optional[Callable] = None   # called with each IterateRecord
    breakdown: Optional[Callable] = None  # x -> (J_misfit, J_reg) for the log
    #: Morozov discrepancy stop (reference inverse.target_misfit): stop once
    #: the misfit part of the objective falls below this value (requires
    #: ``breakdown``); None = off
    misfit_target: Optional[float] = None

    def _project(self, x):
        if self.lower is not None:
            x = np.maximum(x, self.lower)
        if self.upper is not None:
            x = np.minimum(x, self.upper)
        return x

    def _active(self, x, g):
        """Active set: bound binding AND the gradient pushing outward."""
        act = np.zeros(x.shape, bool)
        if self.lower is not None:
            act |= (x <= self.lower) & (g > 0)
        if self.upper is not None:
            act |= (x >= self.upper) & (g < 0)
        return act

    def _proj_grad(self, x, g):
        """Projected gradient: zero on the active set (TAO blmvm
        convergence measure)."""
        pg = g.copy()
        pg[self._active(x, g)] = 0.0
        return pg

    def run(self, x0) -> LBFGSResult:
        x = self._project(np.asarray(x0, dtype=np.float64).copy())
        shape = x.shape
        xf = x.ravel()

        def eval_at(xflat):
            J, g = self.value_and_grad(xflat.reshape(shape))
            return float(J), _host(g).ravel()

        J, g = eval_at(xf)
        pg = self._proj_grad(xf.reshape(shape), g.reshape(shape)).ravel()
        pg0_norm = float(np.linalg.norm(pg))
        log: List[IterateRecord] = []
        s_list: List[np.ndarray] = []
        y_list: List[np.ndarray] = []
        rho_list: List[float] = []
        step = 0.0
        reason = "max_iterations"
        converged = False

        for k in range(self.max_iterations + 1):
            pgn = float(np.linalg.norm(pg))
            mis, reg = (float("nan"), float("nan"))
            if self.breakdown is not None:
                mis, reg = (float(v) for v in self.breakdown(
                    xf.reshape(shape)))
            rec = IterateRecord(k, J, mis, reg, pgn, step)
            log.append(rec)
            if self.monitor is not None:
                self.monitor(rec)
            if self.misfit_target is not None and mis == mis \
                    and mis <= self.misfit_target:
                converged, reason = True, "target_misfit"
                break
            if pgn <= self.gatol:
                converged, reason = True, "gatol"
                break
            if pg0_norm > 0 and pgn <= self.grtol * pg0_norm:
                converged, reason = True, "grtol"
                break
            if k == self.max_iterations:
                break

            # two-loop recursion on the projected gradient
            q = pg.copy()
            alphas = []
            for s, y, rho in zip(reversed(s_list), reversed(y_list),
                                 reversed(rho_list)):
                a = rho * np.dot(s, q)
                alphas.append(a)
                q -= a * y
            if y_list:
                y_last, s_last = y_list[-1], s_list[-1]
                gamma = np.dot(s_last, y_last) / max(np.dot(y_last, y_last),
                                                     1e-300)
                q *= gamma
            for (s, y, rho), a in zip(zip(s_list, y_list, rho_list),
                                      reversed(alphas)):
                b = rho * np.dot(y, q)
                q += (a - b) * s
            direction = -q
            # stay on the active face: a quasi-Newton component that steps
            # back off an active bound is invisible to the projected
            # gradient but first-order harmful in the full objective
            direction[self._active(xf.reshape(shape), g.reshape(shape)
                                   ).ravel()] = 0.0
            if np.dot(direction, pg) > -1e-300:   # not a descent direction
                direction = -pg

            # Armijo backtracking along the projected path
            alpha = 1.0
            gTd = float(np.dot(pg, direction))
            accepted = False
            for _ in range(self.max_linesearch):
                x_new = self._project((xf + alpha * direction).reshape(shape)
                                      ).ravel()
                J_new, g_new = eval_at(x_new)
                # sufficient decrease against the actual (projected) step
                if J_new <= J + self.armijo_c1 * min(
                        gTd * alpha, float(np.dot(pg, x_new - xf))) \
                        and np.isfinite(J_new):
                    accepted = True
                    break
                alpha *= 0.5
            if not accepted:
                reason = "linesearch_failed"
                break

            s_vec = x_new - xf
            y_vec = g_new - g
            sy = float(np.dot(s_vec, y_vec))
            if sy > 1e-10 * np.linalg.norm(s_vec) * np.linalg.norm(y_vec):
                s_list.append(s_vec)
                y_list.append(y_vec)
                rho_list.append(1.0 / sy)
                if len(s_list) > self.history:
                    s_list.pop(0); y_list.pop(0); rho_list.pop(0)

            rel_dec = (J - J_new) / max(abs(J), 1e-300)
            step = float(alpha)
            xf, J, g = x_new, J_new, g_new
            pg = self._proj_grad(xf.reshape(shape), g.reshape(shape)).ravel()
            if 0 <= rel_dec <= self.steptol:
                converged, reason = True, "steptol"
                log.append(IterateRecord(k + 1, J, float("nan"),
                                         float("nan"),
                                         float(np.linalg.norm(pg)), step))
                break

        return LBFGSResult(x=xf.reshape(shape), J=J, converged=converged,
                           reason=reason, log=log)
