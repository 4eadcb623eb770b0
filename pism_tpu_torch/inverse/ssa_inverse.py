"""Inverse problems for the SSA: basal yield stress and hardness inversions
(port of ``pism_tpu/inverse/ssa_inverse.py``; PISM's ``src/inverse/`` and
``pismi.py``).

The forward SSA solve is differentiable by the implicit function theorem:
``make_differentiable_solve`` is a ``torch.autograd.Function`` whose
forward is the regular Newton-Krylov solve and whose backward solves the
adjoint system J^T lambda = dJ/du with BiCGStab (Jacobi preconditioned),
the J^T matvec being the reverse mode of the residual at the solution. The
residual's operator is K1 (or, on a periodic grid, its padded-block
instance), reached through ``SSAMatvec`` (``SSAMatvecHalo``), so on the card
every J^T matvec launches the hand-written VJP kernel
(``csrc/ssa_matvec_vjp.cu``); the viscosity and the drag coefficient are
differentiated by autograd. The adjoint drives ``torch.autograd.grad``
with ``retain_graph`` on one graph of the residual (not ``torch.func``), so
the kernels' Functions see plain tensors.

Only float64 fields, no mesh and no member axis: the JAX package solves
float32 fields to full convergence through its ``mixed`` branch, which the
port does not carry (ROADMAP Queue 1 item 6); the inverse on a mesh and on
an ensemble's member axis are Queue 1 items 10 and 3.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import state as S
from ..config import Config
from ..ops import ssa as ssa_ops
from ..parallel.mesh import is_sharded
from .lbfgs import BoundedLBFGS
from .parameterizations import Parameterization

#: the differentiable solves' work: forward solves with their Newton sweeps
#: and Krylov iterations, adjoint solves with their BiCGStab iterations
COUNTS = dict.fromkeys(("forward_solves", "forward_newton", "forward_krylov",
                        "adjoint_solves", "adjoint_krylov"), 0)


def reset_counts():
    for k in COUNTS:
        COUNTS[k] = 0


class InversionResult(NamedTuple):
    tau_c: torch.Tensor       # the design variable (tau_c OR hardness B)
    u: torch.Tensor
    v: torch.Tensor
    misfits: torch.Tensor     # per-iteration J values


def refuse_unported(ssa, dtype):
    """Raise NotImplementedError for what the port's inverse does not take:
    float32 fields, a mesh, an ensemble's member axis."""
    if getattr(ssa, "lead", 0):
        raise NotImplementedError(
            "the SSA inversion on an ensemble's member axis is not "
            "implemented in pism_tpu_torch (ROADMAP Queue 1 item 3)")
    if is_sharded(getattr(ssa, "mesh", None)):
        raise NotImplementedError(
            "the SSA inversion under a mesh is not implemented in "
            "pism_tpu_torch (ROADMAP Queue 1 item 10)")
    if dtype != torch.float64:
        raise NotImplementedError(
            f"the SSA inversion of {dtype} fields (the full-convergence "
            "'mixed' solve) is not implemented in pism_tpu_torch (ROADMAP "
            "Queue 1 item 6); run it in float64")


def inverse_solver(ssa):
    """``ssa`` with the velocity-change stop off and ``newton_rtol`` at most
    1e-8: the implicit-function-theorem gradient is exact only at F(u*) =
    0, and the production stop leaves residuals far too loose for it."""
    cfg = Config.from_json(ssa.config.to_json())
    cfg.update({
        "stress_balance.ssa.fd.velocity_change_rtol": 0.0,
        "stress_balance.ssa.fd.newton_rtol": min(
            cfg.get_number("stress_balance.ssa.fd.newton_rtol"), 1.0e-8),
    })
    return dataclasses.replace(ssa, config=cfg)


class _Adjoint:
    """The forward solve and the adjoint of one design: ``design`` is
    "tau_c" (the yield stress) or "hardness" (B, with ``tau_c`` fixed)."""

    def __init__(self, ssa, state, design, tau_c):
        self.ssa, self.state = ssa, state
        self.by_hardness = design == "hardness"
        self.tau_c = tau_c

    def problem(self, dv):
        if self.by_hardness:
            return self.ssa.build_problem(self.state, self.tau_c, hardness=dv)
        return self.ssa.build_problem(self.state, dv)

    def forward(self, dv):
        if self.by_hardness:
            u, v, info = self.ssa.solve(self.state, self.tau_c, hardness=dv,
                                        diagnostics=True)
        else:
            u, v, info = self.ssa.solve(self.state, dv, diagnostics=True)
        COUNTS["forward_solves"] += 1
        COUNTS["forward_newton"] += info["newton_iters"]
        COUNTS["forward_krylov"] += info["krylov_iters"]
        return u, v

    def backward(self, dv, u, v, ubar, vbar):
        """-J_p^T lambda with J_uv^T lambda = (ubar, vbar) on the free rows
        (lambda on the Dirichlet rows)."""
        ssa = self.ssa
        P = self.problem(dv)
        free, full, bc = P["free"], P["full"], P["bc_mask"]
        uv = free((u, v))
        with torch.enable_grad():
            x = tuple(c.detach().requires_grad_() for c in uv)
            F = P["residual"](x)

        def JT_matvec(lam):
            gu, gv = torch.autograd.grad(F, x, grad_outputs=free(lam),
                                         retain_graph=True)
            return (gu + torch.where(bc, lam[0], 0.0),
                    gv + torch.where(bc, lam[1], 0.0))

        # Jacobi preconditioner from the frozen-coefficient diagonal
        nuH = P["make_nuH"](*full(uv))
        beta = P["beta_fn"](*full(uv))
        du, dv_ = ssa_ops.operator_diagonal(nuH, beta, ssa.grid.dx,
                                            ssa.grid.dy, ssa.sh)
        du = torch.where(bc, 1.0, torch.clamp(du, min=1e-12))
        dv_ = torch.where(bc, 1.0, torch.clamp(dv_, min=1e-12))

        rhs = free((ubar, vbar))
        zero = (torch.zeros_like(u), torch.zeros_like(v))
        lam, iters, _ = ssa_ops.bicgstab_solve(
            JT_matvec, rhs, zero, lambda r: (r[0] / du, r[1] / dv_),
            rtol=1e-8, max_iter=1000)
        COUNTS["adjoint_solves"] += 1
        COUNTS["adjoint_krylov"] += iters
        lam = free(lam)
        with torch.enable_grad():
            p = dv.detach().requires_grad_()
            (g,) = torch.autograd.grad(self.problem(p)["residual"](uv), p,
                                       grad_outputs=lam)
        return -g


class _DifferentiableSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, dv, adj):
        with torch.no_grad():
            u, v = adj.forward(dv)
        ctx.adj = adj
        ctx.save_for_backward(dv, u, v)
        return u, v

    @staticmethod
    def backward(ctx, ubar, vbar):
        dv, u, v = ctx.saved_tensors
        with torch.no_grad():
            return ctx.adj.backward(dv, u, v, ubar, vbar), None


def make_differentiable_solve(ssa, state: S.ModelState, design="tau_c",
                              tau_c=None):
    """Return fn(design_var) -> (u, v), differentiable in reverse mode with
    respect to the design variable: ``design = "tau_c"`` (basal yield
    stress, ``IP_SSATaucForwardProblem``) or ``"hardness"`` (vertically
    averaged hardness B with ``tau_c`` fixed, ``IP_SSAHardavForwardProblem``).

    Forward: the regular Newton-Krylov solve of ``inverse_solver(ssa)``.
    Backward: the adjoint BiCGStab (rtol 1e-8, at most 1000 iterations)
    with the reverse mode of the residual at the solution as its matvec."""
    refuse_unported(ssa, state.geometry.ice_thickness.dtype)
    adj = _Adjoint(inverse_solver(ssa), state, design, tau_c)
    return lambda dv: _DifferentiableSolve.apply(dv, adj)


def value_and_grad(fn, x):
    """(fn(x), d fn/dx) of a scalar function of a tensor, by autograd."""
    with torch.enable_grad():
        x = x.detach().requires_grad_()
        J = fn(x)
        (g,) = torch.autograd.grad(J, x)
    return J.detach(), g


def regularization_term(theta, kind: str, weight: float, eps: float = 1e-4,
                        prior=None, grad_scale: float = 1.0):
    """Design-variable regularization functionals (PISM
    ``src/inverse/functional/``): ``h1`` = |grad theta|^2 smoothing, ``l2``
    = |theta - prior|^2 damping, ``tv`` = eps-regularized total variation.
    The differences wrap around both axes, and carry the nondimensionalizing
    ``grad_scale`` = inverse.ssa.length_scale / dx."""
    if kind == "l2":
        d = theta if prior is None else theta - prior
        return 0.5 * weight * torch.sum(d ** 2)
    gx = (torch.roll(theta, -1, 1) - theta) * grad_scale
    gy = (torch.roll(theta, -1, 0) - theta) * grad_scale
    if kind == "h1":
        return 0.5 * weight * (torch.sum(gx ** 2) + torch.sum(gy ** 2))
    if kind == "tv":
        return weight * torch.sum(torch.sqrt(gx ** 2 + gy ** 2 + eps ** 2))
    raise ValueError(f"unknown regularization {kind!r} (h1 | l2 | tv)")


def _misfit(u, v, u_obs, v_obs, obs_mask, state):
    """Dimensionless velocity misfit: mean |u - u_obs|^2 over ``obs_mask``
    (by default the icy cells), normalized by the mean observed speed^2."""
    w = (obs_mask if obs_mask is not None
         else S.icy(state.geometry.cell_type)).to(u.dtype)
    du = (u - u_obs) * w
    dv = (v - v_obs) * w
    n = torch.clamp(torch.sum(w), min=1.0)
    obs2 = (torch.sum(u_obs ** 2 * w) + torch.sum(v_obs ** 2 * w)) / n
    J_mis = 0.5 * (torch.sum(du ** 2) + torch.sum(dv ** 2)) / n
    return J_mis / torch.clamp(obs2, min=1e-30)


class Adam:
    """optax.adam(learning_rate) with its defaults (b1 0.9, b2 0.999, eps
    1e-8, bias-corrected), in optax's order of operations."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps

    def init(self, params):
        return 0, torch.zeros_like(params), torch.zeros_like(params)

    def update(self, g, state):
        count, mu, nu = state
        mu = (1 - self.b1) * g + self.b1 * mu
        nu = (1 - self.b2) * g ** 2 + self.b2 * nu
        count += 1
        mu_hat = mu / (1 - self.b1 ** count)
        nu_hat = nu / (1 - self.b2 ** count)
        return (mu_hat / (torch.sqrt(nu_hat) + self.eps) * -self.lr,
                (count, mu, nu))


def _adam(objective, theta, iterations, learning_rate):
    """Adam on the design variable: the best evaluated iterate (the raw last
    step can overshoot into the plastic dead zone, where gradients vanish)
    and every J."""
    opt = Adam(learning_rate)
    opt_state = opt.init(theta)
    misfits = []
    best = (float("inf"), theta)
    for _ in range(iterations):
        J, g = value_and_grad(objective, theta)
        misfits.append(float(J))
        if misfits[-1] < best[0]:
            best = (misfits[-1], theta)
        updates, opt_state = opt.update(g, opt_state)
        theta = theta + updates
    return best[1], torch.tensor(misfits, dtype=torch.float64)


@dataclass
class TaucInversion:
    """Gradient-based tau_c inversion from observed velocities (PISM
    ``pismi.py -inv_method tikhonov_*`` analog)."""

    ssa: object
    state: S.ModelState
    u_obs: torch.Tensor
    v_obs: torch.Tensor
    obs_mask: Optional[torch.Tensor] = None   # where observations count
    reg_weight: float = 1.0e-10
    reg_kind: str = "h1"                      # h1 | l2 | tv
    theta_prior: Optional[torch.Tensor] = None
    param: Parameterization = Parameterization(kind="exp", scale=1.0)
    misfit_weight: float = 1.0     # inverse.ssa.velocity_misfit_weight
    grad_scale: float = 1.0        # inverse.ssa.length_scale / dx
    tv_eps: float = 1e-4           # inverse.design.tv_epsilon

    def __post_init__(self):
        self._solve = make_differentiable_solve(self.ssa, self.state)

    def misfit(self, tau_c):
        u, v = self._solve(tau_c)
        return self.misfit_weight * _misfit(u, v, self.u_obs, self.v_obs,
                                            self.obs_mask, self.state)

    def regularization(self, theta):
        return regularization_term(theta, self.reg_kind, self.reg_weight,
                                   prior=self.theta_prior, eps=self.tv_eps,
                                   grad_scale=self.grad_scale)

    def objective(self, theta):
        """theta = design variable; tau_c = param.value(theta)."""
        return self.misfit(self.param.value(theta)) + \
            self.regularization(theta)

    def run_lbfgs(self, tau_c0, max_iterations: int = 50,
                  tauc_min: float = 1.0, tauc_max: float = 5.0e6,
                  grtol: float = 1.0e-5, steptol: float = 1.0e-12,
                  monitor=None, misfit_target=None):
        """Bounded L-BFGS (TAO ``blmvm``'s role): the bounds mapped into
        design space, the convergence ladder, the per-iterate log. The
        iterate lives on the host in float64; each evaluation moves it to
        the fields' device."""
        theta0 = self.param.design(torch.clamp(tau_c0, min=tauc_min))
        like = dict(dtype=theta0.dtype, device=theta0.device)
        lo = float(self.param.design(tauc_min))
        hi = float(self.param.design(tauc_max))

        def on_device(x):
            return torch.as_tensor(x, **like)

        def split(x):
            with torch.no_grad():
                theta = on_device(x)
                return (self.misfit(self.param.value(theta)),
                        self.regularization(theta))

        opt = BoundedLBFGS(
            value_and_grad=lambda x: value_and_grad(self.objective,
                                                    on_device(x)),
            lower=np.full(theta0.shape, lo), upper=np.full(theta0.shape, hi),
            max_iterations=max_iterations, grtol=grtol, steptol=steptol,
            monitor=monitor, misfit_target=misfit_target, breakdown=split)
        res = opt.run(theta0.cpu().numpy())
        tau_c = self.param.value(on_device(res.x))
        u, v = self.ssa.solve(self.state, tau_c)
        return InversionResult(
            tau_c=tau_c, u=u, v=v,
            misfits=torch.tensor([r.J for r in res.log],
                                 dtype=torch.float64)), res

    def run(self, tau_c0, iterations: int = 30, learning_rate: float = 0.3):
        """Adam on the design variable."""
        theta, misfits = _adam(self.objective,
                               self.param.design(torch.clamp(tau_c0, min=1.0)),
                               iterations, learning_rate)
        tau_c = self.param.value(theta)
        u, v = self.ssa.solve(self.state, tau_c)
        return InversionResult(tau_c=tau_c, u=u, v=v, misfits=misfits)


@dataclass
class HardnessInversion:
    """Gradient-based inversion of the vertically averaged hardness B from
    observed velocities (PISM ``IP_SSAHardavForwardProblem`` analog), the
    design variable over floating ice, where basal drag vanishes."""

    ssa: object
    state: S.ModelState
    u_obs: torch.Tensor
    v_obs: torch.Tensor
    tau_c: Optional[torch.Tensor] = None      # held fixed
    obs_mask: Optional[torch.Tensor] = None
    reg_weight: float = 1.0e-10
    reg_kind: str = "h1"                      # h1 | l2 | tv
    theta_prior: Optional[torch.Tensor] = None
    param: Parameterization = Parameterization(kind="exp", scale=1.0)

    def __post_init__(self):
        self._solve = make_differentiable_solve(
            self.ssa, self.state, design="hardness", tau_c=self.tau_c)

    def misfit(self, hardness):
        u, v = self._solve(hardness)
        return _misfit(u, v, self.u_obs, self.v_obs, self.obs_mask,
                       self.state)

    def objective(self, theta):
        return self.misfit(self.param.value(theta)) + regularization_term(
            theta, self.reg_kind, self.reg_weight, prior=self.theta_prior)

    def run(self, hardness0, iterations: int = 30,
            learning_rate: float = 0.1):
        """Adam on the design variable."""
        theta, misfits = _adam(
            self.objective,
            self.param.design(torch.clamp(hardness0, min=1.0)), iterations,
            learning_rate)
        B = self.param.value(theta)
        u, v = self.ssa.solve(self.state, self.tau_c, hardness=B)
        return InversionResult(tau_c=B, u=u, v=v, misfits=misfits)
