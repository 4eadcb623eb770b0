"""Shelfy-stream approximation (SSA): matrix-free operator and solvers
(port of ``pism_tpu/ops/ssa.py``).

Continuous problem (velocities u, v; vertically integrated):
    d/dx(2 nuH (2 u_x + v_y)) + d/dy(nuH (u_y + v_x)) - beta u = rho g H s_x
    d/dy(2 nuH (2 v_y + u_x)) + d/dx(nuH (u_y + v_x)) - beta v = rho g H s_y
nu = (B/2) (eps_eff^2)^((1-n)/(2n)),
eps_eff^2 = u_x^2 + v_y^2 + u_x v_y + (1/4)(u_y + v_x)^2 + eps_reg^2.

The operator itself is the hand-written kernel of
``ops/kernels/ssa_matvec.py``: K1 on the whole field, or, on a periodic
grid, the kernel's padded-block instance (K5's, ``ssa_matvec_halo``) on
the field wrap-padded along its periodic axes, one launch (the JAX package
sends periodic grids through its plain operator instead,
``pism_tpu/model/ssa.py:453-464``); with ``line_pcr_impl = pallas_sublane`` the
line preconditioner solves with the kernels of ``ops/kernels/pcr.py``. The
Krylov loop is a host loop: its stop
test is one ``.item()`` per BiCGStab iteration (the JAX package's
``lax.while_loop`` at ``pism_tpu/ops/ssa.py:349-374``), which keeps the
iteration counts identical to the reference.

On an ensemble's member axis (fields ``(B, My, Mx)``, a ``Shifter`` with
``lead = 1``) the operator, the Newton matvec and the line solves launch
once for all members, the dot products are per member
(``ops/kernels/member_dot.py``, the dots that share a point of the loop in
one launch) and ``bicgstab_solve`` runs every member's iteration in
lockstep, the ``vmap`` of the JAX loop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from . import stencils as st
from .kernels.member_dot import member_dot, member_dots, pairs
from .kernels.pcr import pcr_apply, pcr_factor_lines, pcr_factor_lines_sub
from .kernels import ssa_matvec as K
from ..util.hostsync import host
from ..util.tridiag import solve_batched_pcr
from ..util.units import SEC_PER_YEAR


class NuH(NamedTuple):
    e: torch.Tensor   # nuH on east faces [Pa s m]
    n: torch.Tensor   # nuH on north faces


def _face_strain_rates(u, v, dx, dy, sh):
    """(u_x, v_y, u_y, v_x) on east faces and on north faces [1/s]."""
    east = (st.grad_x_east(u, dx, sh), st.grad_y_east(v, dy, sh),
            st.grad_y_east(u, dy, sh), st.grad_x_east(v, dx, sh))
    north = (st.grad_x_north(u, dx, sh), st.grad_y_north(v, dy, sh),
             st.grad_y_north(u, dy, sh), st.grad_x_north(v, dx, sh))
    return east, north


def _nuH(u, v, hardness_B, H, dx, dy, sh, n_glen, eps_reg2, extension_nuH,
         extension_mask, tangent_coefficients):
    SPY = SEC_PER_YEAR
    q = (1.0 - n_glen) / (2.0 * n_glen)
    rescale = SPY ** ((n_glen - 1.0) / n_glen)
    reg2_a = eps_reg2 * SPY * SPY

    def face_nuH(rates, B_f, H_f):
        # strain rates arrive in 1/s; convert to 1/year
        ux, vy, uy, vx = (g * SPY for g in rates)
        eps2 = ux ** 2 + vy ** 2 + ux * vy + 0.25 * (uy + vx) ** 2 + reg2_a
        nuH = 0.5 * B_f * eps2 ** q * rescale * H_f
        if not tangent_coefficients:
            return nuH, None
        # d nuH = k c (deps2/dux dux + deps2/dvy dvy + deps2/duy (duy + dvx))
        # with c = q eps2^(q-1) (the 1/year scaling of the tangents folded
        # in) and k = B/2 rescale H. The two factors are kept apart, as the
        # chain rule orders them, so that float32 stays in range: their
        # product alone reaches ~1e35 where eps2 sits at its floor.
        c = q * eps2 ** (q - 1.0) * SPY
        k = 0.5 * B_f * rescale * H_f
        return nuH, (c * (2.0 * ux + vy), c * (2.0 * vy + ux),
                     c * (0.5 * (uy + vx)), k)

    east, north = _face_strain_rates(u, v, dx, dy, sh)
    nuH_e, c_e = face_nuH(east, st.avg_to_east(hardness_B, sh),
                          st.avg_to_east(H, sh))
    nuH_n, c_n = face_nuH(north, st.avg_to_north(hardness_B, sh),
                          st.avg_to_north(H, sh))
    if extension_nuH is not None:
        m = extension_mask.to(u.dtype)
        ext_e = st.avg_to_east(m, sh) > 0.49
        ext_n = st.avg_to_north(m, sh) > 0.49
        nuH_e = torch.where(ext_e, extension_nuH, nuH_e)
        nuH_n = torch.where(ext_n, extension_nuH, nuH_n)
        if tangent_coefficients:
            c_e = c_e[:3] + (torch.where(ext_e, 0.0, c_e[3]),)
            c_n = c_n[:3] + (torch.where(ext_n, 0.0, c_n[3]),)
    return NuH(e=nuH_e, n=nuH_n), (c_e, c_n)


def compute_nuH(u, v, hardness_B, H, dx, dy, sh, *, n_glen=3.0,
                eps_reg2=1e-31, extension_nuH=None,
                extension_mask=None) -> NuH:
    """Staggered effective viscosity times thickness.

    hardness_B, H: cell-centered vertically averaged hardness and thickness.
    eps_reg2: Schoof regularization (strain-rate)^2 floor, in (1/s)^2.
    extension_nuH / extension_mask: where the mask is set, the strength
    extension constant replaces nuH (PISM ``SSAStrengthExtension``).

    Strain rates are taken in 1/year: SI strain-rate squares (~1e-27)
    raised to negative fractional powers overflow float32 (and their
    forward-mode tangents overflow harder); per-year magnitudes (~1e-5)
    keep the value and its JVP in range. SPY^((n-1)/n) restores SI nuH.
    """
    return _nuH(u, v, hardness_B, H, dx, dy, sh, n_glen, eps_reg2,
                extension_nuH, extension_mask, False)[0]


@dataclass(frozen=True)
class NuHTangent:
    """The forward-mode derivative of nuH at a point: per face a fixed
    linear combination of the face strain rates of the direction,
    d nuH = ((a1 dux + a2 dvy) + a3 (duy + dvx)) k, with the coefficient
    planes ``e`` = (a1, a2, a3, k) on east faces and ``n`` on north faces.
    Called with (du, dv) it returns the NuH of d nuH."""
    e: tuple
    n: tuple
    dx: float
    dy: float
    sh: object

    def __call__(self, du, dv):
        east, north = _face_strain_rates(du, dv, self.dx, self.dy, self.sh)
        out = []
        for (dux, dvy, duy, dvx), (a1, a2, a3, k) in ((east, self.e),
                                                      (north, self.n)):
            out.append((a1 * dux + a2 * dvy + a3 * (duy + dvx)) * k)
        return NuH(e=out[0], n=out[1])


def linearize_nuH(u, v, hardness_B, H, dx, dy, sh, *, n_glen=3.0,
                  eps_reg2=1e-31, extension_nuH=None, extension_mask=None):
    """``compute_nuH`` at (u, v) and its forward-mode derivative.

    Returns ``(nuH, tangent)`` where ``tangent`` is a :class:`NuHTangent`
    whose coefficient planes are evaluated once here; ``tangent(du, dv)``
    is what ``torch.func.jvp(compute_nuH, (u, v), (du, dv))`` returns,
    without re-evaluating the primal at every call (the JAX package hoists
    the primal the same way with ``jax.linearize``). The Newton matvec
    kernel takes the planes themselves (``ops/kernels/ssa_matvec.py``)."""
    nuH, (c_e, c_n) = _nuH(u, v, hardness_B, H, dx, dy, sh, n_glen,
                           eps_reg2, extension_nuH, extension_mask, True)
    return nuH, NuHTangent(c_e, c_n, dx, dy, sh)


def apply_operator(u, v, nuH: NuH, beta, dx, dy, periodic=(False, False)):
    """A(u, v) = -div T + beta (u, v) through the matvec kernel (its plain
    torch version on CPU tensors); ``periodic`` (y, x): the grid's
    periodic axes, which take the wrap-padded route."""
    if periodic[0] or periodic[1]:
        return ssa_matvec_periodic(u, v, nuH.e, nuH.n, beta, dx, dy, periodic)
    return K.ssa_matvec(u, v, nuH.e, nuH.n, beta, dx, dy)


# ---------------------------------------------------------------------------
# the kernels on a periodic grid: one padded block
# ---------------------------------------------------------------------------

def ssa_matvec_periodic(u, v, nuH_e, nuH_n, beta, dx, dy, periodic):
    """K1 on a grid periodic along ``periodic`` = (y, x): the padded-block
    kernel ``ssa_matvec_halo`` launched once on the whole field, with two
    ghosts of u, v and one of nuH that wrap around a periodic axis and
    repeat the edge on the other, and the edge flags set only on the
    closed axes. The ghosts give the west (south) faces of the first
    column (row) the values of the faces across the wrap, which is what
    the periodic stencil computes."""
    py, px = periodic
    return K.ssa_matvec_halo(
        not px, not py, st.pad_ghosts(u, 2, py, px), st.pad_ghosts(v, 2, py, px),
        st.pad_ghosts(nuH_e, 1, py, px), st.pad_ghosts(nuH_n, 1, py, px),
        beta.contiguous(), dx, dy)


def ssa_newton_matvec_periodic(u, v, nuH_e, nuH_n, coef_e, coef_n, beta,
                               bc_mask, dx, dy, periodic):
    """``matvec(du, dv)``: the Newton matvec of a sweep linearized at (u, v)
    on a periodic grid, one launch of ``ssa_newton_matvec_halo`` on the
    whole field. The sweep's fields are padded here, once (u, v and the
    mask two ghosts, nuH and the coefficient planes one); a call pads only
    the direction."""
    py, px = periodic

    def pad(a, g):
        return st.pad_ghosts(a, g, py, px)

    frozen = (pad(u, 2), pad(v, 2), pad(nuH_e, 1), pad(nuH_n, 1),
              pad(coef_e, 1), pad(coef_n, 1), beta.contiguous(),
              pad(bc_mask, 2))

    def matvec(du, dv):
        up, vp, ne, nn, ce, cn, b, bcp = frozen
        return K.ssa_newton_matvec_halo(not px, not py, up, vp, pad(du, 2),
                                        pad(dv, 2), ne, nn, ce, cn, b, bcp,
                                        dx, dy)

    return matvec


def _minus_div_stencil(u, v, nuH: NuH, dx, dy, sh):
    """-div T in the JAX package's stencil form (``pism_tpu/ops/ssa.py``
    ``apply_operator``), statement for statement, with ``sh``'s ghosts."""
    Txx_e = 2.0 * nuH.e * (2.0 * st.grad_x_east(u, dx, sh)
                           + st.grad_y_east(v, dy, sh))
    Txy_n = nuH.n * (st.grad_y_north(u, dy, sh) + st.grad_x_north(v, dx, sh))
    div_x = st.div_staggered(Txx_e, Txy_n, dx, dy, sh)
    Tyy_n = 2.0 * nuH.n * (2.0 * st.grad_y_north(v, dy, sh)
                           + st.grad_x_north(u, dx, sh))
    Txy_e = nuH.e * (st.grad_y_east(u, dy, sh) + st.grad_x_east(v, dx, sh))
    div_y = st.div_staggered(Txy_e, Tyy_n, dx, dy, sh)
    return -div_x, -div_y


def apply_operator_stencil(u, v, nuH: NuH, beta, dx, dy, sh):
    """The operator in plain torch stencils on any grid (the periodic
    route's reference)."""
    mx, my = _minus_div_stencil(u, v, nuH, dx, dy, sh)
    return mx + beta * u, my + beta * v


def newton_matvec_stencil(u, v, du, dv, nuH: NuH, tangent, beta, bc_mask,
                          dx, dy, sh):
    """The Newton matvec in plain torch stencils (the periodic route's
    reference): the direction freed on ``bc_mask``, dnuH =
    ``tangent``(free direction) (a :class:`NuHTangent`), A(free d; nuH,
    beta) + A(u; dnuH, 0) on the free rows and d on the Dirichlet rows."""
    fu = torch.where(bc_mask, 0.0, du)
    fv = torch.where(bc_mask, 0.0, dv)
    t1u, t1v = apply_operator_stencil(fu, fv, nuH, beta, dx, dy, sh)
    mx, my = _minus_div_stencil(u, v, tangent(fu, fv), dx, dy, sh)
    return (torch.where(bc_mask, du, t1u + mx),
            torch.where(bc_mask, dv, t1v + my))


def operator_diagonal(nuH: NuH, beta, dx, dy, sh):
    """Diagonal (u and v own-coefficients) of the operator."""
    nuH_w = sh(nuH.e, 0, -1)
    nuH_s = sh(nuH.n, -1, 0)
    diag_u = (4.0 * (nuH.e + nuH_w) / dx ** 2
              + (nuH.n + nuH_s) / dy ** 2 + beta)
    diag_v = (4.0 * (nuH.n + nuH_s) / dy ** 2
              + (nuH.e + nuH_w) / dx ** 2 + beta)
    return diag_u, diag_v


def line_systems(nuH, beta, bc_mask, dx, dy, sh):
    """The line preconditioner's row-equilibrated tridiagonal systems:
    (au, cu, bu) of the u-lines along x and (av, cv, bv) of the v-lines
    along y, with the unit diagonal implicit and b the row scale; the
    transverse and drag terms lumped on b, the Dirichlet rows identities
    decoupled from their neighbours."""
    nuH_w = sh(nuH.e, 0, -1)
    nuH_s = sh(nuH.n, -1, 0)
    diag_u, diag_v = operator_diagonal(nuH, beta, dx, dy, sh)
    au = -4.0 * nuH_w / dx ** 2
    cu = -4.0 * nuH.e / dx ** 2
    av = -4.0 * nuH_s / dy ** 2
    cv = -4.0 * nuH.n / dy ** 2
    bu = torch.where(bc_mask, 1.0, torch.clamp(diag_u, min=1e-12))
    bv = torch.where(bc_mask, 1.0, torch.clamp(diag_v, min=1e-12))
    # Dirichlet rows are identities; decouple their neighbors from them
    au = torch.where(bc_mask | sh(bc_mask, 0, -1), 0.0, au)
    cu = torch.where(bc_mask | sh(bc_mask, 0, 1), 0.0, cu)
    av = torch.where(bc_mask | sh(bc_mask, -1, 0), 0.0, av)
    cv = torch.where(bc_mask | sh(bc_mask, 1, 0), 0.0, cv)
    # row-equilibrate (unit diagonal)
    au, cu = au / bu, cu / bu
    av, cv = av / bv, cv / bv
    return au, cu, bu, av, cv, bv


def make_line_preconditioner(nuH, beta, bc_mask, dx, dy, sh,
                             pcr_impl: str = "xla"):
    """Alternating-direction line preconditioner: the u-equation is relaxed
    exactly along x-lines and the v-equation along y-lines, with the
    transverse and drag terms lumped on the diagonal. Each application is
    one batched PCR solve per component (the JAX package's
    ``line_pcr_dtype = f32``, ``line_block = 0``).

    ``pcr_impl``: ``xla`` solves with the plain torch PCR, the v-lines on the
    transposed layout; ``pallas_sublane`` with the PCR kernels
    (``ops/kernels/pcr.py``) directly on the (My, Mx) layout, the u-lines
    along its last axis and the v-lines along axis -2, so no transposes:
    the lines are factored when the preconditioner is built, and an
    application is two apply launches and nothing else. An ensemble's (B,
    My, Mx) fields take both routes as they are, the kernels launched once
    for all members."""
    if pcr_impl not in ("xla", "pallas_sublane"):
        raise NotImplementedError(
            f"stress_balance.ssa.fd.line_pcr_impl = {pcr_impl!r} is not "
            "implemented in pism_tpu_torch (supported: 'xla', 'pallas_sublane')")
    au, cu, bu, av, cv, bv = line_systems(nuH, beta, bc_mask, dx, dy, sh)
    if pcr_impl == "pallas_sublane":
        # the lines are factored here, with the unit diagonal implicit; an
        # application is two apply launches on residuals of the
        # coefficients' dtype (pcr_apply raises on another)
        fu = pcr_factor_lines(au, None, cu)
        fv = pcr_factor_lines_sub(av, None, cv)

        def precond(r):
            ru, rv = r
            return pcr_apply(fu, ru, bu), pcr_apply(fv, rv, bv)

        return precond

    # v-lines run along y: solve them on the transposed (Mx, My) layout
    def T(x):
        return x.transpose(-1, -2)

    avT, cvT, bvT = T(av), T(cv), T(bv)

    def precond(r):
        ru, rv = r
        one = torch.ones_like(ru)
        zu = solve_batched_pcr(au.to(ru.dtype), one, cu.to(ru.dtype),
                               ru / bu.to(ru.dtype))
        zv = T(solve_batched_pcr(avT.to(rv.dtype), T(one), cvT.to(rv.dtype),
                                 T(rv) / bvT.to(rv.dtype))).contiguous()
        return zu, zv

    return precond


def _dot(a, b, dot_dtype=None, lead=0):
    """sum(a0 b0) + sum(a1 b1) of pairs of fields: 0-dim, or with ``lead``
    = 1 (an ensemble's (B, My, Mx) fields) one per member through
    ``member_dot``."""
    if lead:
        return member_dot(a, b, dot_dtype)
    if dot_dtype is not None:
        return (torch.sum(a[0].to(dot_dtype) * b[0].to(dot_dtype))
                + torch.sum(a[1].to(dot_dtype) * b[1].to(dot_dtype)))
    return torch.sum(a[0] * b[0]) + torch.sum(a[1] * b[1])


def _dots(x, y, which, dot_dtype=None, lead=0):
    """The dots that ``which`` names among "xx" (x.x), "xy" (x.y) and "yy"
    (y.y) of the pairs of fields ``x`` and ``y``, in that order: with
    ``lead`` = 1 in one launch of ``member_dots``, else as ``_dot``s."""
    if lead:
        return member_dots(x, y, dot_dtype, which)
    return tuple(_dot(p, q, dot_dtype) for p, q in pairs(x, y, which))


def _nz(x):
    """x with exact zeros replaced by 1e-300 (0 in float32, as in JAX)."""
    return torch.where(x == 0, 1e-300, x)


def member_col(s, lead):
    """A per-member scalar ((B,), with ``lead`` = 1) shaped to scale (B, My,
    Mx) fields; a 0-dim one (or ``lead`` = 0) as it is."""
    return s.view(-1, 1, 1) if lead and s.dim() else s


def bicgstab_solve(matvec, b, x0, precond, *, rtol=1e-5, atol=0.0,
                   max_iter=300, dot_dtype=None, lead=0):
    """Right-preconditioned BiCGStab on pairs of (My, Mx) tensors.

    Returns ``(x, iterations, |r|^2)``; ``iterations`` is a host int. The
    loop's stop test is one host sync per iteration.

    On an ensemble's member axis (``lead`` = 1, pairs of (B, My, Mx)
    tensors) each member iterates on its own, the ``vmap`` of the JAX loop
    (``pism_tpu/ops/ssa.py:318-374``): rho, alpha, omega, the tolerance
    (``rtol`` may be a (B,) tensor), the iteration bound (``max_iter`` may
    be a list of B host ints; 0 leaves the member at ``x0``) and the stop
    test are per member; a member that stopped is frozen, its x, r and
    count kept by a select, while the others go on. The lockstep loop
    reads one (B,) mask an iteration; ``iterations`` is a list of B ints.
    It takes the dots of one point of the loop in one launch
    (``member_dots``): r.r of the stop test with rhat.r, passed to the
    body as ``rho_new``, and t.s with t.t, so an iteration launches three
    dot kernels."""
    def dot(p, q):
        return _dot(p, q, dot_dtype, lead)

    def col(a):
        return member_col(a, lead)

    def axpy(a, x, y):  # a*x + y (scalar cast to the vector dtype)
        return (col(a.to(x[0].dtype)) * x[0] + y[0],
                col(a.to(x[1].dtype)) * x[1] + y[1])

    def body(x, r, p, v, rho, alpha, omega, rho_new=None):
        if rho_new is None:
            rho_new = dot(rhat, r)
        beta = (rho_new / _nz(rho)) * (alpha / _nz(omega))
        om = col(omega.to(p[0].dtype))
        p = axpy(beta, (p[0] - om * v[0], p[1] - om * v[1]), r)
        y = precond(p)
        v = matvec(y)
        alpha = rho_new / _nz(dot(rhat, v))
        s = axpy(-alpha, v, r)
        z = precond(s)
        t = matvec(z)
        tt, ts = _dots(t, s, ("xx", "xy"), dot_dtype, lead)
        omega = ts / _nz(tt)
        x = axpy(alpha, y, axpy(omega, z, x))
        r = axpy(-omega, t, s)
        return x, r, p, v, rho_new, alpha, omega

    Ax0 = matvec(x0)
    r0 = (b[0] - Ax0[0], b[1] - Ax0[1])
    rhat = r0
    b_norm2 = dot(b, b)
    tol2 = torch.clamp(rtol ** 2 * b_norm2, min=atol ** 2)
    one = torch.ones_like(b_norm2)
    zero = (torch.zeros_like(b[0]), torch.zeros_like(b[1]))
    carry = (x0, r0, zero, zero, one, one, one)
    if not lead:
        it = 0
        while it < max_iter and host(dot(carry[1], carry[1]) > tol2):
            carry = body(*carry)
            it += 1
    else:
        n = b_norm2.shape[0]
        cap = list(max_iter) if isinstance(max_iter, (list, tuple)) \
            else [max_iter] * n
        cap_d = torch.tensor(cap, device=b_norm2.device)
        it = [0] * n
        it_d = torch.zeros_like(cap_d)
        # a loop at its bound reads nothing, as the single loop's test
        while any(k < c for k, c in zip(it, cap)):
            rr, rho_new = _dots(carry[1], rhat, ("xx", "xy"), dot_dtype, 1)
            go_d = (rr > tol2) & (it_d < cap_d)
            go = host(go_d)
            if not any(go):
                break
            new = body(*carry, rho_new)
            carry = new if all(go) else tuple(
                member_select(go_d, a, b_) for a, b_ in zip(new, carry))
            it_d = it_d + go_d
            it = [k + g for k, g in zip(it, go)]
    x, r = carry[:2]
    # breakdown guard: near-breakdown (rho/omega cancellation, worst in f32)
    # explodes the recurrences and the NaN residual exits the loop above;
    # never hand a diverged iterate back to the Newton/Picard caller
    rfin2, r02 = _dots(r, r0, ("xx", "yy"), dot_dtype, lead)
    ok = rfin2 <= r02          # False for NaN too
    x = (torch.where(col(ok), x[0], x0[0]), torch.where(col(ok), x[1], x0[1]))
    return x, it, torch.where(ok, rfin2, r02)


def member_select(take, a, b):
    """Per member: ``a`` where the (B,) mask ``take`` is set, else ``b``;
    pairs of fields, fields, or per-member scalars."""
    if isinstance(a, tuple):
        return tuple(member_select(take, x, y) for x, y in zip(a, b))
    return torch.where(take.view(-1, *(1,) * (a.dim() - 1)), a, b)
