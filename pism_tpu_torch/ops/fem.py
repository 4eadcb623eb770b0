"""Q1 finite-element kit on the structured grid (port of
``pism_tpu/ops/fem.py``) for the SSAFEM stress balance.

Every element quantity is a whole (My, Mx) array: entry (j, i) is the
element whose lower-left node is (j, i). Corner values are ``torch.roll``
shifts of the nodal arrays, so periodic grids wrap as PISM's element map
does; the scatter of element contributions back to the nodes is four
rolled adds. On non-periodic axes the wrap row/column of elements is
masked out by :func:`element_validity`.

Reference square [-1,1]^2, node order a = 0..3: (-1,-1), (1,-1), (1,1),
(-1,1); N_a = (1 + xi_a xi)(1 + eta_a eta)/4; 2x2 Gauss points at
+-1/sqrt(3) with unit weights; uniform rectangular elements (dx, dy) give
the constant Jacobian J = dx dy / 4. The tables are Python floats and every
sum runs in the JAX package's order (a, then q), so float64 results agree
to rounding.
"""

from __future__ import annotations

import numpy as np
import torch

#: local node coordinates on the reference square
_XI_A = np.array([-1.0, 1.0, 1.0, -1.0])
_ETA_A = np.array([-1.0, -1.0, 1.0, 1.0])
#: 2x2 Gauss points (unit weights)
_G = 1.0 / np.sqrt(3.0)
_XI_Q = np.array([-_G, _G, _G, -_G])
_ETA_Q = np.array([-_G, -_G, _G, _G])

#: N[a][q], dNdxi[a][q], dNdeta[a][q]
N_TAB = [[float(0.25 * (1 + _XI_A[a] * _XI_Q[q]) * (1 + _ETA_A[a] * _ETA_Q[q]))
          for q in range(4)] for a in range(4)]
DNDXI_TAB = [[float(0.25 * _XI_A[a] * (1 + _ETA_A[a] * _ETA_Q[q]))
              for q in range(4)] for a in range(4)]
DNDETA_TAB = [[float(0.25 * _ETA_A[a] * (1 + _XI_A[a] * _XI_Q[q]))
               for q in range(4)] for a in range(4)]


def corners(u):
    """Nodal (My, Mx) -> the 4 element-corner arrays in local node order;
    the east/north neighbors wrap (mask the wrap row/column with
    :func:`element_validity` on non-periodic axes)."""
    e = torch.roll(u, -1, dims=1)
    n = torch.roll(u, -1, dims=0)
    ne = torch.roll(e, -1, dims=0)
    return (u, e, ne, n)


def element_validity(shape, periodic_x: bool, periodic_y: bool,
                     dtype=torch.float64, device=None):
    """1 on real elements, 0 on the wrap row/column of non-periodic axes."""
    v = np.ones(shape, dtype=np.float64)
    if not periodic_x:
        v[:, -1] = 0.0
    if not periodic_y:
        v[-1, :] = 0.0
    return torch.as_tensor(v, dtype=dtype, device=device)


def scatter_to_nodes(contrib_a):
    """Sum per-(element, local node) contributions into the nodal array:
    the transpose of :func:`corners`."""
    out = contrib_a[0]
    out = out + torch.roll(contrib_a[1], 1, dims=1)
    out = out + torch.roll(torch.roll(contrib_a[2], 1, dims=0), 1, dims=1)
    out = out + torch.roll(contrib_a[3], 1, dims=0)
    return out


# -- quadrature and assembly on stacked arrays (the Krylov loops' operator) --
#
# A few launches a call instead of one per table entry: the corners and the
# quadrature points stacked on new axes, every product of a table entry in
# one launch, and the sums over a (or q) as three adds in the JAX package's
# order (``quad_values``, ``quad_gradients`` and ``integrate`` there), so
# that each value rounds as there: the Jacobi-preconditioned FEM solves'
# Krylov counts move with the rounding (``scripts/fem_krylov_rounding.py``).

def basis_tables(dx: float, dy: float, dtype=torch.float64, device=None):
    """The tables of :func:`quad_stacked` and :func:`integrate_stacked`:
    (12, 4) rows q of N, dN/dxi and dN/deta by columns a, with the (12, 1,
    1) scales 1, 2/dx and 2/dy of their rows; and (3, 4, 4) by (term, a,
    q) of N, (2/dx) dN/dxi and (2/dy) dN/deta."""
    sx, sy = 2.0 / dx, 2.0 / dy
    rows = ([[N_TAB[a][q] for a in range(4)] for q in range(4)]
            + [[DNDXI_TAB[a][q] for a in range(4)] for q in range(4)]
            + [[DNDETA_TAB[a][q] for a in range(4)] for q in range(4)])
    scale = [1.0] * 4 + [sx] * 4 + [sy] * 4
    test = [[[N_TAB[a][q] for q in range(4)] for a in range(4)],
            [[sx * DNDXI_TAB[a][q] for q in range(4)] for a in range(4)],
            [[sy * DNDETA_TAB[a][q] for q in range(4)] for a in range(4)]]

    def t(x):
        return torch.tensor(x, dtype=dtype, device=device)

    return t(rows)[..., None, None], t(scale)[:, None, None], \
        t(test)[..., None, None]


def corners_stacked(u):
    """(..., My, Mx) -> (..., 4, My, Mx): :func:`corners` on a new axis."""
    e = torch.roll(u, -1, dims=-1)
    return torch.stack((u, e, torch.roll(e, -1, dims=-2),
                        torch.roll(u, -1, dims=-2)), dim=-3)


def quad_stacked(tables, u_c):
    """Values (rows 0-3), x- (4-7) and y-derivatives (8-11) at the
    quadrature points of stacked corners (..., 4, My, Mx): (..., 12, My,
    Mx), summed over the corners a in order, then scaled by 1, 2/dx or
    2/dy."""
    rows, scale = tables[:2]
    p = rows * u_c.unsqueeze(-4)                 # (..., 12, 4, My, Mx)
    acc = p[..., 0, :, :] + p[..., 1, :, :] + p[..., 2, :, :] \
        + p[..., 3, :, :]
    return scale * acc


def integrate_stacked(tables, f0, fx, fy, dx: float, dy: float):
    """Assemble sum_q w_q J [f0_q N_a + fx_q dN_a/dx + fy_q dN_a/dy] into a
    nodal residual array: the weak-form integral of f0 phi + fx phi_x + fy
    phi_y for every Q1 test function phi at once. f0, fx and fy are stacked
    quadrature-point terms (..., 4, My, Mx); the caller masks the wrap
    elements inside them. The element contributions go back to the nodes
    as :func:`scatter_to_nodes` adds them."""
    test = tables[2]
    f = (f0, fx, fy)
    term = 0.0
    for k in range(3):
        term = term + f[k].unsqueeze(-4) * test[k]   # (..., 4a, 4q, My, Mx)
    acc = term[..., 0, :, :] + term[..., 1, :, :] + term[..., 2, :, :] \
        + term[..., 3, :, :]
    c = (dx * dy / 4.0) * acc
    return (c[..., 0, :, :] + torch.roll(c[..., 1, :, :], 1, dims=-1)
            + torch.roll(torch.roll(c[..., 2, :, :], 1, dims=-2), 1, dims=-1)
            + torch.roll(c[..., 3, :, :], 1, dims=-2))
