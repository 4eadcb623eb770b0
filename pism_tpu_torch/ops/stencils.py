"""Staggered-grid finite-difference building blocks (port of
``pism_tpu/ops/stencils.py``).

Conventions
-----------
- arrays are ``(My, Mx[, ...])``; axis 0 is y ("j"), axis 1 is x ("i").
  An ensemble's fields carry a leading member axis, ``(B, My, Mx[, ...])``
  (the JAX package's ``stack_states`` layout): ``lead``, the number of
  leading member dims, puts y and x at dims ``lead`` and ``lead + 1``. It
  is given, never guessed from shapes (61x61x61 would be ambiguous); with
  ``lead = 0`` every function is what it was.
- staggered fields live on cell faces: ``E[j, i]`` is the face between
  ``(j, i)`` and ``(j, i+1)``; ``N[j, i]`` between ``(j, i)`` and
  ``(j+1, i)``. The last row/column of faces sits on the domain boundary.
- ghosts wrap around a periodic axis and repeat the edge (zero-gradient)
  on the others; every component that builds a ``Shifter`` inherits the
  wrap, as in the JAX package.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=64)
def _clamped_index(n: int, s: int, device: torch.device) -> torch.Tensor:
    return torch.clamp(torch.arange(n) + s, 0, n - 1).to(device)


@functools.lru_cache(maxsize=64)
def _wrapped_index(n: int, s: int, device: torch.device) -> torch.Tensor:
    return torch.remainder(torch.arange(n) + s, n).to(device)


def _shift_axis(a: torch.Tensor, s: int, dim: int,
                periodic: bool = False) -> torch.Tensor:
    """b[k] = a[k + s] along ``dim``, the index wrapped (periodic) or
    clamped (one gather)."""
    if s == 0:
        return a
    index = _wrapped_index if periodic else _clamped_index
    return a.index_select(dim, index(a.shape[dim], s, a.device))


def shift(a: torch.Tensor, jy: int, ix: int, periodic_y: bool = False,
          periodic_x: bool = False, lead: int = 0) -> torch.Tensor:
    """Return b with b[j, i] = a[j + jy, i + ix] (ghosts by wrap or clamp);
    y and x are dims ``lead`` and ``lead + 1``."""
    return _shift_axis(_shift_axis(a, jy, lead, periodic_y), ix, lead + 1,
                       periodic_x)


@functools.lru_cache(maxsize=64)
def _ghost_index(My: int, Mx: int, g: int, periodic_y: bool, periodic_x: bool,
                 device: torch.device) -> torch.Tensor:
    def axis(n, periodic):
        k = torch.arange(-g, n + g)
        return torch.remainder(k, n) if periodic else torch.clamp(k, 0, n - 1)
    return (axis(My, periodic_y)[:, None] * Mx
            + axis(Mx, periodic_x)[None, :]).reshape(-1).to(device)


def pad_ghosts(a: torch.Tensor, g: int, periodic_y: bool = False,
               periodic_x: bool = False, lead: int = 0) -> torch.Tensor:
    """``a`` (2D, or (y, x, ...), after ``lead`` member dims) with ``g``
    ghost cells on both sides of its y and x axes: wrapped around a
    periodic axis, repeating the edge on the others (the values ``shift``
    reads there); one gather, contiguous."""
    head, (My, Mx), tail = a.shape[:lead], a.shape[lead:lead + 2], \
        a.shape[lead + 2:]
    index = _ghost_index(My, Mx, g, periodic_y, periodic_x, a.device)
    return a.reshape(*head, My * Mx, *tail).index_select(lead, index).view(
        *head, My + 2 * g, Mx + 2 * g, *tail)


class Shifter:
    """Bind grid periodicity and the member dims once: ``sh =
    Shifter(grid); sh(a, jy, ix)``. ``lead``: the leading member dims of
    the fields it shifts (1 on an ensemble's member axis)."""

    def __init__(self, grid, lead: int = 0):
        self.py = grid.periodic_y
        self.px = grid.periodic_x
        self.lead = lead

    def __call__(self, a, jy: int, ix: int):
        return shift(a, jy, ix, self.py, self.px, self.lead)


# ---------------------------------------------------------------------------
# Staggered averages and gradients
# ---------------------------------------------------------------------------

def avg_to_east(a, sh):
    """Average cell values onto east faces."""
    return 0.5 * (a + sh(a, 0, 1))


def avg_to_north(a, sh):
    return 0.5 * (a + sh(a, 1, 0))


def grad_x_east(s, dx, sh):
    """d(s)/dx on east faces: forward difference."""
    return (sh(s, 0, 1) - s) / dx


def grad_y_north(s, dy, sh):
    return (sh(s, 1, 0) - s) / dy


def grad_y_east(s, dy, sh):
    """d(s)/dy on east faces (Mahaffy 4-point average)."""
    return (sh(s, 1, 0) + sh(s, 1, 1) - sh(s, -1, 0) - sh(s, -1, 1)) / (4.0 * dy)


def grad_x_north(s, dx, sh):
    return (sh(s, 0, 1) + sh(s, 1, 1) - sh(s, 0, -1) - sh(s, 1, -1)) / (4.0 * dx)


def centered_grad(s, dx, dy, sh):
    """Centered gradient at cell centers."""
    gx = (sh(s, 0, 1) - sh(s, 0, -1)) / (2.0 * dx)
    gy = (sh(s, 1, 0) - sh(s, -1, 0)) / (2.0 * dy)
    return gx, gy


def div_staggered(QE, QN, dx, dy, sh):
    """Divergence at cell centers of a staggered face flux (QE, QN).

    div[j,i] = (QE[j,i] - QE[j,i-1])/dx + (QN[j,i] - QN[j-1,i])/dy
    """
    return (QE - sh(QE, 0, -1)) / dx + (QN - sh(QN, -1, 0)) / dy


def upwind_flux_east(u_face, a, sh):
    """First-order upwind advective face value: a from the upwind side."""
    return torch.where(u_face >= 0.0, a, sh(a, 0, 1)) * u_face


def upwind_flux_north(v_face, a, sh):
    return torch.where(v_face >= 0.0, a, sh(a, 1, 0)) * v_face
