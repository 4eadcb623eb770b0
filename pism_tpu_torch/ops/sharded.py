"""The kernels under spatial decomposition (port of
``pism_tpu/ops/pallas_sharded.py``).

Where the JAX package runs a Pallas kernel inside ``shard_map`` on
halo-padded local blocks, this module splits the whole fields over a
:class:`~pism_tpu_torch.parallel.mesh.Mesh`, fills the ghosts from the
neighbouring blocks (``parallel/halo.py``), launches the kernel once per
shard on the shard's device and gathers the results back onto the input's
device: the SSA matvec through K5 (``ssa_matvec_halo``), the Newton matvec
(``ssa_newton_matvec_halo``; its frozen fields are padded once per Newton
sweep, the direction per call) and the fused SIA fluxes through K3/K4 (the
JAX package's K6).

Grids are typically odd (Mx = 2L/dx + 1), so the fields are first
edge-padded up to the next mesh multiple on the high (north, east) ends and
the results cropped back, as in the JAX package; the repeated pad rows
reproduce the clamped edge of the unsharded kernels.

K3 and K4 read their fields with clamped neighbour indices, so each shard
launches the kernel on its one-ghost padded block and keeps the interior:
a padded cell's neighbours lie inside the block, where the clamp never
acts, so the interior is the padded-block kernel of the TPU
(``sia_flux_thermo_pallas_padded``, ``sia_flux_pallas_padded``) to the
bit, for one ring of extra cells per shard.
"""

from __future__ import annotations

import torch

from ..parallel import halo
from .kernels import sia_iso as K4
from .kernels import sia_thermo as K3
from .kernels import ssa_matvec as K


def _mesh_yx(mesh):
    return mesh.shape["y"], mesh.shape["x"]


def _pad_amounts(shape, mesh):
    ny, nx = _mesh_yx(mesh)
    return (-shape[0]) % ny, (-shape[1]) % nx


def _pad_high(a, py, px):
    """``a`` (2D or (y, x, z)) edge-padded by ``py`` rows on the north and
    ``px`` columns on the east."""
    if py:
        a = torch.cat([a, a[-1:].expand(py, *a.shape[1:])], 0)
    if px:
        a = torch.cat([a, a[:, -1:].expand(a.shape[0], px, *a.shape[2:])], 1)
    return a


def _blocks(fields, ghosts, mesh, py, px):
    """Each field (or None) as its grid of blocks with ``ghosts`` ghost
    cells (contiguous, for the kernels)."""
    out = []
    for f in fields:
        if f is None:
            out.append(None)
            continue
        b = halo.split_blocks(_pad_high(f, py, px), mesh)
        if ghosts:
            b = halo.halo_pad(b, ghosts, mesh)
        else:
            b = [[x.contiguous() for x in row] for row in b]
        out.append(b)
    return out


def _per_shard(fn, mesh, blocks, device, My, Mx, crop=0):
    """``fn(iy, ix, *shard blocks)`` over the mesh; its tuple of outputs
    gathered onto ``device`` (with ``crop`` ghosts cut from each shard's
    outputs first) and cropped to (My, Mx)."""
    ny, nx = _mesh_yx(mesh)
    outs = [[fn(iy, ix, *(None if b is None else b[iy][ix] for b in blocks))
             for ix in range(nx)] for iy in range(ny)]
    cut = (lambda a: halo.crop(a, crop)) if crop else (lambda a: a)
    return tuple(halo.gather_blocks([[cut(o[k]) for o in row] for row in outs],
                                    device)[:My, :Mx]
                 for k in range(len(outs[0][0])))


# ---------------------------------------------------------------------------
# SSA membrane-operator matvec (K5)
# ---------------------------------------------------------------------------

def _ssa(kernel, two, one, flat, mesh, dx, dy):
    """``kernel(west, south, *shard blocks, dx, dy)`` on every shard, with
    the fields ``two`` (velocities) given two ghosts, ``one`` (nuH) one and
    ``flat`` (beta) none; west/south: the shard owns that edge of the grid
    (the JAX package's flags ``[x index == 0, y index == 0]``)."""
    My, Mx = two[0].shape
    py, px = _pad_amounts(two[0].shape, mesh)
    blocks = (_blocks(two, 2, mesh, py, px) + _blocks(one, 1, mesh, py, px)
              + _blocks(flat, 0, mesh, py, px))
    return _per_shard(lambda iy, ix, *b: kernel(ix == 0, iy == 0, *b, dx, dy),
                      mesh, blocks, two[0].device, My, Mx)


def ssa_matvec_sharded(u, v, nuH_e, nuH_n, beta, mesh, dx, dy):
    """A(u, v) = -div T + beta (u, v) on (My, Mx) fields, K5 per shard of
    ``mesh`` (non-periodic grids); velocities get two ghosts, nuH one, beta
    none. Equal to ``ssa_matvec`` on the whole field."""
    return _ssa(K.ssa_matvec_halo, (u, v), (nuH_e, nuH_n), (beta,), mesh,
                dx, dy)


def ssa_matvec_sharded_jvp(u, v, du, dv, nuH_e, nuH_n, dnuH_e, dnuH_n, beta,
                           dbeta, mesh, dx, dy):
    """The operator's forward-mode derivative per shard, one fused K5 JVP
    launch each: A(du, dv; nuH, beta) + A(u, v; dnuH, dbeta), ``dbeta``
    None for a frozen drag coefficient."""
    return _ssa(K.ssa_matvec_halo_jvp, (u, v, du, dv),
                (nuH_e, nuH_n, dnuH_e, dnuH_n), (beta, dbeta), mesh, dx, dy)


def ssa_matvec_sharded_plain(u, v, nuH_e, nuH_n, beta, mesh, dx, dy):
    """:func:`ssa_matvec_sharded` through K5's plain version on any device
    (the reference the card's kernel is held to)."""
    return _ssa(K.ssa_matvec_halo_plain, (u, v), (nuH_e, nuH_n), (beta,),
                mesh, dx, dy)


def ssa_matvec_sharded_jvp_plain(u, v, du, dv, nuH_e, nuH_n, dnuH_e, dnuH_n,
                                 beta, dbeta, mesh, dx, dy):
    """:func:`ssa_matvec_sharded_jvp` through the plain version."""
    return _ssa(K.ssa_matvec_halo_jvp_plain, (u, v, du, dv),
                (nuH_e, nuH_n, dnuH_e, dnuH_n), (beta, dbeta), mesh, dx, dy)


def _newton_system(kernel, u, v, nuH_e, nuH_n, coef_e, coef_n, beta,
                   bc_mask, mesh, dx, dy):
    """The Newton matvec of a sweep under ``mesh``, in two steps. Here,
    once per sweep, the linearization's fields are split and halo-padded:
    u, v and ``bc_mask`` with two ghosts, nuH and the coefficient planes
    with one, beta with none. The returned ``matvec(du, dv)`` pads only the
    direction (two ghosts), runs ``kernel`` per shard and gathers."""
    My, Mx = u.shape
    py, px = _pad_amounts(u.shape, mesh)
    frozen = (_blocks((u, v), 2, mesh, py, px)
              + _blocks((nuH_e, nuH_n, coef_e, coef_n), 1, mesh, py, px)
              + _blocks((beta,), 0, mesh, py, px)
              + _blocks((bc_mask,), 2, mesh, py, px))

    def shard(iy, ix, up, vp, ne, nn, ce, cn, b, bcp, dup, dvp):
        return kernel(ix == 0, iy == 0, up, vp, dup, dvp, ne, nn, ce, cn, b,
                      bcp, dx, dy)

    def matvec(du, dv):
        return _per_shard(shard, mesh,
                          frozen + _blocks((du, dv), 2, mesh, py, px),
                          u.device, My, Mx)

    return matvec


def ssa_newton_matvec_sharded(u, v, nuH_e, nuH_n, coef_e, coef_n, beta,
                              bc_mask, mesh, dx, dy):
    """``matvec(du, dv)``: ``ssa_newton_matvec`` on the whole field, one
    launch of ``ssa_newton_matvec_halo`` per shard of ``mesh``; equal to
    the unsharded kernel."""
    return _newton_system(K.ssa_newton_matvec_halo, u, v, nuH_e, nuH_n,
                          coef_e, coef_n, beta, bc_mask, mesh, dx, dy)


def ssa_newton_matvec_sharded_plain(u, v, nuH_e, nuH_n, coef_e, coef_n,
                                    beta, bc_mask, mesh, dx, dy):
    """:func:`ssa_newton_matvec_sharded` through the plain version."""
    return _newton_system(K.ssa_newton_matvec_halo_plain, u, v, nuH_e, nuH_n,
                          coef_e, coef_n, beta, bc_mask, mesh, dx, dy)


class _SSAMatvecShardedJVP(torch.autograd.Function):
    """The sharded fused JVP as a Function of its own, reached from
    ``SSAMatvecSharded.jvp`` (see ``ops/kernels/ssa_matvec._SSAMatvecJVP``
    for why)."""

    @staticmethod
    def forward(*args):
        return ssa_matvec_sharded_jvp(*args)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass


class SSAMatvecSharded(torch.autograd.Function):
    """:func:`ssa_matvec_sharded` as a differentiable function of (u, v,
    nuH_e, nuH_n, beta): forward mode through the fused K5 JVP, the
    bilinear rule of the JAX package's ``_ssa_matvec_sharded_jvp``.
    Reverse mode is not provided."""

    @staticmethod
    def forward(u, v, nuH_e, nuH_n, beta, mesh, dx, dy):
        return ssa_matvec_sharded(u, v, nuH_e, nuH_n, beta, mesh, dx, dy)

    @staticmethod
    def setup_context(ctx, inputs, output):
        u, v, nuH_e, nuH_n, beta, mesh, dx, dy = inputs
        ctx.save_for_forward(u, v, nuH_e, nuH_n, beta)
        ctx.mesh, ctx.dx, ctx.dy = mesh, dx, dy

    @staticmethod
    def jvp(ctx, du, dv, dnuH_e, dnuH_n, dbeta, _dmesh, _ddx, _ddy):
        u, v, nuH_e, nuH_n, beta = ctx.saved_tensors
        z = lambda t, like: torch.zeros_like(like) if t is None else t
        return _SSAMatvecShardedJVP.apply(
            u, v, z(du, u), z(dv, v), nuH_e, nuH_n, z(dnuH_e, nuH_e),
            z(dnuH_n, nuH_n), beta, dbeta, ctx.mesh, ctx.dx, ctx.dy)


# ---------------------------------------------------------------------------
# SIA diffusivity + flux (K6: K3/K4 per shard)
# ---------------------------------------------------------------------------

def _max_D(De, Dn):
    return torch.maximum(torch.max(De), torch.max(Dn))


def sia_flux_thermo_sharded(H, s, E, z, mesh, **kw):
    """(De, Dn, qe, qn, max_D) of ``K3.sia_flux_thermo`` (same keywords),
    K3 per shard on one-ghost blocks. E: (My, Mx, Mz). ``max_D`` is taken
    over the cropped faces only."""
    My, Mx = H.shape
    py, px = _pad_amounts(H.shape, mesh)
    blocks = _blocks((H, s, E), 1, mesh, py, px)

    def shard(iy, ix, Hb, sb, Eb):
        return K3.sia_flux_thermo_faces(Hb, sb, Eb, z.to(Hb.device), **kw)

    qe, qn, De, Dn = _per_shard(shard, mesh, blocks, H.device, My, Mx, crop=1)
    return De, Dn, qe, qn, _max_D(De, Dn)


def sia_flux_sharded(H, s, mesh, **kw):
    """(De, Dn, qe, qn, max_D) of ``K4.sia_flux`` (same keywords), K4 per
    shard on one-ghost blocks."""
    My, Mx = H.shape
    py, px = _pad_amounts(H.shape, mesh)
    blocks = _blocks((H, s), 1, mesh, py, px)

    def shard(iy, ix, Hb, sb):
        return K4.sia_flux_faces(Hb, sb, **kw)

    qe, qn, De, Dn = _per_shard(shard, mesh, blocks, H.device, My, Mx, crop=1)
    return De, Dn, qe, qn, _max_D(De, Dn)
