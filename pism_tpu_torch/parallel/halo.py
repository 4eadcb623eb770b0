"""Halo exchange over the device mesh (port of ``pism_tpu/parallel/halo.py``).

A field decomposed over a :class:`~pism_tpu_torch.parallel.mesh.Mesh` is a
grid of blocks, ``blocks[iy][ix]`` on device (iy, ix): ``split_blocks``
and ``gather_blocks`` are the ``P("y", "x")`` in/out specs of the JAX
package's ``shard_map``. ``halo_pad`` fills each block's ghost cells from
its neighbours' blocks, a strip copied to the block's device where the JAX
package sends it with ``lax.ppermute``; never from a padded copy of the
global field, so the same code is right across cards. At a physical edge
the ghosts repeat the edge row or column (the clamp of ``ops.stencils``),
or wrap around when the axis is periodic.
"""

from __future__ import annotations

import torch


def split_blocks(a, mesh):
    """The (y, x) blocks of ``a`` (a 2D or (y, x, z) field whose y and x
    extents are multiples of the mesh's), each on its mesh device. Blocks
    on the field's own device are views."""
    ny, nx = mesh.shape["y"], mesh.shape["x"]
    My, Mx = a.shape[0], a.shape[1]
    if My % ny or Mx % nx:
        raise ValueError(f"a {My}x{Mx} field does not split over a {ny}x{nx} "
                         "mesh")
    by, bx = My // ny, Mx // nx
    return [[a[iy * by:(iy + 1) * by, ix * bx:(ix + 1) * bx].to(
        mesh.devices[iy][ix]) for ix in range(nx)] for iy in range(ny)]


def gather_blocks(blocks, device=None):
    """The whole field of a grid of blocks, on ``device`` (default: the
    first block's)."""
    device = blocks[0][0].device if device is None else device

    def cat(parts, dim):
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

    return cat([cat([b.to(device) for b in row], 1) for row in blocks], 0)


def _edge(b, dim, at, width):
    """The edge row or column ``at`` (0 or -1) of ``b`` along ``dim``,
    repeated ``width`` times."""
    strip = b.narrow(dim, 0 if at == 0 else b.shape[dim] - 1, 1)
    return strip.expand(*[width if d == dim else -1 for d in range(b.dim())])


def _exchange_axis(blocks, width, dim, periodic, mesh):
    """Pad every block with ``width`` ghosts along array axis ``dim`` (0: y,
    1: x) from its neighbours over the matching mesh axis."""
    ny, nx = len(blocks), len(blocks[0])
    n = ny if dim == 0 else nx
    out = []
    for iy in range(ny):
        row = []
        for ix in range(nx):
            b = blocks[iy][ix]
            k = iy if dim == 0 else ix
            size = b.shape[dim]
            if size < width:
                raise ValueError(f"a block of {size} cells cannot feed "
                                 f"{width} ghosts")

            def neighbour(kk):
                return blocks[kk][ix] if dim == 0 else blocks[iy][kk]

            dev = mesh.devices[iy][ix]
            if k > 0 or periodic:        # neighbour k-1's highest strip
                lo = neighbour((k - 1) % n)
                lo = lo.narrow(dim, lo.shape[dim] - width, width).to(dev)
            else:
                lo = _edge(b, dim, 0, width)
            if k < n - 1 or periodic:    # neighbour k+1's lowest strip
                hi = neighbour((k + 1) % n).narrow(dim, 0, width).to(dev)
            else:
                hi = _edge(b, dim, -1, width)
            row.append(torch.cat([lo, b, hi], dim))
        out.append(row)
    return out


def halo_pad(blocks, width, mesh, periodic=(False, False)):
    """Every block padded with ``width`` ghosts on both 2D axes. The
    exchange runs in y, then in x on the y-padded blocks, so the corner
    ghosts come from the diagonal neighbours (the two-pass trick of the JAX
    package)."""
    out = _exchange_axis(blocks, width, 0, periodic[0], mesh)
    return _exchange_axis(out, width, 1, periodic[1], mesh)


def crop(block, width: int):
    """Strip ``width`` ghost cells from both 2D axes."""
    return block[width:-width, width:-width, ...]


def stencil_shard_map(fn, mesh, width: int = 1, periodic=(False, False)):
    """Wrap ``fn(padded_block, ...) -> block`` local stencils: the returned
    function splits its whole-field arguments over the mesh, pads each block
    with ``width`` ghosts, applies ``fn`` per block and gathers the result
    onto the first argument's device.
    Example::

        lap = stencil_shard_map(
            lambda a: (a[2:, 1:-1] + a[:-2, 1:-1] + a[1:-1, 2:]
                       + a[1:-1, :-2] - 4 * a[1:-1, 1:-1]),
            mesh, width=1)
    """
    def wrapped(*arrays):
        padded = [halo_pad(split_blocks(a, mesh), width, mesh, periodic)
                  for a in arrays]
        ny, nx = mesh.shape["y"], mesh.shape["x"]
        outs = [[fn(*(p[iy][ix] for p in padded)) for ix in range(nx)]
                for iy in range(ny)]
        return gather_blocks(outs, arrays[0].device)

    return wrapped
