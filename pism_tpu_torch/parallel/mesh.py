"""Device mesh (port of ``pism_tpu/parallel/mesh.py``).

A single-controller mesh, as JAX's: one process holds a ("y", "x") grid of
torch devices, and a field decomposed over it is a grid of blocks, block
(iy, ix) on device (iy, ix). A device may appear more than once, so
``make_mesh(["cuda:0"] * 4, (2, 2))`` is a 2x2 mesh of one card and
``make_mesh(["cpu"] * 8, (2, 4))`` the CPU mesh of the tests; with several
cards the mesh names distinct ones and the halo strips travel between them
(``parallel/halo.py``). 3D fields are split in (y, x) only, with z whole
(columns are never decomposed).

The model's fields stay whole on one device; only the kernel routes
(``ops/sharded.py``) decompose them, at the points where the JAX package
calls ``shard_map``.

``make_mesh(devices, ensemble=ne)`` builds the ensemble axis "e" alone, an
``EnsembleMesh`` of ne devices (y x x = 1): ``parallel/ensemble.py`` places
an ensemble's members on it, a group of consecutive members per device, and
the members on one device run as one batch. A device may repeat here too,
so ``make_mesh(["cuda:0"] * 4, ensemble=4)`` is one card. The ("e", "y",
"x") mesh with y x x > 1 raises NotImplementedError (ROADMAP Queue 1 item
11).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..state import map_tensors


def best_factorization(n: int) -> tuple:
    """Split n devices into the most-square (ny, nx) layout, like PETSc's
    default DMDA processor grid."""
    best = (1, n)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (a, n // a)
    return best


class Mesh:
    """A (ny, nx) grid of torch devices over the axes ("y", "x"), with the
    attributes of ``jax.sharding.Mesh`` that the kernel routes read:
    ``axis_names``, ``shape["y"]``, ``shape["x"]`` and ``size``."""

    axis_names = ("y", "x")

    def __init__(self, devices: Sequence[Sequence]):
        self.devices = tuple(tuple(torch.device(d) for d in row)
                             for row in devices)
        nx = len(self.devices[0]) if self.devices else 0
        if nx == 0 or any(len(row) != nx for row in self.devices):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")

    @property
    def shape(self) -> dict:
        return {"y": len(self.devices), "x": len(self.devices[0])}

    @property
    def size(self) -> int:
        return len(self.devices) * len(self.devices[0])

    @property
    def device(self) -> torch.device:
        """The first device, where whole fields live."""
        return self.devices[0][0]

    def __repr__(self):
        return f"Mesh(shape={self.shape}, devices={self.devices})"


class EnsembleMesh:
    """The ensemble axis "e" of ``ne`` devices (the JAX package's ("e",
    "y", "x") mesh with y = x = 1): ``axis_names``, ``shape``, ``size``
    and ``devices`` (one per member group, in member order)."""

    axis_names = ("e", "y", "x")

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("an ensemble mesh needs a device")

    @property
    def shape(self) -> dict:
        return {"e": len(self.devices), "y": 1, "x": 1}

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def __repr__(self):
        return f"EnsembleMesh(shape={self.shape}, devices={self.devices})"


def make_mesh(devices: Optional[Sequence] = None, shape: Optional[tuple] = None,
              ensemble: int = 1):
    """Build a ("y", "x") mesh of ``devices`` (default: every CUDA device;
    raises without one) in ``shape`` (default :func:`best_factorization`);
    with ``ensemble`` > 1 the ensemble axis ("e", "y", "x") of
    ``ensemble`` x y x x devices, of which y x x = 1 is implemented."""
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device (pass devices, e.g. "
                               "['cpu'] * 8, for a CPU mesh)")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = list(devices)
    if ensemble > 1:
        if len(devices) % ensemble:
            raise ValueError(f"{len(devices)} devices not divisible by "
                             f"ensemble={ensemble}")
        ny, nx = shape if shape else best_factorization(
            len(devices) // ensemble)
        if ny * nx != 1:
            raise NotImplementedError(
                f"an ensemble mesh with a ({ny}, {nx}) domain decomposition "
                "(e x (y, x)) is not implemented in pism_tpu_torch (ROADMAP "
                "Queue 1 item 11)")
        if ensemble != len(devices):
            raise ValueError(f"{len(devices)} devices do not fill an "
                             f"ensemble axis of {ensemble}")
        return EnsembleMesh(devices)
    ny, nx = shape if shape else best_factorization(len(devices))
    if ny * nx != len(devices):
        raise ValueError(f"{len(devices)} devices do not fill a {ny}x{nx} mesh")
    return Mesh([devices[iy * nx:(iy + 1) * nx] for iy in range(ny)])


def is_sharded(mesh) -> bool:
    """A ("y", "x") device mesh with more than one device: the kernel
    routes go through ``ops/sharded.py`` (``pism_tpu/ops/sia.py:163-167``)."""
    return (mesh is not None and getattr(mesh, "size", 1) > 1
            and tuple(mesh.axis_names) == ("y", "x"))


def refuse_periodic_mesh(grid, mesh) -> None:
    """Raise NotImplementedError for a sharded mesh on a periodic grid: the
    routes decompose non-periodic grids only (ROADMAP Queue 1 item 11)."""
    if (grid.periodic_x or grid.periodic_y) and is_sharded(mesh):
        raise NotImplementedError(
            f"a mesh with grid.periodicity = {grid.periodicity!r} is not "
            "implemented in pism_tpu_torch")


def shard_state(state, mesh: Mesh):
    """Move every tensor of the state to the mesh's first device: fields
    stay whole there, and the kernel routes decompose them per call (the
    JAX package instead places each leaf with (y, x[, z]) sharding)."""
    return map_tensors(state, lambda x: x.to(mesh.device))
