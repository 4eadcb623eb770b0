"""The device meshes of the port (port of ``pism_tpu/parallel/``): the
spatial ("y", "x") mesh and its halo exchange, and the ensemble axis "e"
with its lockstep runner (``ensemble.py``)."""

from .mesh import EnsembleMesh, Mesh, best_factorization, make_mesh, shard_state

__all__ = ["EnsembleMesh", "Mesh", "best_factorization", "make_mesh",
           "shard_state"]
