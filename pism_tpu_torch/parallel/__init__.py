"""The spatial device mesh and its halo exchange (port of
``pism_tpu/parallel/mesh.py`` and ``halo.py``)."""

from .mesh import Mesh, best_factorization, make_mesh, shard_state

__all__ = ["Mesh", "best_factorization", "make_mesh", "shard_state"]
