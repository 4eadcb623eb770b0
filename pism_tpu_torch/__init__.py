"""pism_tpu_torch: the PyTorch and CUDA port of pism_tpu.

It runs the synthetic-Greenland hybrid chain (``setups.py``) on one
device, with the SSA operator matvec as a hand-written CUDA kernel for
Hopper (``csrc/ssa_matvec.cu``). It imports torch and numpy only, never
jax or pism_tpu; config names, state-field names and the step order are
those of ``pism_tpu`` so any state can be run through both packages.
"""

from .config import Config
from .grid import Grid
from .state import Geometry, ModelState, ensure_consistency, new_geometry
from .util.timecal import Time

__version__ = "0.1.0"

__all__ = ["Config", "Grid", "Geometry", "ModelState", "Time",
           "new_geometry", "ensure_consistency"]
