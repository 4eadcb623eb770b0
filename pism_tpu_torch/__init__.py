"""pism_tpu_torch: the PyTorch and CUDA port of pism_tpu.

It runs the synthetic-Greenland hybrid chain, EISMINT II and the
verification tests (``setups.py``, ``verification/``) on one device, with
hand-written CUDA kernels for Hopper (``csrc/``), from Python
(``IceModel.run``) or the command line (``python -m pism_tpu_torch``). It
imports torch, numpy and scipy (h5py only to open a NetCDF-4 file), never
jax or pism_tpu; config names, state-field names, file variables and the
step order are those of ``pism_tpu``, so any state can be run through both
packages.
"""

from .config import Config
from .grid import Grid
from .state import Geometry, ModelState, ensure_consistency, new_geometry
from .util.timecal import Time

__version__ = "0.1.0"

__all__ = ["Config", "Grid", "Geometry", "ModelState", "Time",
           "new_geometry", "ensure_consistency"]
