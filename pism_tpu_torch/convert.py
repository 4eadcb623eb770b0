"""State and climate conversion to and from numpy.

Keys are the field names of the JAX package's ``Geometry`` and
``ModelState`` (geometry fields at the top level), so a state (the hybrid
chain's or an EISMINT II setup's) can be carried between the two packages
as a dict of numpy arrays; ``surface_to_numpy`` does the same for what a
surface model returns. An ensemble's batched state, every array with a
leading member axis (the layout ``jax.vmap`` takes and
``parallel.ensemble.stack_states`` builds), converts the same way, member
for member.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .state import Geometry, ModelState

_GEOMETRY = tuple(f.name for f in dataclasses.fields(Geometry))
_STATE = tuple(f.name for f in dataclasses.fields(ModelState)
               if f.name != "geometry")


def state_from_numpy(arrays: dict, device="cuda", dtype=torch.float64
                     ) -> ModelState:
    """ModelState from ``{field name: numpy array}``; floating fields get
    ``dtype``, integer fields (cell_type) keep theirs. Entries that are None
    (fields not set) are skipped; fields the port does not carry raise
    ValueError."""
    arrays = {k: v for k, v in arrays.items() if v is not None}
    unknown = set(arrays) - set(_GEOMETRY) - set(_STATE)
    if unknown:
        raise ValueError(f"fields not carried by pism_tpu_torch: {sorted(unknown)}")

    def tensor(a):
        a = np.asarray(a)
        dt = dtype if np.issubdtype(a.dtype, np.floating) else None
        return torch.tensor(a, dtype=dt, device=device)   # a copy

    geom = Geometry(**{k: tensor(arrays[k]) for k in _GEOMETRY})
    return ModelState(geometry=geom, **{
        k: tensor(arrays[k]) for k in _STATE if k in arrays})


def state_to_numpy(state: ModelState) -> dict:
    """``{field name: numpy array}`` of every field that is set."""
    out = {k: getattr(state.geometry, k).detach().cpu().numpy()
           for k in _GEOMETRY}
    for k in _STATE:
        v = getattr(state, k)
        if v is not None:
            out[k] = v.detach().cpu().numpy()
    return out


def surface_to_numpy(surface, state: ModelState, t: float) -> dict:
    """``{"smb": ..., "temperature": ...}`` of ``surface(geometry, t)``."""
    out = surface(state.geometry, t)
    return {"smb": out.smb.detach().cpu().numpy(),
            "temperature": out.temperature.detach().cpu().numpy()}
