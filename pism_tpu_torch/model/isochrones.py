"""Isochrone (deposition-layer) tracing (port of
``pism_tpu/model/isochrones.py``; PISM ``Isochrones``, the Born & Robinson
layer-tracing scheme): the ice column is split into layers bounded by
surfaces of constant deposition time. Accumulation feeds the active top
layer, surface melt takes layers from the top and basal melt from the
bottom, and each layer moves with its share of the column's mass flux
(upwinded); the stack is then rescaled to the new ice thickness.

The layer count is fixed. A new top layer activates when the step's time
reaches its deposition time; the JAX package decides that on the device
inside its loop, the port on the host from the float64 clock (``top`` is
a host int), so no step waits on the device for it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..ops.stencils import Shifter


class IsochroneState(NamedTuple):
    layers: torch.Tensor          # (My, Mx, NL) layer thicknesses [m]
    top: int                      # the active top layer
    deposition_times: np.ndarray  # (NL,) activation times [s] (inf: unused)


def deposition_times(config) -> list:
    """The deposition times [s] of the configuration: the upstream key
    ``isochrones.deposition_times`` when set, else
    ``age.isochrones.deposition_times`` (a PISM time list in model years),
    as the JAX ``IceModel`` reads them (``pism_tpu/model/icemodel.py:
    236-256``)."""
    from ..cli import parse_times

    spec = config.get_string("isochrones.deposition_times") \
        if config.is_set("isochrones.deposition_times") \
        else config.get_string("age.isochrones.deposition_times")
    return parse_times(spec, 3.15569259747e7) if spec else []


def n_layers(config) -> int:
    """``isochrones.bootstrapping.n_layers`` when set, else
    ``age.isochrones.n_layers``."""
    return config.get_int("isochrones.bootstrapping.n_layers") \
        if config.is_set("isochrones.bootstrapping.n_layers") \
        else config.get_int("age.isochrones.n_layers")


def times_array(n: int, dep) -> np.ndarray:
    """(n,) activation times: layer 0 at -inf's place (never activates),
    layers 1.. at the first n - 1 deposition times, the rest inf."""
    times = np.full((n,), np.inf)
    k = min(len(dep), n - 1)
    times[1:1 + k] = np.asarray(dep, np.float64)[:k]
    return times


@dataclass
class Isochrones:
    grid: object
    n_layers: int = 16

    def __post_init__(self):
        self.sh = Shifter(self.grid)

    def initialize(self, thickness, deposition_times_s) -> IsochroneState:
        """All current ice in layer 0; later layers activate at the given
        model times [s]."""
        layers = torch.zeros(tuple(thickness.shape) + (self.n_layers,),
                             dtype=thickness.dtype, device=thickness.device)
        layers[..., 0] = thickness
        return IsochroneState(layers=layers, top=0,
                              deposition_times=times_array(
                                  self.n_layers, deposition_times_s))

    @staticmethod
    def next_top(top: int, times: np.ndarray, t: float) -> int:
        """The active top layer after a substep starting at ``t`` [s, host
        float64]: the next layer once ``t`` reaches its deposition time."""
        nxt = min(top + 1, len(times) - 1)
        return nxt if t >= times[nxt] else top

    def step(self, iso: IsochroneState, t: float, dt, Qe, Qn, H_old, H_new,
             smb_applied, bmb_applied) -> IsochroneState:
        """Advance the layer stack by one mass-transport substep of ``dt``
        seconds. Qe, Qn: the total staggered flux [m^2/s] of the thickness
        transport; smb_applied / bmb_applied: rates [m/s] (+ adds at the
        surface / removes at the base)."""
        sh = self.sh
        dx, dy = self.grid.dx, self.grid.dy
        layers = iso.layers
        top = self.next_top(iso.top, iso.deposition_times, t)

        # horizontal transport: each layer's share of the total flux
        frac = layers / torch.clamp(H_old, min=1e-9)[..., None]
        frac_e = torch.where((Qe >= 0.0)[..., None], frac, sh(frac, 0, 1))
        frac_n = torch.where((Qn >= 0.0)[..., None], frac, sh(frac, 1, 0))
        Qe_l = Qe[..., None] * frac_e
        Qn_l = Qn[..., None] * frac_n
        div = (Qe_l - sh(Qe_l, 0, -1)) / dx + (Qn_l - sh(Qn_l, -1, 0)) / dy
        layers = torch.clamp(layers - dt * div, min=0.0)

        # the surface mass balance: accumulation on the top layer, melt
        # from the top down
        layers[..., top] = layers[..., top] + torch.clamp(smb_applied,
                                                          min=0.0) * dt
        remaining = torch.clamp(-smb_applied, min=0.0) * dt
        # layers above ``top`` are empty: the JAX loop's later passes take 0
        for li in range(top, -1, -1):
            take = torch.minimum(layers[..., li], remaining)
            layers[..., li] = layers[..., li] - take
            remaining = remaining - take

        # basal melt from the bottom up
        remaining = torch.clamp(bmb_applied, min=0.0) * dt
        for li in range(top + 1):
            take = torch.minimum(layers[..., li], remaining)
            layers[..., li] = layers[..., li] - take
            remaining = remaining - take

        # closure: rescale the stack to the evolved thickness
        total = torch.sum(layers, dim=-1)
        scale = torch.where(total > 1e-9,
                            H_new / torch.clamp(total, min=1e-9), 0.0)
        return IsochroneState(layers=layers * scale[..., None], top=top,
                              deposition_times=iso.deposition_times)

    @staticmethod
    def isochrone_depths(iso: IsochroneState, thickness=None):
        """Depth below the surface of each layer's upper boundary,
        (My, Mx, NL): the sum of the layers above it."""
        return isochrone_depth(iso.layers)


def isochrone_depth(layers: torch.Tensor) -> torch.Tensor:
    """(..., NL) depth of each layer's top below the ice surface."""
    rev = torch.flip(layers, dims=(-1,))
    return torch.flip(torch.cumsum(rev, dim=-1), dims=(-1,)) - layers
