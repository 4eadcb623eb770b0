"""Ensemble runs: members on a leading axis, run in lockstep (port of
``pism_tpu/parallel/ensemble.py``).

The JAX package runs an ensemble as one program, ``jax.vmap`` over its
jitted device loop: every member takes its own adaptive dt sequence, the
members advance in lockstep, and a member that is done is frozen by a
select. The port's step is driven from the host, so the member axis is
written out: an ensemble's state is the members' states stacked on a
leading axis (:func:`stack_states`, 2D fields ``(B, My, Mx)``, 3D fields
``(B, My, Mx, Mz)``), and :class:`EnsembleRunner` runs the model's twin
built with ``member_axis=True`` (``IceModel._advance_members``): one host
sync a lockstep step for the dt choice of every member, the SIA kernels
(K3, K4) launched once for all members, and in the hybrid ``ssa+sia`` chain
the SSA solve's kernels (K1, the Newton matvec, K2/K2b, the member dot)
too, each member converging on its own with one host read of a ``(B,)``
mask per lockstep decision.

Per-member parameters reach the model through the state, as in the JAX
package: a ``FunctionSurface`` hook reads the member's value from a field
it carries (``ice_area_specific_volume`` in the SIA chains, where part-grid
is off) and sees one member at a time; the hybrid chain's members differ in
their ``till_phi`` field, which Mohr-Coulomb reads. Every field of the
state is stacked, the SSA velocities and the PDD's snow and firn depths
(the surface carry) included.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Sequence

import torch

from .. import state as S


def _stack(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``torch.stack(xs)`` with each member laid out in memory as ``xs[0]``
    is (``torch.stack`` lays them out row-major): torch's reductions round
    by layout, so a member of a state whose enthalpy is level-major, as
    the energy step and ``load_state`` leave it, computes what the state
    alone computes."""
    x = xs[0]
    order = sorted(range(x.dim()), key=lambda i: -x.stride(i))
    back = [0] + [order.index(i) + 1 for i in range(x.dim())]
    return torch.stack([y.permute(order) for y in xs]).permute(back)


def stack_states(states: Sequence[S.ModelState]) -> S.ModelState:
    """Stack member states into one state with a leading member axis on
    every tensor field (the members must set the same fields), each laid
    out as the first member's."""
    def stack(get):
        xs = [get(s) for s in states]
        return None if xs[0] is None else _stack(xs)

    geom = S.Geometry(**{k.name: stack(
        lambda s, k=k: getattr(s.geometry, k.name))
        for k in dataclasses.fields(S.Geometry)})
    return S.ModelState(geometry=geom, **{
        k.name: stack(lambda s, k=k: getattr(s, k.name))
        for k in dataclasses.fields(S.ModelState) if k.name != "geometry"})


def broadcast_state(state: S.ModelState, n_members: int) -> S.ModelState:
    """One state replicated into an ``n_members`` batch (a copy per member,
    so that the members' fields can be written apart, each laid out as the
    state's field is)."""
    return S.map_tensors(state, lambda x: _stack([x] * n_members))


def member(state: S.ModelState, b: int) -> S.ModelState:
    """Member ``b`` of an ensemble's state (views)."""
    return S.map_tensors(state, lambda x: x[b])


@dataclass
class EnsembleGroups:
    """An ensemble placed on an ensemble mesh of several devices: the
    members of each device as one batched state, in member order."""

    states: List[S.ModelState] = field(default_factory=list)


@dataclass
class EnsembleRunner:
    """Run an ensemble of one model configuration.

    ``model``: an ``IceModel`` of the SIA chains (``stress_balance.model =
    sia``, ``energy.model = enthalpy`` or ``none``) whose surface has a
    member form (``Uniform``, ``FunctionSurface``), or of the hybrid chain
    (``setups.hybrid_ensemble_model``); the runner builds its member-axis
    twin per device. Other configurations raise NotImplementedError there
    (``IceModel``'s refusals, ROADMAP Queue 1 item 11)."""

    model: object

    def __post_init__(self):
        self._twins = {}
        self.twin(self.model.device)   # refuses what it cannot run now

    def twin(self, device):
        """The model's member-axis twin on ``device``."""
        device = torch.device(device)
        key = str(device)
        if key not in self._twins:
            self._twins[key] = dataclasses.replace(
                self.model, device=device, member_axis=True)
        return self._twins[key]

    def run_segment(self, batched_state, t0: float, t_end: float):
        """Advance every member from ``t0`` toward ``t_end``, at most
        ``time_stepping.max_steps_per_segment`` steps each, as the JAX
        runner's one device loop. Returns (state, a StepStats per member).
        ``batched_state``: a stacked state on one device, or the
        ``EnsembleGroups`` of :meth:`shard`, whose groups run one after
        another (each on its device) and come back as ``EnsembleGroups``."""
        if isinstance(batched_state, EnsembleGroups):
            out, stats = [], []
            for group in batched_state.states:
                st, s = self.run_segment(group, t0, t_end)
                out.append(st)
                stats += s
            return EnsembleGroups(out), stats
        device = batched_state.geometry.ice_thickness.device
        model = self.twin(device)
        state, ts, stats = model._advance_members(batched_state, t0, t_end)
        model._check_members(state, ts, stats)
        return state, stats

    def shard(self, batched_state, mesh):
        """Place the members on an ensemble mesh (``make_mesh(devices,
        ensemble=ne)``): consecutive members in ne groups, group e on the
        mesh's device e, as the JAX package shards the member axis over
        "e". Groups on one device are one batch, so a mesh of one device
        (``["cuda:0"] * 4``) returns the batched state there; distinct
        devices give ``EnsembleGroups``."""
        names = tuple(getattr(mesh, "axis_names", ()))
        if names[:1] != ("e",):
            raise NotImplementedError(
                "EnsembleRunner.shard takes an ensemble mesh "
                "(make_mesh(devices, ensemble=ne)); members over a (y, x) "
                "mesh are not implemented in pism_tpu_torch (ROADMAP Queue 1 "
                "item 11)")
        n = batched_state.geometry.ice_thickness.shape[0]
        ne = len(mesh.devices)
        if n % ne:
            raise ValueError(f"{n} members do not divide over {ne} devices")
        per = n // ne
        groups = []   # (device, first member, end)
        for e, dev in enumerate(mesh.devices):
            if groups and groups[-1][0] == dev:
                groups[-1][2] = (e + 1) * per
            else:
                groups.append([dev, e * per, (e + 1) * per])
        placed = [S.map_tensors(batched_state,
                                lambda x, a=a, b=b, d=d: x[a:b].to(d))
                  for d, a, b in groups]
        return placed[0] if len(placed) == 1 else EnsembleGroups(placed)
