"""The model's time stepping (port of ``pism_tpu/model/icemodel.py`` for
the hybrid ``ssa+sia`` chain, the thermomechanical SIA-only chain and the
isothermal SIA chain of the verification tests): orders the sub-model
updates within a step and selects the adaptive time step as the min over
stability limits.

The JAX package runs a whole segment as one ``lax.while_loop`` on the
device (``pism_tpu/model/icemodel.py:776-791``). Here the step loop is a
host loop: model time ``t`` is a Python float (f64), and the time step is
chosen on the host from one sync per step that reads the five maxima the
stability limits need. Every other host decision is counted by
``util/hostsync.py``; ``StepStats.host_syncs`` reports them.

Components built here are exactly the chains': enthalpy energy with the
minimal bedrock unit or, with ``grid.Mbz > 1``, the full one (stepped
under the ice's basal temperature before the energy step; its column
from ``energy.bedrock_thermal.file``'s ``litho_temp`` or the steady
profile), or no energy model (``energy.model = none``: the isothermal
SIA, the manufactured tests' SIA on a prescribed enthalpy, or MISMIP's
isothermal ``ssa+sia``, with no 3D velocities, the dt chosen from the 2D
face velocities); the SIA stress balance with the Weertman sliding law
(``sliding_mu`` its per-cell coefficient) or a prescribed sliding
velocity (``prescribed_u``/``prescribed_v``, else
``stress_balance.prescribed_sliding.file``); with ``ssa`` or ``ssa+sia``
the SSAFD solve, or SSAFEM with ``stress_balance.ssa.method = fem``; with
``blatter`` the 3D Blatter-Pattyn solve instead of all of these (the 3D
velocities of the energy model its own); ``none`` moves the ice by its
SMB and carried velocities alone; with an SSA or Blatter, the yield
stress of
``basal_yield_stress.model`` (Mohr-Coulomb with ``topg_to_phi``, slippery
grounding lines and ``add_transportable_water``, constant, or given) and
the hydrology of ``hydrology.model`` (null, routing, distributed or
steady, stepped after the energy with the surface model's runoff); the
calving component of ``model/calving.py`` (thickness, ocean-kill and
float-kill calving, the eigen, von Mises and Hayhurst rate laws and a
frontal melt of ``frontal_melt.models`` with their front-retreat dt
limit, iceberg removal), or no calving; pointwise
isostasy, Lingle-Clark or no bed deformation; part-grid mass transport
with skip substeps; a stateful PDD surface model or a stateless one; an
optional ocean model (``constant``, ``pik``, PICO, evaluated in every
mass substep); an optional sea-level model, evaluated before each step's
dynamics; the column tracers and the damage field (``age.enabled``: the age
after the energy step, where the 3D velocities exist;
``age.isochrones.enabled``: the isochrone layers in every mass substep,
each new layer switched on by the host from the float64 clock;
``fracture_density.enabled``: the fracture step on the SSA velocity, with
the SSA's hardness for the stress criteria; the CH system through the
energy step), ordered as the JAX step orders them
(``pism_tpu/model/icemodel.py:529-552, :568-682``). Any other configured
component raises NotImplementedError.

``device`` (default ``"cuda"``) is where every field lives:
``prepare_state`` moves the state there, and on a machine without a card
torch raises rather than the model running on the CPU. ``mesh`` (a
``parallel.mesh.Mesh``) decomposes the kernel routes: the SSA matvec and
its JVP (K5) and the SIA flux kernels (K3/K4) run per shard on halo-padded
blocks, while every field stays whole on ``device``
(``pism_tpu/model/icemodel.py:146-150``). The Weertman and prescribed
sliding, Blatter, SSAFEM, a bedrock layer, a hydrology model other than
null and frontal melt raise NotImplementedError under a mesh.

``member_axis`` builds the model of an ensemble's members
(``parallel/ensemble.py``): every field has a leading member axis, the
members run in lockstep with a dt each (``_advance_members``, one host sync
a step of a ``(B, k)`` tensor of maxima, the host math of the dt choice per
member), and a member that reached the segment's end or its step bound is
frozen: its new values are computed and discarded, as the JAX package's
``vmap`` of its device loop selects (its SSA does not solve). It takes the
SIA chains, the hybrid ``ssa+sia`` chain and the PISM-PIK chain: the SSA
with per-member Newton and Krylov convergence, the yield stress, null
hydrology, a stateless surface with a member form (the PIK surface among
them) or the PDD (its snow and firn carried per member), an ocean model
with a member form (constant, PIK, PICO, their ``delta_T``),
``thickness_calving``, ``eigen_calving`` with its front-retreat dt limit
and iceberg removal, part-grid, the sub-grid grounding line, and
Lingle-Clark bed deformation (each member's gate on its own step end). A
mesh, sea level, pointwise isostasy, another calving method or float
kill, another stateful surface, the Weertman and prescribed sliding,
``ssa``, ``none``, Blatter and SSAFEM, a bedrock layer, a hydrology model
other than null, frontal melt, the age, the isochrones, the fracture
density and the CH system raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from .. import state as S
from ..config import Config, require
from ..grid import Grid
from ..ops import sia as sia_ops
from ..ops.sia3d import max_timestep_cfl_3d
from ..ops.stencils import Shifter
from ..parallel.mesh import is_sharded
from ..physics.basal import yield_stress_from_config
from ..physics.enthalpy_converter import EnthalpyConverter
from ..physics.hydrology import (Distributed, Routing, Steady,
                                 hydrology_from_config)
from ..physics.rheology import flow_law_from_config
from ..coupler.frontalmelt import frontal_melt_from_config
from ..coupler.pdd import TemperatureIndex
from ..coupler.surface import SurfaceCarry
from ..util import hostsync
from ..util.logger import log
from ..util.timecal import Time
from . import geometry_evolution as ge
from . import isochrones as iso_mod
from .age import AgeModel
from .beddef import LingleClark, bed_deformation_from_config
from .blatter import BlatterSolver
from .btu import BTUFull, btu_from_config
from .calving import CalvingModel, calving_from_config
from .energy import EnergyModel, bootstrap_enthalpy
from .fracture import FractureDensity
from .ssa import SSAFD
from .ssafem import SSAFEM
from .stressbalance import StressBalance, StressBalanceResult

class CellBudget(NamedTuple):
    """Per-cell time-integrated thickness changes [m] (dH convention, float64)
    for the spatial ``tendency_of_ice_amount_due_to_*`` diagnostics (PISM
    ``GeometryEvolution``'s per-cell conservation fields). The port fills it
    only in runs whose output asks for such a diagnostic."""
    flow: torch.Tensor
    smb: torch.Tensor
    bmb: torch.Tensor
    nonneg: torch.Tensor
    discharge: torch.Tensor
    # the discharge split per mechanism
    calving: torch.Tensor
    frontal_melt: torch.Tensor
    forced_retreat: torch.Tensor

    @staticmethod
    def zero(shape, device):
        z = torch.zeros(shape, dtype=torch.float64, device=device)
        return CellBudget(*(z,) * 8)


# Which adaptive-dt limit bound the step; indexes StepStats.limit_hits
DT_LIMITS = ("max_dt", "sia_diffusivity", "cfl_2d", "cfl_3d", "hydrology",
             "surface", "hit_multiples", "min_dt_floor", "end_of_segment",
             "front_retreat")


@dataclass
class StepStats:
    """Statistics accumulated over steps. Counts and time steps are host
    values; the volume sums stay on the device (float64)."""
    nsteps: int = 0
    dt_min: float = math.inf
    dt_max: float = 0.0
    sum_div_flux: object = 0.0   # time-integrated flux divergence [m^3]
    sum_smb: object = 0.0        # applied surface mass balance [m^3]
    sum_bmb: object = 0.0
    sum_nonneg: object = 0.0
    sum_discharge: object = 0.0  # calving and iceberg removal [m^3]
    sum_calving: object = 0.0
    sum_frontal_melt: object = 0.0    # frontal-melt retreat part [m^3]
    sum_forced_retreat: object = 0.0  # prescribed-retreat part [m^3]
    cell: Optional[CellBudget] = None  # per-cell budget (None = not tracked)
    limit_hits: List[int] = field(default_factory=lambda: [0] * len(DT_LIMITS))
    max_diffusivity: float = 0.0
    ssa_newton_iters: int = 0    # Newton sweeps over all SSA solves
    ssa_krylov_iters: int = 0    # BiCGStab iterations over all SSA solves
    # an ensemble member's: the sweeps and Newton-Krylov iterations the
    # lockstep of its segment ran (the same for every member)
    ssa_lockstep_newton: int = 0
    ssa_lockstep_krylov: int = 0
    host_syncs: int = 0

    def limit_hits_dict(self):
        """{limit_name: count} for the limits that ever bound."""
        return {n: c for n, c in zip(DT_LIMITS, self.limit_hits) if c > 0}


def _merge_stats(a: Optional[StepStats], b: StepStats) -> StepStats:
    if a is None:
        return b
    return StepStats(
        nsteps=a.nsteps + b.nsteps,
        dt_min=min(a.dt_min, b.dt_min), dt_max=max(a.dt_max, b.dt_max),
        sum_div_flux=a.sum_div_flux + b.sum_div_flux,
        sum_smb=a.sum_smb + b.sum_smb, sum_bmb=a.sum_bmb + b.sum_bmb,
        sum_nonneg=a.sum_nonneg + b.sum_nonneg,
        sum_discharge=a.sum_discharge + b.sum_discharge,
        sum_calving=a.sum_calving + b.sum_calving,
        sum_frontal_melt=a.sum_frontal_melt + b.sum_frontal_melt,
        sum_forced_retreat=a.sum_forced_retreat + b.sum_forced_retreat,
        cell=b.cell if a.cell is None else (
            a.cell if b.cell is None else CellBudget(
                *(x + y for x, y in zip(a.cell, b.cell)))),
        limit_hits=[x + y for x, y in zip(a.limit_hits, b.limit_hits)],
        max_diffusivity=max(a.max_diffusivity, b.max_diffusivity),
        ssa_newton_iters=a.ssa_newton_iters + b.ssa_newton_iters,
        ssa_krylov_iters=a.ssa_krylov_iters + b.ssa_krylov_iters,
        host_syncs=a.host_syncs + b.host_syncs)


class _Members:
    """The host bookkeeping of an ensemble's lockstep segment: each
    member's model time, step count, dt range, dt-limit hits, max(D), last
    dt and SSA Newton and Krylov counts on the host, and its volume sums on
    the device (float64, ``(5, B)``: flux divergence, SMB, BMB, the H >= 0
    clip, calving); and the SSA sweeps and Newton-Krylov iterations the
    lockstep ran, summed over its steps."""

    def __init__(self, n: int, t0: float, device):
        self.t = [t0] * n
        self.nsteps = [0] * n
        self.dt_min = [math.inf] * n
        self.dt_max = [0.0] * n
        self.hits = [[0] * len(DT_LIMITS) for _ in range(n)]
        self.max_D = [0.0] * n
        self.last_dt = [None] * n
        self.newton = [0] * n
        self.krylov = [0] * n
        self.lockstep_newton = self.lockstep_krylov = 0
        self.sums = torch.zeros((5, n), dtype=torch.float64, device=device)

    def add(self, sums, active):
        """Add a step's volumes (5, B) of the members ``active`` (B,)."""
        self.sums = self.sums + torch.where(active, sums, 0.0)

    def step(self, b: int, dt: float, idx: int, max_D: float,
             newton: int = 0, krylov: int = 0):
        """Member ``b`` took a step of ``dt`` bound by limit ``idx``, its
        SSA solve ``newton`` sweeps and ``krylov`` iterations."""
        self.nsteps[b] += 1
        self.dt_min[b] = min(self.dt_min[b], dt)
        self.dt_max[b] = max(self.dt_max[b], dt)
        self.hits[b][idx] += 1
        self.max_D[b] = max(self.max_D[b], max_D)
        self.t[b] += dt
        self.last_dt[b] = dt
        self.newton[b] += newton
        self.krylov[b] += krylov

    def stats(self, host_syncs: int):
        """A StepStats per member."""
        return [StepStats(nsteps=self.nsteps[b], dt_min=self.dt_min[b],
                          dt_max=self.dt_max[b],
                          sum_div_flux=self.sums[0, b],
                          sum_smb=self.sums[1, b], sum_bmb=self.sums[2, b],
                          sum_nonneg=self.sums[3, b],
                          sum_discharge=self.sums[4, b],
                          sum_calving=self.sums[4, b],
                          limit_hits=self.hits[b],
                          max_diffusivity=self.max_D[b],
                          ssa_newton_iters=self.newton[b],
                          ssa_krylov_iters=self.krylov[b],
                          ssa_lockstep_newton=self.lockstep_newton,
                          ssa_lockstep_krylov=self.lockstep_krylov,
                          host_syncs=host_syncs)
                for b in range(len(self.t))]


def _round_to(x: float, dtype) -> float:
    """A host float rounded to a field dtype (the JAX step casts dt so)."""
    return torch.tensor(x, dtype=dtype).item()


@dataclass
class IceModel:
    grid: Grid
    config: Config
    surface: object = None     # SurfaceModel: stateful (PDD) or stateless
    ocean: object = None       # OceanModel (sub-shelf melt), optional
    sea_level: object = None   # SeaLevelModel, optional
    calving: object = None     # CalvingModel; default from the config
    yield_stress: object = None  # with an SSA; default from the config
    device: object = "cuda"    # torch device of every field
    mesh: object = None        # ("y", "x") Mesh of the kernel routes
    member_axis: bool = False  # fields carry an ensemble's member axis
    # per-cell linear sliding coefficient of the Weertman branch (EISMINT
    # II experiment E's sector) [m s^-1 Pa^-1]
    sliding_mu: object = None
    # the sliding velocity of prescribed_sliding[+sia] [m/s]; read from
    # stress_balance.prescribed_sliding.file when not given
    prescribed_u: object = None
    prescribed_v: object = None
    frontal_melt: object = None   # FrontalMeltModel; default from the config

    def __post_init__(self):
        cfg = self.config
        self.device = torch.device(self.device)
        self.lead = 1 if self.member_axis else 0
        require(cfg, "runtime.float_dtype", ("float32", "float64"))
        require(cfg, "energy.model", ("enthalpy", "none"))
        sb_model = cfg.get_string("stress_balance.model")
        if cfg.get_string("energy.model") == "none" and "ssa" in sb_model:
            # MISMIP's isothermal ssa+sia
            require(cfg, "stress_balance.ssa.flow_law", ("isothermal_glen",))
        require(cfg, "ocean.always_grounded", (False,))
        require(cfg, "time_stepping.adaptive_timestepping", (True,))
        if self.member_axis:
            for flag in ("age.enabled", "age.isochrones.enabled",
                         "fracture_density.enabled",
                         "energy.ch_warming.enabled"):
                if cfg.get_flag(flag):
                    raise NotImplementedError(
                        f"{flag} in an ensemble is not implemented in "
                        "pism_tpu_torch (ROADMAP Queue 1 item 3)")
        if cfg.get_number("time_stepping.dt_force") > 0.0:
            raise NotImplementedError(
                "time_stepping.dt_force > 0 is not implemented in pism_tpu_torch")
        if self.surface is None:
            raise NotImplementedError("pism_tpu_torch needs a surface model")
        self.stateful_surface = getattr(self.surface, "stateful", False)
        self.midpoint_surface = getattr(self.surface, "midpoint_sampling",
                                        False)
        self.sh = Shifter(self.grid, self.lead)
        self.EC = EnthalpyConverter.from_config(cfg)
        self.dtype = torch.float64 \
            if cfg.get_string("runtime.float_dtype") == "float64" else torch.float32
        self.energy_model = self.btu = None
        if cfg.get_string("energy.model") == "enthalpy":
            self.energy_model = EnergyModel(grid=self.grid, config=cfg,
                                            EC=self.EC, lead=self.lead)
            self.btu = btu_from_config(self.grid, cfg)
            for what, present, item in (
                    ("an ensemble", self.member_axis, "3"),
                    ("a mesh", is_sharded(self.mesh), "10")):
                if present and isinstance(self.btu, BTUFull):
                    raise NotImplementedError(
                        f"a bedrock thermal layer (grid.Mbz > 1) in {what} "
                        "is not implemented in pism_tpu_torch (ROADMAP "
                        f"Queue 1 item {item})")
        # the SSA and what feeds it exist only with an SSA in the model
        # (pism_tpu/model/icemodel.py:185-206)
        self.ssa = self.hydrology = self.blatter = None
        if sb_model == "blatter":
            # the Blatter flow law when its key is set, else the SSA's
            # (pism_tpu/model/icemodel.py:169-184)
            self.blatter = BlatterSolver(
                grid=self.grid, config=cfg, flow_law=flow_law_from_config(
                    cfg, "blatter" if cfg.is_set("stress_balance.blatter."
                                                 "flow_law") else "ssa",
                    self.EC))
        if "ssa" in sb_model:
            require(cfg, "stress_balance.ssa.method", ("fd", "fem"))
            ssa_cls = SSAFEM if cfg.get_string(
                "stress_balance.ssa.method") == "fem" else SSAFD
            self.ssa = ssa_cls(grid=self.grid, config=cfg,
                               flow_law=flow_law_from_config(cfg, "ssa",
                                                             self.EC),
                               mesh=self.mesh, lead=self.lead)
        if self.ssa is not None or self.blatter is not None:
            if self.yield_stress is None:
                self.yield_stress = yield_stress_from_config(cfg, self.grid)
            self.hydrology = hydrology_from_config(self.grid, cfg,
                                                   self.device)
        if self.frontal_melt is None:
            self.frontal_melt = frontal_melt_from_config(cfg)
        for what, present, item in (
                ("an ensemble", self.member_axis, "3"),
                ("a mesh", is_sharded(self.mesh), "10")):
            if present and isinstance(self.hydrology,
                                      (Routing, Distributed, Steady)):
                raise NotImplementedError(
                    "hydrology.model = "
                    f"{cfg.get_string('hydrology.model')!r} in {what} is not "
                    "implemented in pism_tpu_torch (ROADMAP Queue 1 item "
                    f"{item})")
            if present and self.frontal_melt is not None:
                raise NotImplementedError(
                    f"frontal melt in {what} is not implemented in "
                    f"pism_tpu_torch (ROADMAP Queue 1 item {item})")
        if self.calving is None:
            self.calving = calving_from_config(self.grid, cfg, self.lead,
                                               self.device)
            if self.calving is None and self.frontal_melt is not None:
                # frontal melt needs the front retreat with no calving law
                self.calving = CalvingModel(grid=self.grid, config=cfg,
                                            lead=self.lead, methods=("none",))
        elif self.calving.lead != self.lead:
            # a model's calving taken to its member-axis twin, or back
            self.calving = dataclasses.replace(self.calving, lead=self.lead)
        # the front-retreat rate dt limit (either config name enables it)
        self.front_retreat_cfl = self.calving is not None and (
            cfg.get_flag("calving.front_retreat.use_cfl")
            or cfg.get_flag("geometry.front_retreat.use_cfl"))
        self.bed_deformation = bed_deformation_from_config(self.grid, cfg)
        # the column tracers and the damage field
        # (pism_tpu/model/icemodel.py:236-267)
        self.isochrones = self.fracture = self.age_model = None
        if cfg.get_flag("age.isochrones.enabled"):
            self._iso_dep_times = iso_mod.deposition_times(cfg)
            self.isochrones = iso_mod.Isochrones(
                grid=self.grid, n_layers=iso_mod.n_layers(cfg))
            self._iso_times = iso_mod.times_array(self.isochrones.n_layers,
                                                  self._iso_dep_times)
        if cfg.get_flag("fracture_density.enabled"):
            self.fracture = FractureDensity(
                grid=self.grid, config=cfg,
                bc_mask=getattr(self.ssa, "bc_mask", None))
        if cfg.get_flag("age.enabled"):
            self.age_model = AgeModel(grid=self.grid, config=cfg)
        self.geothermal = cfg.get_number("bootstrapping.defaults.geothermal_flux")
        if sb_model.startswith("prescribed_sliding") \
                and self.prescribed_u is None:
            path = cfg.get_string("stress_balance.prescribed_sliding.file")
            if path:
                from ..io.bootstrap import read_and_regrid
                flds = read_and_regrid(path, self.grid,
                                       ["u_ssa", "v_ssa", "ubar", "vbar"])
                self.prescribed_u = flds.get("u_ssa", flds.get("ubar"))
                self.prescribed_v = flds.get("v_ssa", flds.get("vbar"))

        def on_device(x):
            return None if x is None else torch.as_tensor(x, device=self.device)
        self.stress_balance = StressBalance(
            grid=self.grid, config=cfg,
            sia_flow_law=flow_law_from_config(cfg, "sia", self.EC),
            ssa=self.ssa, blatter=self.blatter,
            compute_3d=self.energy_model is not None,
            mesh=self.mesh, lead=self.lead,
            sliding_mu=on_device(self.sliding_mu),
            prescribed_u=on_device(self.prescribed_u),
            prescribed_v=on_device(self.prescribed_v))
        if self.energy_model is not None and not self.stress_balance.has_sia \
                and self.blatter is None:
            raise ValueError(
                f"stress_balance.model = {sb_model!r} has no SIA 3D "
                "velocities for energy.model = enthalpy")

        self.rho_i = cfg.get_number("constants.ice.density")
        self.rho_w = cfg.get_number("constants.sea_water.density")
        self.Hmin = cfg.get_number("geometry.ice_free_thickness_standard")
        self.adaptive_ratio = cfg.get_number("time_stepping.adaptive_ratio")
        self.max_dt = cfg.get_number("time_stepping.maximum_time_step", "seconds")
        self.min_dt = cfg.get_number("time_stepping.minimum_time_step", "seconds")
        self.resolution = cfg.get_number("time_stepping.resolution", "seconds")
        self.hit_multiples = cfg.get_number("time_stepping.hit_multiples",
                                            "seconds")
        self.cfl_factor = cfg.get_number("time_stepping.cfl_factor")
        self.geometry_evolves = cfg.get_flag("geometry.update.enabled")
        self.use_smb = cfg.get_flag("geometry.update.use_surface_mass_balance")
        self.use_bmr = cfg.get_flag("geometry.update.use_basal_melt_rate")
        self.bmr_grounded_frac = cfg.get_flag(
            "energy.basal_melt.use_grounded_cell_fraction")
        self.part_grid = cfg.get_flag("geometry.part_grid.enabled")
        self.part_grid_iters = cfg.get_int("geometry.part_grid.max_iterations")
        self.subgl = cfg.get_flag("geometry.grounded_cell_fraction")
        self.skip_max = cfg.get_int("time_stepping.skip.max") \
            if cfg.get_flag("time_stepping.skip.enabled") else 1
        self.refresh_diffusivity = cfg.get_flag(
            "time_stepping.skip.refresh_diffusivity")
        self.max_steps = cfg.get_int("time_stepping.max_steps_per_segment")
        if self.member_axis:
            # the calving model refuses its other methods on the member
            # axis, the surfaces, the atmosphere and the ocean their missing
            # member forms when called
            for what, present in (
                    ("a mesh", self.mesh is not None),
                    ("a sea-level model", self.sea_level is not None),
                    ("a stateful surface model other than the PDD",
                     self.stateful_surface
                     and not isinstance(self.surface, TemperatureIndex)),
                    ("bed deformation other than Lingle-Clark",
                     self.bed_deformation is not None
                     and not isinstance(self.bed_deformation, LingleClark))):
                if present:
                    raise NotImplementedError(
                        f"{what} in an ensemble is not implemented in "
                        "pism_tpu_torch (ROADMAP Queue 1 item 3)")

    # ------------------------------------------------------------------ step
    def _dt_maxima(self, sb: StressBalanceResult, front_retreat_rate=None):
        """The maxima the dt limits need, stacked on the last axis: (k,),
        or (B, k) on the member axis (the 3D CFL limit exists only with the
        3D velocities)."""
        maxima = [sb.max_diffusivity,
                  S.member_max(torch.abs(sb.u_face_e), self.lead),
                  S.member_max(torch.abs(sb.v_face_n), self.lead)]
        if sb.sia3 is not None:
            maxima += [sb.sia3.max_u, sb.sia3.max_v]
        if front_retreat_rate is not None:
            maxima.append(front_retreat_rate)
        return torch.stack(maxima, dim=-1).to(torch.float64)

    def _compute_dt(self, sb: StressBalanceResult, t: float, t_end: float,
                    front_retreat_rate=None):
        """Adaptive dt, the index of its binding limit and max(D) (host
        floats), from one sync. ``front_retreat_rate`` is the calving
        front's max retreat rate (a 0-dim tensor), read in the same sync."""
        vals = hostsync.host(self._dt_maxima(sb, front_retreat_rate))
        dt, idx = self._choose_dt(
            vals, t, t_end, None if front_retreat_rate is None
            else front_retreat_rate.dtype)
        return dt, idx, vals[0]

    def _choose_dt(self, vals, t: float, t_end: float, front_retreat_dtype=None):
        """The dt choice's host math from the host maxima ``vals`` (of one
        member): the stability limits, resolution rounding, hit_multiples,
        the min dt floor and the segment's end. With skip, the
        mass-transport limits allow skip_max substeps per expensive update,
        so the step is skip_max times the mass limit."""
        grid = self.grid
        max_D, max_ue, max_vn = vals[:3]
        cand = [math.inf] * len(DT_LIMITS)
        cand[0] = self.max_dt
        if self.stress_balance.has_sia:
            cand[1] = self.skip_max * sia_ops.max_timestep_diffusivity(
                max_D, grid.dx, grid.dy, self.adaptive_ratio)
        if self.stress_balance.model not in ("sia", "none"):
            # the sliding velocity's limit (the SSA's, Weertman's, the
            # prescribed field's, Blatter's vertical mean)
            cand[2] = self.skip_max * (self.cfl_factor * ge.max_timestep_cfl_2d(
                max_ue, max_vn, grid.dx, grid.dy))
        if self.stress_balance.compute_3d:
            cand[3] = self.cfl_factor * max_timestep_cfl_3d(
                vals[3], vals[4], grid.dx, grid.dy)
        if self.hydrology is not None:
            lim = self.hydrology.max_timestep()
            if lim is not None:
                cand[4] = lim
        cand[5] = self.surface.max_timestep(t)
        if front_retreat_dtype is not None:
            cand[9] = self.calving.max_timestep_from_rate(
                vals[-1], front_retreat_dtype)
        idx = min(range(len(cand)), key=cand.__getitem__)
        dt = cand[idx]
        res = self.resolution
        if res > 0.0 and math.isfinite(dt):
            # round dt down to a whole multiple (the 1e-3 tolerance keeps
            # reduction-order noise from flipping whole multiples)
            dt_r = math.floor(dt / res + 1e-3) * res
            if dt_r >= res:
                dt = dt_r
        hit = self.hit_multiples
        if hit > 0.0:
            next_mult = (math.floor(t / hit + 1e-9) + 1.0) * hit
            if next_mult - t <= dt:
                dt, idx = next_mult - t, 6
        if not math.isfinite(dt) or dt < self.min_dt:
            idx = 7
        dt = max(dt, self.min_dt) if math.isfinite(dt) else self.min_dt
        if t_end - t <= dt:
            idx = 8
        return min(dt, t_end - t), idx

    def _mass_substep(self, state, sb, smb, geometry, t, dt_sub,
                      qe_d=None, qn_d=None, cells=False, iso=None):
        """One mass-continuity substep with frozen sliding velocities; the
        SIA diffusive flux is recomputed from the current geometry unless
        supplied. With ``cells`` the returned values also hold the per-cell
        flow, SMB, BMB and clip rates. ``iso``: the isochrones'
        ``IsochroneState``, stepped with the limited flux and the applied
        rates at the step's start ``t`` (as the JAX step passes it).
        Returns (geometry, values, iso)."""
        grid, sh = self.grid, self.sh
        if qe_d is None and self.stress_balance.has_sia:
            flux = self.stress_balance.sia_flux(geometry, state.enthalpy)
            qe_d, qn_d = flux.qe, flux.qn
        elif qe_d is None:
            qe_d = qn_d = torch.zeros_like(geometry.ice_thickness)
        qe_adv, qn_adv = ge.advective_flux(sb.u_face_e, sb.v_face_n,
                                           geometry.ice_thickness, sh)
        res = ge.flow_step(geometry, dt_sub, qe_d + qe_adv, qn_d + qn_adv,
                           grid, sh, part_grid=self.part_grid,
                           part_grid_iterations=self.part_grid_iters,
                           fields=cells)
        geometry = geometry.replace(ice_area_specific_volume=res.Href)
        H = res.thickness
        bmb = torch.zeros_like(H)
        if state.basal_melt_rate is not None and self.use_bmr:
            bmb = bmb + state.basal_melt_rate
        if self.ocean is not None:
            shelf_melt = self.ocean.members(geometry, t) if self.lead \
                else self.ocean(geometry, t)
            floating = S.floating_ice(geometry.cell_type)
            if self.bmr_grounded_frac and self.subgl:
                # sub-shelf melt acts on the floating part of partially
                # grounded grounding-line cells
                f = geometry.cell_grounded_fraction
                w = torch.where(floating, 1.0, 1.0 - f)
                w = torch.where(S.icy(geometry.cell_type), w, 0.0)
                bmb = bmb + w * shelf_melt
            else:
                bmb = bmb + torch.where(floating, shelf_melt, 0.0)
        smb_eff = smb if self.use_smb else torch.zeros_like(H)
        src = ge.source_term_step(H, dt_sub, smb_eff, bmb, grid.dx, grid.dy,
                                  fields=cells, lead=self.lead)
        H, smb_app, bmb_app = src[:3]
        if iso is not None:
            iso = self.isochrones.step(iso, t, dt_sub, res.Qe, res.Qn,
                                       geometry.ice_thickness, H, smb_eff, bmb)
        geometry = S.ensure_consistency(geometry.replace(ice_thickness=H),
                                        self.rho_i, self.rho_w, self.Hmin,
                                        self.subgl, self.lead)
        div_vol = S.member_sum(res.flux_divergence, self.lead) \
            * grid.dx * grid.dy
        vals = (smb_app, bmb_app, div_vol, res.nonneg_flux)
        if cells:
            vals += (res.flow_field, src[3], src[4], res.nonneg_field)
        return geometry, vals, iso

    def _step(self, state: S.ModelState, t: float, t_end: float,
              stats: StepStats):
        dtype = state.geometry.ice_thickness.dtype

        # 0. sea-level forcing, before the dynamics, so the flotation mask
        # sees the current value --------------------------------------------
        if self.sea_level is not None:
            geom = state.geometry
            sl = self.sea_level(geom, t).to(dtype).expand(geom.sea_level.shape)
            state = state.replace(geometry=S.ensure_consistency(
                geom.replace(sea_level=sl), self.rho_i, self.rho_w, self.Hmin,
                self.subgl))

        # 1-2. stress balance and adaptive dt ------------------------------
        tau_c = None
        if self.yield_stress is not None:
            tau_c = self.yield_stress.compute(state, t=t)
        wcp = None
        if self.ocean is not None:
            # melange back-pressure modifiers raise the front water-column
            # pressure; None is the hydrostatic default in the SSA
            wcp = self.ocean.water_column_pressure(state.geometry, t)
        sb = self.stress_balance.update(state, tau_c,
                                        water_column_pressure=wcp, t=t)
        fr_rate = None
        if self.front_retreat_cfl:
            fr_rate = self.calving.max_rate(
                state.geometry, sb, hardness_B=self._calving_hardness(state),
                frontal_melt_rate=self._frontal_melt(state.geometry, t, state))
        dt, dt_limit_idx, max_D = self._compute_dt(sb, t, t_end, fr_rate)
        dt_f = _round_to(dt, dtype)

        if self.stateful_surface:
            smb_in, carry = self.surface.update(
                state.geometry, t, dt_f,
                SurfaceCarry(snow=state.snow_depth, firn=state.firn_depth,
                             albedo=state.surface_albedo))
            state = state.replace(snow_depth=carry.snow, firn_depth=carry.firn,
                                  surface_albedo=carry.albedo)
        elif self.midpoint_surface:
            # piecewise-constant file forcing: the step's value is the
            # record covering the interval's midpoint (GivenStreamed)
            smb_in = self.surface(state.geometry, t + 0.5 * dt)
        else:
            smb_in = self.surface(state.geometry, t)

        cells = stats.cell is not None
        dt_sub = _round_to(dt_f / self.skip_max, dtype) \
            if self.skip_max > 1 else dt_f
        state, geometry, vals = self._energy_and_mass(state, sb, smb_in, t,
                                                      dt_f, dt_sub, cells,
                                                      t_next=t + dt)
        zero = torch.zeros((), dtype=dtype, device=geometry.ice_thickness.device)
        smb_app, bmb_app, div_vol, nonneg = vals[:4]

        # 8. calving, front retreat and iceberg removal ---------------------
        discharge_vol = zero
        parts_vol = (zero,) * 3
        discharge = parts = None
        if self.calving is not None:
            cell_area = self.grid.dx * self.grid.dy
            C_pre = geometry.ice_thickness + geometry.ice_area_specific_volume
            geometry, parts = self.calving.step(
                geometry, sb, dt_f, t=t,
                hardness_B=self._calving_hardness(
                    state.replace(geometry=geometry)),
                frontal_melt_rate=self._frontal_melt(geometry, t, state),
                with_parts=True)
            geometry = S.ensure_consistency(geometry, self.rho_i, self.rho_w,
                                            self.Hmin, self.subgl)
            # the ice content removed (H + Href, so that partial-cell
            # conversions do not count; <= 0)
            discharge = geometry.ice_thickness \
                + geometry.ice_area_specific_volume - C_pre
            discharge_vol = torch.sum(discharge) * cell_area
            parts_vol = tuple(torch.sum(parts[k]) * cell_area for k in (
                "calving", "frontal_melt", "forced_retreat"))

        state = state.replace(geometry=geometry, u_ssa=sb.u_ssa, v_ssa=sb.v_ssa)

        # 9. bed deformation -----------------------------------------------
        if self.bed_deformation is not None:
            state = self.bed_deformation.step(state, dt_f, t=t + dt_f)
            state = state.replace(geometry=S.ensure_consistency(
                state.geometry, self.rho_i, self.rho_w, self.Hmin))

        f64 = torch.float64
        hits = list(stats.limit_hits)
        hits[dt_limit_idx] += 1
        stats = StepStats(
            nsteps=stats.nsteps + 1,
            dt_min=min(stats.dt_min, dt), dt_max=max(stats.dt_max, dt),
            sum_div_flux=stats.sum_div_flux + (dt_f * div_vol).to(f64),
            sum_smb=stats.sum_smb + (dt * smb_app).to(f64),
            sum_bmb=stats.sum_bmb + (dt * bmb_app).to(f64),
            sum_nonneg=stats.sum_nonneg + (dt * nonneg).to(f64),
            sum_discharge=stats.sum_discharge + discharge_vol.to(f64),
            sum_calving=stats.sum_calving + parts_vol[0].to(f64),
            sum_frontal_melt=stats.sum_frontal_melt + parts_vol[1].to(f64),
            sum_forced_retreat=stats.sum_forced_retreat
            + parts_vol[2].to(f64),
            cell=self._add_cells(stats.cell, dt, vals[4:], discharge, parts),
            limit_hits=hits,
            max_diffusivity=max(stats.max_diffusivity, max_D),
            ssa_newton_iters=stats.ssa_newton_iters + sb.ssa_newton_iters,
            ssa_krylov_iters=stats.ssa_krylov_iters + sb.ssa_krylov_iters,
            host_syncs=stats.host_syncs)
        return state, t + dt, stats

    def _energy_and_mass(self, state, sb, smb_in, t, dt_f, dt_sub, cells,
                         t_next=None):
        """The step's energy, hydrology and mass transport (skip_max cheap
        substeps of ``dt_sub`` per expensive update): (state, geometry,
        vals), vals the volume rates of ``_mass_substep`` (0-dim, or per
        member). ``dt_f``, ``dt_sub``: host floats in the field dtype, or
        per-member tensors of it shaped (B, 1, 1); ``t_next`` the step's
        end time (the steady hydrology's interval test)."""
        # 3. energy (enthalpy) step ---------------------------------------
        H = state.geometry.ice_thickness
        dtype = H.dtype
        if self.energy_model is not None:
            G = state.geothermal_flux.to(dtype) \
                if state.geothermal_flux is not None \
                else torch.full_like(H, self.geothermal)
            if state.bedrock_temperature is not None:
                # the bedrock column under the ice's basal temperature; its
                # top flux is the ice's lower boundary condition
                T_base = self.EC.temperature(state.enthalpy[..., 0],
                                             self.EC.pressure(H))
                bed_T, G = self.btu.step(state.bedrock_temperature, T_base,
                                         G, dt_f)
                state = state.replace(bedrock_temperature=bed_T)
            eres = self.energy_model.step(
                state, sb.sia3, smb_in.temperature, dt_f, geothermal_flux=G,
                frictional_heating=sb.basal_frictional_heating,
                tillwat=state.tillwat, ch_enthalpy=state.ch_enthalpy,
                surface_melt=smb_in.melt)
            state = state.replace(enthalpy=eres.enthalpy,
                                  basal_melt_rate=eres.basal_melt_rate)
            if eres.ch_enthalpy is not None:
                state = state.replace(ch_enthalpy=eres.ch_enthalpy)

        # 4. age transport, where the 3D velocities exist -------------------
        if self.age_model is not None and state.age is not None \
                and sb.sia3 is not None:
            state = state.replace(age=self.age_model.step(state, sb.sia3,
                                                          dt_f))

        # 4b. fracture density on the membrane velocity ---------------------
        if self.fracture is not None and state.fracture_density is not None \
                and sb.u_ssa is not None:
            hard = None
            if (self.fracture.max_shear or self.fracture.lefm) \
                    and self.ssa is not None:
                hard = self.ssa._hardness(state)
            fres = self.fracture.step(state, sb.u_ssa, sb.v_ssa, dt_f,
                                      hardness=hard)
            state = state.replace(fracture_density=fres.density,
                                  fracture_age=fres.age)

        # 5. hydrology -----------------------------------------------------
        if self.hydrology is not None:
            kw = {}
            if self.hydrology.input_from_runoff:
                # the surface model's runoff feeds the subglacial system
                kw["runoff"] = smb_in.runoff
            if isinstance(self.hydrology, Steady):
                kw["t"] = t_next
            state = self.hydrology.step(state, dt_f, **kw)

        # 7. mass transport, skip_max cheap substeps per expensive update --
        geometry = state.geometry
        zero = torch.zeros(H.shape[:self.lead], dtype=dtype, device=H.device)
        vals = (zero,) * 4 + ((torch.zeros_like(H),) * 4 if cells else ())
        iso = None
        if self.isochrones is not None and state.iso_layers is not None:
            iso = iso_mod.IsochroneState(state.iso_layers, state.iso_top,
                                         self._iso_times)
        if self.geometry_evolves:
            if self.skip_max > 1:
                qe_f = None if self.refresh_diffusivity else sb.qe
                qn_f = None if self.refresh_diffusivity else sb.qn
                acc = vals
                for _ in range(self.skip_max):
                    geometry, vals, iso = self._mass_substep(
                        state, sb, smb_in.smb, geometry, t, dt_sub, qe_f, qn_f,
                        cells=cells, iso=iso)
                    acc = tuple(a + v for a, v in zip(acc, vals))
                vals = tuple(v / self.skip_max for v in acc)
            else:
                geometry, vals, iso = self._mass_substep(
                    state, sb, smb_in.smb, geometry, t, dt_f, sb.qe, sb.qn,
                    cells=cells, iso=iso)
        if iso is not None:
            state = state.replace(iso_layers=iso.layers, iso_top=iso.top)
        return state, geometry, vals

    def _frontal_melt(self, geometry, t, state):
        """The frontal-melt rate [m/s] on ``geometry`` at ``t`` (the
        discharge models read ``state``'s hydrology), else None."""
        if self.frontal_melt is None:
            return None
        return self.frontal_melt(geometry, t, state=state)

    def _calving_hardness(self, state):
        """The vertically averaged hardness the von Mises law needs (from
        the SSA's flow law), else None."""
        if self.calving is not None and self.ssa is not None \
                and "vonmises_calving" in self.calving.methods:
            return self.ssa._hardness(state)
        return None

    @staticmethod
    def _add_cells(cell, dt, fields, discharge, parts):
        """The per-cell budget after a step of ``dt`` seconds: the rates of
        the mass transport times dt, the calving's discharge and its split
        per mechanism."""
        if cell is None:
            return None
        f64 = torch.float64
        flow, smb, bmb, nonneg = (dt * f.to(f64) for f in fields)
        if discharge is None:
            return cell._replace(flow=cell.flow + flow, smb=cell.smb + smb,
                                 bmb=cell.bmb + bmb,
                                 nonneg=cell.nonneg + nonneg)
        return CellBudget(flow=cell.flow + flow, smb=cell.smb + smb,
                          bmb=cell.bmb + bmb, nonneg=cell.nonneg + nonneg,
                          discharge=cell.discharge + discharge,
                          calving=cell.calving + parts["calving"],
                          frontal_melt=cell.frontal_melt
                          + parts["frontal_melt"],
                          forced_retreat=cell.forced_retreat
                          + parts["forced_retreat"])

    def _advance(self, state, t0: float, t_end: float, cells: bool = False):
        """One segment: at most ``time_stepping.max_steps_per_segment``
        steps toward t_end (the bound of the JAX device loop); ``cells``
        fills the per-cell budget of the returned stats."""
        syncs0 = hostsync.COUNT
        t = t0
        stats = StepStats(cell=CellBudget.zero(
            self.grid.shape2, self.device) if cells else None)
        while t < t_end - 1e-6 and stats.nsteps < self.max_steps:
            state, t, stats = self._step(state, t, t_end, stats)
        stats.host_syncs = hostsync.COUNT - syncs0
        return state, t, stats

    # ------------------------------------------------------- member axis
    def _advance_members(self, state, t0: float, t_end: float):
        """One segment of an ensemble's members in lockstep, the JAX
        package's ``vmap`` of its device loop
        (``pism_tpu/model/icemodel.py:776-791``): while any member is below
        ``t_end`` and its bound of ``time_stepping.max_steps_per_segment``
        steps, every member steps, each with its own dt, and the others are
        frozen. Returns (state, the members' times, their StepStats; each
        one's ``host_syncs`` counts the segment's)."""
        syncs0 = hostsync.COUNT
        run = _Members(state.geometry.ice_thickness.shape[0], t0, self.device)
        while True:
            active = [t < t_end - 1e-6 and n < self.max_steps
                      for t, n in zip(run.t, run.nsteps)]
            if not any(active):
                break
            state = self._step_members(state, t_end, active, run)
        return state, run.t, run.stats(hostsync.COUNT - syncs0)

    def _step_members(self, state, t_end: float, active, run: "_Members"):
        """One lockstep step, ``_step``'s order for every member: the yield
        stress and the stress balance (the SSA of the active members, each
        converging on its own), one host sync of the ``(B, k)`` maxima,
        each member's dt chosen on the host as ``_compute_dt`` chooses it (a
        frozen member takes its last dt, so its discarded values stay
        finite), one copy of the members' times and time steps to the
        device, the surface (the PDD with each member's time, dt and
        carry), the energy and mass steps with a dt per member, calving
        and iceberg removal, the bed deformation (and ``_step``'s mask
        update after it, without the sub-grid rule), and the frozen
        members' old values kept."""
        dtype = state.geometry.ice_thickness.dtype
        tau_c = None
        if self.yield_stress is not None:
            tau_c = self.yield_stress.compute(state)
        sb = self.stress_balance.update(state, tau_c, active=active)
        fr_rate = fr_dtype = None
        if self.front_retreat_cfl:
            fr_rate = self.calving.max_rate(state.geometry, sb)
            fr_dtype = fr_rate.dtype
        rows = hostsync.host(self._dt_maxima(sb, fr_rate))
        dts, idxs = [], []
        for b, row in enumerate(rows):
            if active[b]:
                dt, idx = self._choose_dt(row, run.t[b], t_end, fr_dtype)
            else:
                dt, idx = run.last_dt[b], None
                if dt is None:
                    dt = self._choose_dt(row, run.t[b], math.inf,
                                         fr_dtype)[0]
            dts.append(dt)
            idxs.append(idx)
        # dt in the field dtype, and the substep's, rounded per member as
        # _round_to rounds a host float
        field = np.float32 if dtype == torch.float32 else np.float64
        dt_f = np.asarray(dts).astype(field).astype(np.float64)
        dt_sub = (dt_f / self.skip_max).astype(field).astype(np.float64) \
            if self.skip_max > 1 else dt_f
        host = torch.tensor(np.stack([np.asarray(run.t), dt_f, dt_sub,
                                      np.asarray(active, np.float64)]))
        t_d, dt_d, sub_d, act_d = host.to(self.device).unbind(0)
        n = len(rows)
        dt_t = dt_d.to(dtype)
        old = state
        if self.stateful_surface:
            smb_in, carry = self.surface.members_update(
                state.geometry, run.t, dt_f.tolist(),
                SurfaceCarry(snow=state.snow_depth, firn=state.firn_depth))
            state = state.replace(snow_depth=carry.snow, firn_depth=carry.firn)
        else:
            smb_in = self.surface.members(state.geometry, t_d)
        new, geometry, vals = self._energy_and_mass(
            state, sb, smb_in, None, dt_t.view(n, 1, 1),
            sub_d.to(dtype).view(n, 1, 1), False)
        discharge = torch.zeros_like(dt_t)
        if self.calving is not None:
            C_pre = geometry.ice_thickness + geometry.ice_area_specific_volume
            geometry = S.ensure_consistency(
                self.calving.step(geometry, sb, dt_t.view(n, 1, 1)),
                self.rho_i, self.rho_w, self.Hmin, self.subgl, self.lead)
            discharge = S.member_sum(
                geometry.ice_thickness + geometry.ice_area_specific_volume
                - C_pre, 1) * (self.grid.dx * self.grid.dy)
        new = new.replace(geometry=geometry, u_ssa=sb.u_ssa, v_ssa=sb.v_ssa)
        if self.bed_deformation is not None:
            # each member's gate on its own step end, as _step's
            ends = [t + d for t, d in zip(run.t, dt_f.tolist())]
            new = self.bed_deformation.members_step(new, dt_f.tolist(), ends,
                                                    active)
            new = new.replace(geometry=S.ensure_consistency(
                new.geometry, self.rho_i, self.rho_w, self.Hmin,
                lead=self.lead))
        act = act_d > 0.0
        state = new if all(active) else S.select_members(act, new, old)
        smb_app, bmb_app, div_vol, nonneg = vals[:4]
        run.add(torch.stack([dt_t * div_vol, dt_t * smb_app, dt_t * bmb_app,
                             dt_t * nonneg, discharge]).to(torch.float64), act)
        for b in range(n):
            if active[b]:
                solve = (sb.ssa_newton_iters[b], sb.ssa_krylov_iters[b]) \
                    if self.ssa is not None else (0, 0)
                run.step(b, dts[b], idxs[b], rows[b][0], *solve)
        run.lockstep_newton += sb.ssa_lockstep_newton
        run.lockstep_krylov += sb.ssa_lockstep_krylov
        return state

    def _check_members(self, state, ts, stats) -> None:
        """The segment-boundary checks of ``_check_state`` and the
        diffusivity stop for every member of an ensemble, from one host
        read; a failing member is named."""
        H = state.geometry.ice_thickness
        f64 = torch.float64
        cols = [S.member_max(H, 1).to(f64),
                torch.isnan(H).flatten(1).any(1).to(f64)]
        if state.u_ssa is not None:
            cols.append(torch.isnan(state.u_ssa).flatten(1).any(1).to(f64))
        if state.enthalpy is not None and self.energy_model is not None:
            cols.append(self._n_low_temperature(state).to(f64))
        rows = hostsync.host(torch.stack(cols, dim=-1))
        for b, (row, t, st) in enumerate(zip(rows, ts, stats)):
            try:
                member = S.map_tensors(state, lambda x: x[b])
                self._check_thickness(member, row[0])
                self._check_health(member, t, row)
                self._check_diffusivity(st)
            except RuntimeError as err:
                raise RuntimeError(f"ensemble member {b}: {err}") from err

    def prepare_state(self, state: S.ModelState) -> S.ModelState:
        """Move the state to the model's device and fill in the fields the
        chain's components need."""
        state = S.map_tensors(state, lambda x: x.to(self.device))
        state = state.replace(geometry=S.ensure_consistency(
            state.geometry, self.rho_i, self.rho_w, self.Hmin, self.subgl))
        H = state.geometry.ice_thickness
        z2 = torch.zeros_like(H)
        kw = {}
        if self.hydrology is not None:
            if state.tillwat is None:
                kw["tillwat"] = z2
            if isinstance(self.hydrology, Routing) and state.hydro_W is None:
                kw["hydro_W"] = z2
            if isinstance(self.hydrology, Distributed) \
                    and state.hydro_P is None:
                # the water pressure starts at overburden
                kw["hydro_P"] = self.rho_i * self.config.get_number(
                    "constants.standard_gravity") * H
            if isinstance(self.hydrology, Steady) and state.hydro_Q is None:
                kw["hydro_Q"] = z2
            if not isinstance(self.hydrology, Steady) \
                    and state.hydro_Q is not None:
                # a stored steady discharge would otherwise shadow the live
                # hydrology in the frontal melt forever
                kw["hydro_Q"] = None
        if self.energy_model is not None and state.basal_melt_rate is None:
            kw["basal_melt_rate"] = z2
        if self.age_model is not None and state.age is None:
            # age.initial_value: a uniform initial age
            age0 = self.config.get_number("age.initial_value", "seconds")
            kw["age"] = torch.full(tuple(H.shape) + (self.grid.Mz,), age0,
                                   dtype=H.dtype, device=H.device)
        if self.fracture is not None:
            if state.fracture_density is None:
                kw["fracture_density"] = z2
            if state.fracture_age is None:
                kw["fracture_age"] = z2
        if self.isochrones is not None and state.iso_layers is None:
            iso0 = self.isochrones.initialize(H, self._iso_dep_times)
            kw["iso_layers"], kw["iso_top"] = iso0.layers, iso0.top
            self._iso_times = iso0.deposition_times
        if self.stress_balance.model not in ("sia", "none"):
            if state.u_ssa is None:
                kw["u_ssa"] = z2
            if state.v_ssa is None:
                kw["v_ssa"] = z2
        if self.stateful_surface:
            if state.snow_depth is None:
                kw["snow_depth"] = z2
            if state.firn_depth is None:
                kw["firn_depth"] = z2
            if getattr(self.surface, "uses_albedo", False) \
                    and state.surface_albedo is None:
                # the innermost model's initial albedo (dEBM: albedo_max)
                base = self.surface
                while not hasattr(base, "initial_albedo") \
                        and getattr(base, "inner", None) is not None:
                    base = base.inner
                kw["surface_albedo"] = torch.full_like(
                    H, getattr(base, "initial_albedo", 0.8))
        if state.till_phi is None \
                and getattr(self.yield_stress, "t2p_enabled", False):
            # PISM -topg_to_phi: the friction angle from the initial bed
            kw["till_phi"] = self.yield_stress.topg_to_phi(
                state.geometry.bed_elevation)
        if self.calving is not None and "ocean_kill" in self.calving.methods \
                and self.calving.ocean_kill_mask is None:
            okf = self.config.get_string("calving.ocean_kill.file")
            if okf:
                # cells with thk <= 0 in the file form the kill mask
                from ..io.bootstrap import read_and_regrid
                flds = read_and_regrid(okf, self.grid,
                                       ["thk", "land_ice_thickness"])
                thk = flds.get("thk", flds.get("land_ice_thickness"))
                if thk is None:
                    raise ValueError(f"{okf!r} has no thk variable")
                self.calving.ocean_kill_mask = torch.as_tensor(
                    np.nan_to_num(thk) <= 0.0, device=self.device)
            else:
                # PISM's default: the input's ice-free ocean; here the
                # initial state's
                self.calving.ocean_kill_mask = \
                    state.geometry.cell_type == S.MASK_ICE_FREE_OCEAN
        if self.bed_deformation is not None and state.bed_reference is None:
            state = self.bed_deformation.initialize(state.replace(**kw))
            kw = {}
        if self.energy_model is not None and state.enthalpy is None:
            smb = self.surface(state.geometry, 0.0)
            G0 = state.geothermal_flux if state.geothermal_flux is not None \
                else self.geothermal
            kw["enthalpy"] = bootstrap_enthalpy(
                self.grid, self.EC, H, smb.temperature,
                geothermal=G0).to(H.dtype)
        if isinstance(self.btu, BTUFull) and state.bedrock_temperature is None:
            kw["bedrock_temperature"] = self._initial_bedrock_temperature(
                state, kw.get("enthalpy", state.enthalpy))
        if self.energy_model is not None and self.energy_model.ch_enabled \
                and state.ch_enthalpy is None:
            # the CH system starts in thermal equilibrium with the ice
            E0 = kw.get("enthalpy", state.enthalpy)
            if E0 is not None:
                kw["ch_enthalpy"] = E0
        return state.replace(**kw)

    def _initial_bedrock_temperature(self, state, E0):
        """``energy.bedrock_thermal.file``'s ``litho_temp`` (its last
        record) where that key is set, else the steady conductive column
        under the ice's basal temperature (JAX
        ``pism_tpu/model/icemodel.py:920-945``)."""
        H = state.geometry.ice_thickness
        path = self.config.get_string("energy.bedrock_thermal.file")
        if path:
            from ..io.nc4 import File
            with File(path, "r") as f:
                if not f.has_variable("litho_temp"):
                    raise ValueError(f"{path!r} has no litho_temp")
                lt = np.asarray(f.read("litho_temp"), float)
            if lt.ndim == 4:
                lt = lt[-1]
            return torch.as_tensor(lt, dtype=H.dtype, device=H.device)
        T_base = self.EC.temperature(E0[..., 0], self.EC.pressure(H))
        G0 = state.geothermal_flux if state.geothermal_flux is not None \
            else self.geothermal
        return self.btu.init_temperature(T_base, G0)

    # ------------------------------------------------------------- checks
    def _check_state(self, state: S.ModelState, t: float,
                     format: str = "netcdf4") -> None:
        """The segment-boundary checks of ``_check_thickness`` and
        ``_check_health`` from one host read."""
        H = state.geometry.ice_thickness
        vals = [torch.max(H).to(torch.float64),
                torch.isnan(H).any().to(torch.float64)]
        if state.u_ssa is not None:
            vals.append(torch.isnan(state.u_ssa).any().to(torch.float64))
        if state.enthalpy is not None and self.energy_model is not None:
            vals.append(self._n_low_temperature(state).to(torch.float64))
        vals = hostsync.host(torch.stack(vals))
        self._check_thickness(state, vals[0])
        self._check_health(state, t, vals, format)

    def _n_low_temperature(self, state):
        """Ice cells below ``energy.minimum_allowed_temperature``."""
        T_min = self.config.get_number("energy.minimum_allowed_temperature")
        H = state.geometry.ice_thickness
        z = torch.as_tensor(self.grid.z, dtype=H.dtype, device=H.device)
        H3 = H[..., None]
        p = self.EC.pressure(torch.clamp(H3 - z, min=0.0))
        T = self.EC.temperature(state.enthalpy, p)
        in_ice = (z <= H3) & S.icy(state.geometry.cell_type)[..., None]
        return S.member_sum(in_ice & (T < T_min), self.lead)

    def _check_health(self, state: S.ModelState, t: float, vals,
                      format: str = "netcdf4") -> None:
        """Non-finite state detection at segment boundaries: PISM's SSAFD
        failure path dumps the state to ``SSAFD_failed.nc`` (in the run's
        output format) and aborts; a broken solve surfaces here as NaNs.
        Too many ice cells below ``energy.minimum_allowed_temperature``
        (beyond ``energy.max_low_temperature_count``) abort the run too.
        ``vals`` is ``_check_state``'s host read."""
        bad = vals[1] > 0 or (state.u_ssa is not None and vals[2] > 0)
        if bad:
            from ..io import checkpoint as ckpt
            path = "SSAFD_failed.nc"
            try:
                ckpt.save_state(path, state, self.grid, t, config=self.config,
                                format=format)
            except Exception:
                path = "(state dump failed)"
            raise RuntimeError(
                "non-finite model state at t = "
                f"{t / 3.15569259747e7:.3f} a (solver failure); "
                f"state dumped to {path}")
        if state.enthalpy is not None and self.energy_model is not None:
            n_low = int(vals[-1])
            n_max = self.config.get_int("energy.max_low_temperature_count")
            if n_low > n_max:
                T_min = self.config.get_number(
                    "energy.minimum_allowed_temperature")
                raise RuntimeError(
                    f"{n_low} ice cells below "
                    f"energy.minimum_allowed_temperature ({T_min:.1f} K) "
                    f"at t = {t / 3.15569259747e7:.3f} a (limit {n_max})")

    def _check_thickness(self, state: S.ModelState, Hmax: float) -> None:
        """PISM aborts when the ice reaches the top of the computational box
        (``IceModel::check_maximum_ice_thickness``) or exceeds
        ``geometry.ice_thickness.max``; ``Hmax`` is the largest thickness."""
        H_cap = self.config.get_number("geometry.ice_thickness.max")
        if H_cap > 0.0 and Hmax > H_cap:
            raise RuntimeError(
                f"ice thickness ({Hmax:.1f} m) exceeds "
                f"geometry.ice_thickness.max ({H_cap:.1f} m)")
        if self.energy_model is None and self.age_model is None:
            return
        if Hmax >= self.grid.Lz:
            raise RuntimeError(
                f"ice thickness ({Hmax:.1f} m) reaches the top of the "
                f"computational box (Lz = {self.grid.Lz:.1f} m); increase "
                "grid.Lz (PISM aborts identically)")

    def _check_diffusivity(self, stats: StepStats) -> None:
        """PISM's SIAFD max_diffusivity stop: without the limit_diffusivity
        cap, a diffusivity beyond the sanity limit stops the run unless
        max_diffusivity_allow_unlimited."""
        cfg = self.config
        if (self.stress_balance.has_sia
                and self.stress_balance.d_limit is None
                and not cfg.get_flag(
                    "stress_balance.sia.max_diffusivity_allow_unlimited")):
            d_cap = cfg.get_number("stress_balance.sia.max_diffusivity")
            d_seen = stats.max_diffusivity
            if d_seen > d_cap:
                raise RuntimeError(
                    f"SIA diffusivity ({d_seen:.1f} m2/s) exceeds "
                    f"stress_balance.sia.max_diffusivity ({d_cap:.1f}); "
                    "set stress_balance.sia.limit_diffusivity or "
                    "max_diffusivity_allow_unlimited (PISM stops "
                    "identically)")

    # ------------------------------------------------------------------ API
    def run(self, state: S.ModelState, time: Time,
            segment_seconds: Optional[float] = None,
            callback: Optional[Callable] = None,
            output: Optional[object] = None,
            signals: Optional[object] = None):
        """Advance from ``time.start`` to ``time.end``; returns (state,
        StepStats of the whole run, or None if no segment ran).

        Segments last ``runtime.segment_years`` and end on ``output``'s next
        requested time (an ``OutputManager``), so records land exactly.
        After each segment the state is checked (thickness, NaNs, cold
        ice, the SIA diffusivity stop), ``output.process`` and
        ``callback(state, t, stats)`` run, and ``signals`` (a
        ``SignalMonitor``) is polled: SIGUSR1 writes a backup, SIGTERM ends
        the run after the segment (PISM ``IceModel::process_signals``)."""
        if segment_seconds is None:
            segment_seconds = self.config.get_number("runtime.segment_years",
                                                     "seconds")
        fmt = output.format if output is not None \
            else self.config.get_string("output.format")
        state = self.prepare_state(state)
        self._check_thickness(
            state, hostsync.host(torch.max(state.geometry.ice_thickness)))
        t = time.start
        total = None
        cells = False
        if output is not None:
            output.start(state, t, self)
            cells = output.needs_cell_budget
        while t < time.end - 1e-6:
            t_seg = min(t + segment_seconds, time.end)
            if output is not None:
                t_seg = min(t_seg, output.next_time(t))
            state, t, stats = self._advance(state, t, t_seg, cells=cells)
            self._check_state(state, t, fmt)
            self._check_diffusivity(stats)
            total = _merge_stats(total, stats)
            if output is not None:
                output.process(state, t, self, stats=total)
            if callback is not None:
                callback(state, t, stats)
            if signals is not None:
                if signals.take_backup_request() and output is not None:
                    output.write_backup(state, t)
                if signals.stop_requested():
                    log.message(1, "caught SIGTERM: stopping at t = %.2f a",
                                t / 3.15569259747e7)
                    break
        return state, total

    def step_once(self, state: S.ModelState, t: float, dt_cap: float):
        """Advance by up to dt_cap seconds (adaptive steps inside); returns
        (state, t, StepStats)."""
        state = self.prepare_state(state)
        t_end = t + dt_cap
        total = None
        while True:
            state, t, stats = self._advance(state, t, t_end)
            total = _merge_stats(total, stats)
            if t >= t_end - 1e-6 or stats.nsteps == 0:
                break
        return state, t, total
