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
minimal bedrock unit, or no energy model (``energy.model = none``, the
isothermal SIA with no 3D velocities); the SIA stress balance and, with
``ssa+sia``, the SSAFD solve, Mohr-Coulomb yield stress and null
hydrology; thickness calving with iceberg removal, ocean-kill calving
given as a ``calving`` component, or no calving; pointwise isostasy or no
bed deformation; part-grid mass transport with skip substeps; a stateful
PDD surface model or a stateless one; an optional constant ocean. Any
other configured component raises NotImplementedError.

``device`` (default ``"cuda"``) is where every field lives:
``prepare_state`` moves the state there, and on a machine without a card
torch raises rather than the model running on the CPU. ``mesh`` (a
``parallel.mesh.Mesh``) decomposes the kernel routes: the SSA matvec and
its JVP (K5) and the SIA flux kernels (K3/K4) run per shard on halo-padded
blocks, while every field stays whole on ``device``
(``pism_tpu/model/icemodel.py:146-150``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from .. import state as S
from ..config import Config, require
from ..grid import Grid
from ..ops import sia as sia_ops
from ..ops.sia3d import max_timestep_cfl_3d
from ..ops.stencils import Shifter
from ..physics.basal import MohrCoulombYieldStress
from ..physics.enthalpy_converter import EnthalpyConverter
from ..physics.hydrology import NullTransport
from ..physics.rheology import flow_law_from_config
from ..coupler.surface import SurfaceCarry
from ..util import hostsync
from . import geometry_evolution as ge
from .beddef import bed_deformation_from_config
from .btu import btu_from_config
from .calving import calving_from_config
from .energy import EnergyModel, bootstrap_enthalpy
from .ssa import SSAFD
from .stressbalance import StressBalance, StressBalanceResult

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
    limit_hits: List[int] = field(default_factory=lambda: [0] * len(DT_LIMITS))
    max_diffusivity: float = 0.0
    ssa_newton_iters: int = 0    # Newton sweeps over all SSA solves
    ssa_krylov_iters: int = 0    # BiCGStab iterations over all SSA solves
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
        limit_hits=[x + y for x, y in zip(a.limit_hits, b.limit_hits)],
        max_diffusivity=max(a.max_diffusivity, b.max_diffusivity),
        ssa_newton_iters=a.ssa_newton_iters + b.ssa_newton_iters,
        ssa_krylov_iters=a.ssa_krylov_iters + b.ssa_krylov_iters,
        host_syncs=a.host_syncs + b.host_syncs)


def _round_to(x: float, dtype) -> float:
    """A host float rounded to a field dtype (the JAX step casts dt so)."""
    return torch.tensor(x, dtype=dtype).item()


@dataclass
class IceModel:
    grid: Grid
    config: Config
    surface: object = None     # SurfaceModel: stateful (PDD) or stateless
    ocean: object = None       # OceanModel (sub-shelf melt), optional
    calving: object = None     # CalvingModel; default from the config
    device: object = "cuda"    # torch device of every field
    mesh: object = None        # ("y", "x") Mesh of the kernel routes

    def __post_init__(self):
        cfg = self.config
        self.device = torch.device(self.device)
        require(cfg, "runtime.float_dtype", ("float32", "float64"))
        require(cfg, "energy.model", ("enthalpy", "none"))
        if cfg.get_string("energy.model") == "none":
            # the isothermal SIA chain of the verification tests
            require(cfg, "stress_balance.model", ("sia",))
            require(cfg, "stress_balance.sia.flow_law", ("isothermal_glen",))
        require(cfg, "frontal_melt.models", ("", "none"))
        require(cfg, "ocean.always_grounded", (False,))
        require(cfg, "time_stepping.adaptive_timestepping", (True,))
        for flag in ("age.enabled", "age.isochrones.enabled",
                     "fracture_density.enabled"):
            require(cfg, flag, (False,))
        if cfg.get_number("time_stepping.dt_force") > 0.0:
            raise NotImplementedError(
                "time_stepping.dt_force > 0 is not implemented in pism_tpu_torch")
        if self.surface is None:
            raise NotImplementedError("pism_tpu_torch needs a surface model")
        self.stateful_surface = getattr(self.surface, "stateful", False)
        self.sh = Shifter(self.grid)
        self.EC = EnthalpyConverter.from_config(cfg)
        self.dtype = torch.float64 \
            if cfg.get_string("runtime.float_dtype") == "float64" else torch.float32
        self.energy_model = self.btu = None
        if cfg.get_string("energy.model") == "enthalpy":
            self.energy_model = EnergyModel(grid=self.grid, config=cfg,
                                            EC=self.EC)
            self.btu = btu_from_config(self.grid, cfg)
        # the SSA and what feeds it exist only with an SSA in the model
        # (pism_tpu/model/icemodel.py:185-206)
        self.ssa = self.yield_stress = self.hydrology = None
        if "ssa" in cfg.get_string("stress_balance.model"):
            self.ssa = SSAFD(grid=self.grid, config=cfg,
                             flow_law=flow_law_from_config(cfg, "ssa", self.EC),
                             mesh=self.mesh)
            self.yield_stress = MohrCoulombYieldStress(cfg)
            self.hydrology = NullTransport(grid=self.grid, config=cfg)
        if self.calving is None:
            self.calving = calving_from_config(self.grid, cfg)
        self.bed_deformation = bed_deformation_from_config(self.grid, cfg)
        self.geothermal = cfg.get_number("bootstrapping.defaults.geothermal_flux")
        self.stress_balance = StressBalance(
            grid=self.grid, config=cfg,
            sia_flow_law=flow_law_from_config(cfg, "sia", self.EC),
            ssa=self.ssa, compute_3d=self.energy_model is not None,
            mesh=self.mesh)

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

    # ------------------------------------------------------------------ step
    def _compute_dt(self, sb: StressBalanceResult, t: float, t_end: float):
        """Adaptive dt and the index of its binding limit (host floats).
        With skip, the mass-transport limits allow skip_max substeps per
        expensive update, so the step is skip_max times the mass limit."""
        grid = self.grid
        # the one sync of the dt choice: the maxima the limits need (the 3D
        # CFL limit exists only with the 3D velocities)
        maxima = [sb.max_diffusivity, torch.max(torch.abs(sb.u_face_e)),
                  torch.max(torch.abs(sb.v_face_n))]
        if sb.sia3 is not None:
            maxima += [sb.sia3.max_u, sb.sia3.max_v]
        vals = hostsync.host(torch.stack(maxima).to(torch.float64))
        max_D, max_ue, max_vn = vals[:3]
        cand = [math.inf] * len(DT_LIMITS)
        cand[0] = self.max_dt
        cand[1] = self.skip_max * sia_ops.max_timestep_diffusivity(
            max_D, grid.dx, grid.dy, self.adaptive_ratio)
        if self.ssa is not None:
            cand[2] = self.skip_max * (self.cfl_factor * ge.max_timestep_cfl_2d(
                max_ue, max_vn, grid.dx, grid.dy))
        if sb.sia3 is not None:
            cand[3] = self.cfl_factor * max_timestep_cfl_3d(
                vals[3], vals[4], grid.dx, grid.dy)
        if self.hydrology is not None:
            lim = self.hydrology.max_timestep()
            if lim is not None:
                cand[4] = lim
        cand[5] = self.surface.max_timestep(t)
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
        return min(dt, t_end - t), idx, max_D

    def _mass_substep(self, state, sb, smb, geometry, t, dt_sub,
                      qe_d=None, qn_d=None):
        """One mass-continuity substep with frozen sliding velocities; the
        SIA diffusive flux is recomputed from the current geometry unless
        supplied."""
        grid, sh = self.grid, self.sh
        if qe_d is None:
            flux = self.stress_balance.sia_flux(geometry, state.enthalpy)
            qe_d, qn_d = flux.qe, flux.qn
        qe_adv, qn_adv = ge.advective_flux(sb.u_face_e, sb.v_face_n,
                                           geometry.ice_thickness, sh)
        res = ge.flow_step(geometry, dt_sub, qe_d + qe_adv, qn_d + qn_adv,
                           grid, sh, part_grid=self.part_grid,
                           part_grid_iterations=self.part_grid_iters)
        geometry = geometry.replace(ice_area_specific_volume=res.Href)
        H = res.thickness
        bmb = torch.zeros_like(H)
        if state.basal_melt_rate is not None and self.use_bmr:
            bmb = bmb + state.basal_melt_rate
        if self.ocean is not None:
            shelf_melt = self.ocean(geometry, t)
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
        H, smb_app, bmb_app = ge.source_term_step(H, dt_sub, smb_eff, bmb,
                                                  grid.dx, grid.dy)
        geometry = S.ensure_consistency(geometry.replace(ice_thickness=H),
                                        self.rho_i, self.rho_w, self.Hmin,
                                        self.subgl)
        div_vol = torch.sum(res.flux_divergence) * grid.dx * grid.dy
        return geometry, (smb_app, bmb_app, div_vol, res.nonneg_flux)

    def _step(self, state: S.ModelState, t: float, t_end: float,
              stats: StepStats):
        dtype = state.geometry.ice_thickness.dtype

        # 1-2. stress balance and adaptive dt ------------------------------
        tau_c = None
        if self.yield_stress is not None:
            tau_c = self.yield_stress.compute(state, t=t)
        sb = self.stress_balance.update(state, tau_c)
        dt, dt_limit_idx, max_D = self._compute_dt(sb, t, t_end)
        dt_f = _round_to(dt, dtype)

        if self.stateful_surface:
            smb_in, carry = self.surface.update(
                state.geometry, t, dt_f,
                SurfaceCarry(snow=state.snow_depth, firn=state.firn_depth))
            state = state.replace(snow_depth=carry.snow, firn_depth=carry.firn)
        else:
            smb_in = self.surface(state.geometry, t)

        # 3. energy (enthalpy) step ---------------------------------------
        H = state.geometry.ice_thickness
        if self.energy_model is not None:
            G = state.geothermal_flux.to(dtype) \
                if state.geothermal_flux is not None \
                else torch.full_like(H, self.geothermal)
            _, G = self.btu.step(state.bedrock_temperature, None, G, dt_f)
            eres = self.energy_model.step(
                state, sb.sia3, smb_in.temperature, dt_f, geothermal_flux=G,
                frictional_heating=sb.basal_frictional_heating,
                tillwat=state.tillwat)
            state = state.replace(enthalpy=eres.enthalpy,
                                  basal_melt_rate=eres.basal_melt_rate)

        # 5. hydrology -----------------------------------------------------
        if self.hydrology is not None:
            state = self.hydrology.step(state, dt_f)

        # 7. mass transport, skip_max cheap substeps per expensive update --
        geometry = state.geometry
        zero = torch.zeros((), dtype=dtype, device=H.device)
        smb_app = bmb_app = div_vol = nonneg = zero
        if self.geometry_evolves:
            if self.skip_max > 1:
                dt_sub = _round_to(dt_f / self.skip_max, dtype)
                qe_f = None if self.refresh_diffusivity else sb.qe
                qn_f = None if self.refresh_diffusivity else sb.qn
                acc = (zero, zero, zero, zero)
                for _ in range(self.skip_max):
                    geometry, vals = self._mass_substep(
                        state, sb, smb_in.smb, geometry, t, dt_sub, qe_f, qn_f)
                    acc = tuple(a + v for a, v in zip(acc, vals))
                smb_app, bmb_app, div_vol, nonneg = \
                    (v / self.skip_max for v in acc)
            else:
                geometry, (smb_app, bmb_app, div_vol, nonneg) = \
                    self._mass_substep(state, sb, smb_in.smb, geometry, t,
                                       dt_f, sb.qe, sb.qn)

        # 8. calving and iceberg removal -----------------------------------
        discharge_vol = calving_vol = zero
        if self.calving is not None:
            cell_area = self.grid.dx * self.grid.dy
            geometry, calved = self.calving.step(geometry, with_parts=True)
            geometry = S.ensure_consistency(geometry, self.rho_i, self.rho_w,
                                            self.Hmin, self.subgl)
            discharge_vol = torch.sum(calved) * cell_area
            calving_vol = torch.sum(calved) * cell_area

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
            sum_calving=stats.sum_calving + calving_vol.to(f64),
            limit_hits=hits,
            max_diffusivity=max(stats.max_diffusivity, max_D),
            ssa_newton_iters=stats.ssa_newton_iters + sb.ssa_newton_iters,
            ssa_krylov_iters=stats.ssa_krylov_iters + sb.ssa_krylov_iters,
            host_syncs=stats.host_syncs)
        return state, t + dt, stats

    def _advance(self, state, t0: float, t_end: float):
        """One segment: at most ``time_stepping.max_steps_per_segment``
        steps toward t_end (the bound of the JAX device loop)."""
        syncs0 = hostsync.COUNT
        t, stats = t0, StepStats()
        while t < t_end - 1e-6 and stats.nsteps < self.max_steps:
            state, t, stats = self._step(state, t, t_end, stats)
        stats.host_syncs = hostsync.COUNT - syncs0
        return state, t, stats

    def prepare_state(self, state: S.ModelState) -> S.ModelState:
        """Move the state to the model's device and fill in the fields the
        chain's components need."""
        state = S.map_tensors(state, lambda x: x.to(self.device))
        state = state.replace(geometry=S.ensure_consistency(
            state.geometry, self.rho_i, self.rho_w, self.Hmin, self.subgl))
        H = state.geometry.ice_thickness
        z2 = torch.zeros_like(H)
        kw = {}
        if self.hydrology is not None and state.tillwat is None:
            kw["tillwat"] = z2
        if self.energy_model is not None and state.basal_melt_rate is None:
            kw["basal_melt_rate"] = z2
        if self.ssa is not None:
            if state.u_ssa is None:
                kw["u_ssa"] = z2
            if state.v_ssa is None:
                kw["v_ssa"] = z2
        if self.stateful_surface:
            if state.snow_depth is None:
                kw["snow_depth"] = z2
            if state.firn_depth is None:
                kw["firn_depth"] = z2
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
        return state.replace(**kw)

    # ------------------------------------------------------------------ API
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
