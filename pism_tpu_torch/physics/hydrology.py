"""Subglacial hydrology (port of ``pism_tpu/physics/hydrology.py``):

- ``NullTransport``: the till-water-layer ODE only (every model runs it):
  dW_till/dt = (rho_i/rho_w) m_b + surface input - C, clipped to
  [0, W_max], no transport;
- ``Routing``: lateral routing of a transportable water layer W along the
  hydraulic potential psi = rho_w g b + rho_i g H, explicit upwind steps
  subcycled on the water-advection CFL condition, fed by the till layer's
  overflow;
- ``Distributed``: the routing transport with an evolving water pressure P
  (cavity opening and creep closure), psi = P + rho_w g b;
- ``Steady``: the water input routed instantaneously down the potential
  (a steepest-descent flow-accumulation fixed point), the steady discharge
  that feeds the ``DischargeRouting`` frontal melt.

The JAX package runs the subcycle and the fixed point as
``lax.while_loop``s on the device. Here both are host loops:

- the subcycle reads the wave speed once a substep (one host sync) and
  forms the substep on the host in the field dtype, as the JAX loop forms
  it on the device (``t_done`` and the clip in W's dtype), so that the
  substep count is the JAX package's; ``SUBCYCLES`` counts the substeps;
- the fixed point reads its change flag once per
  ``hostsync.CHECK_EVERY`` sweeps (a fixed point stays fixed, so the
  sweeps run after convergence change nothing) and stops at exactly
  ``hydrology.steady_max_iterations`` sweeps when it never converges;
  ``STEADY_SWEEPS`` counts the sweeps.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import state as S
from ..model.geometry_evolution import limit_flux
from ..ops import stencils as st
from ..ops.stencils import Shifter
from ..util import hostsync

#: substeps of the routing and distributed subcycles (a counter)
SUBCYCLES = 0
#: sweeps of the steady model's fixed point (a counter)
STEADY_SWEEPS = 0


@dataclass
class NullTransport:
    """PISM ``hydrology::NullTransport``."""

    grid: object
    config: object

    #: optional prescribed surface water input rate [m/s] (from
    #: hydrology.surface_input.file, variable water_input_rate)
    surface_input: object = None

    def __post_init__(self):
        cfg = self.config
        self.W_max = cfg.get_number("hydrology.tillwat_max")
        self.C = cfg.get_number("hydrology.tillwat_decay_rate", "m s-1")
        self.rho_i = cfg.get_number("constants.ice.density")
        self.rho_w = cfg.get_number("constants.fresh_water.density")
        self.decay_grounded_only = cfg.get_flag(
            "hydrology.tillwat_decay_rate_grounded_only")
        self.add_to_till = cfg.get_flag(
            "hydrology.add_water_input_to_till_storage")
        self.input_from_runoff = cfg.get_flag(
            "hydrology.surface_input_from_runoff")
        self._dt_max = cfg.get_number("hydrology.maximum_time_step", "seconds")

    def max_timestep(self):
        """hydrology.maximum_time_step (<= 0 disables)."""
        return self._dt_max if self._dt_max > 0.0 else None

    def _water_input(self, state, W, runoff=None):
        """Total water input rate [m/s]: basal melt, plus the surface input
        field and the surface model's runoff where configured."""
        m_b = state.basal_melt_rate
        if m_b is None:
            m_b = torch.zeros_like(W)
        inflow = (self.rho_i / self.rho_w) * m_b
        if self.surface_input is not None:
            inflow = inflow + self.surface_input.to(W.dtype)
        if self.input_from_runoff and runoff is not None:
            inflow = inflow + runoff.to(W.dtype)
        return inflow

    def step(self, state: S.ModelState, dt, runoff=None) -> S.ModelState:
        """The till layer over ``dt`` (a host float, or an ensemble's
        ``(B, 1, 1)`` tensor); ``runoff`` the surface model's [m/s]."""
        W = state.tillwat
        if W is None:
            W = torch.zeros_like(state.geometry.ice_thickness)
        inflow = self._water_input(state, W, runoff)
        if not self.add_to_till:
            # the input bypasses the till (Routing sends it to the
            # transport layer); the till still decays
            inflow = torch.zeros_like(W)
        mask = state.geometry.cell_type
        decay = self.C
        if self.decay_grounded_only:
            decay = torch.where(S.grounded_ice(mask), torch.full_like(W, self.C),
                                0.0)
        W = torch.clamp(W + dt * (inflow - decay), 0.0, self.W_max)
        # no till water under floating ice or ocean
        W = torch.where(S.ocean(mask), 0.0, W)
        return state.replace(tillwat=W)


@dataclass
class Routing(NullTransport):
    """PISM ``hydrology::Routing``: lateral routing of a transportable
    water layer along psi = rho_w g b + rho_i g H, explicit upwind steps
    subcycled on the water-advection CFL condition, each substep at least
    ``dt / max_subcycles`` long."""

    max_subcycles: int = 1024

    def __post_init__(self):
        super().__post_init__()
        cfg = self.config
        self.cfl_factor = cfg.get_number("hydrology.routing.cfl_factor")
        self.k = cfg.get_number("hydrology.hydraulic_conductivity")
        # the reference names win when set; hydrology.alpha/beta are the
        # short aliases
        self.alpha = cfg.get_number("hydrology.thickness_power_in_flux") \
            if cfg.is_set("hydrology.thickness_power_in_flux") \
            else cfg.get_number("hydrology.alpha")
        self.beta_exp = cfg.get_number("hydrology.gradient_power_in_flux") \
            if cfg.is_set("hydrology.gradient_power_in_flux") \
            else cfg.get_number("hydrology.beta")
        self.include_floating = cfg.get_flag(
            "hydrology.routing.include_floating_ice")
        self.g = cfg.get_number("constants.standard_gravity")
        self.sh = Shifter(self.grid)

    def _face_gradients(self, psi):
        """Staggered potential gradients and face gradient magnitudes."""
        grid, sh = self.grid, self.sh
        dpx = st.grad_x_east(psi, grid.dx, sh)
        dpy = st.grad_y_north(psi, grid.dy, sh)
        gpe = torch.sqrt(dpx ** 2 + st.grad_y_east(psi, grid.dy, sh) ** 2) \
            + 1e-12
        gpn = torch.sqrt(st.grad_x_north(psi, grid.dx, sh) ** 2 + dpy ** 2) \
            + 1e-12
        return dpx, dpy, gpe, gpn

    def _wave_speed(self, W, gpe, gpn):
        """Upper bound on the kinematic wave speed dq/dW = k a W^(a-1)
        g^(b-1), a 0-dim tensor of W's dtype."""
        gmax = torch.maximum(torch.max(gpe), torch.max(gpn))
        return self.k * self.alpha * torch.clamp(torch.max(W), min=1e-12) \
            ** (self.alpha - 1.0) * gmax ** (self.beta_exp - 1.0)

    def _fluxes(self, W, grads):
        """Upwind face fluxes q = -k W^alpha |grad psi|^(beta-2) grad psi."""
        dpx, dpy, gpe, gpn = grads
        sh = self.sh
        We = torch.where(dpx <= 0.0, W, sh(W, 0, 1))
        Wn = torch.where(dpy <= 0.0, W, sh(W, 1, 0))
        qe = -(self.k * We ** self.alpha * gpe ** (self.beta_exp - 2.0)) * dpx
        qn = -(self.k * Wn ** self.alpha * gpn ** (self.beta_exp - 2.0)) * dpy
        return qe, qn

    def _transport(self, W, overflow, dt_sub, grads):
        """W's tendency over a substep: the overflow less the divergence of
        the donor-cell-limited fluxes."""
        grid = self.grid
        qe, qn = self._fluxes(W, grads)
        qe, qn = limit_flux(qe, qn, W, dt_sub, grid.dx, grid.dy, self.sh)
        return overflow - st.div_staggered(qe, qn, grid.dx, grid.dy, self.sh)

    def _cfl_subcycle(self, dt, W0, potential_fn, substep_fn, extra0=None,
                      static=False):
        """Advance W (and ``extra``) over ``dt`` seconds (a host float of
        the field dtype) in CFL-bounded substeps: ``potential_fn(W, extra)
        -> psi`` (evaluated once when ``static``), ``substep_fn(W, extra,
        dt_sub, grads) -> (W, extra)`` with ``dt_sub`` a host float. The
        substep is formed in W's dtype: clip(cfl dx_min / v, dt /
        max_subcycles, dt - t_done), v the wave speed (one host sync)."""
        global SUBCYCLES
        ft = np.float32 if W0.dtype == torch.float32 else np.float64
        dt_n = ft(dt)
        dt_floor = dt_n / ft(self.max_subcycles)
        c = ft(self.cfl_factor * min(self.grid.dx, self.grid.dy))
        tiny = ft(1e-30)
        W, extra = W0, extra0
        grads = None
        t_done = ft(0.0)
        while t_done < dt_n:
            if grads is None or not static:
                grads = self._face_gradients(potential_fn(W, extra))
            v = ft(hostsync.host(self._wave_speed(W, grads[2], grads[3])))
            dt_sub = min(max(c / max(v, tiny), dt_floor), dt_n - t_done)
            W, extra = substep_fn(W, extra, float(dt_sub), grads)
            t_done = ft(t_done + dt_sub)
            SUBCYCLES += 1
        return W, extra

    def _ocean(self, cell_type):
        """Where no water is routed: the ocean, or (with
        ``hydrology.routing.include_floating_ice``) the open ocean only."""
        if self.include_floating:
            return cell_type == S.MASK_ICE_FREE_OCEAN
        return S.ocean(cell_type)

    def step(self, state: S.ModelState, dt, runoff=None) -> S.ModelState:
        state = NullTransport.step(self, state, dt, runoff)   # till first
        H = state.geometry.ice_thickness
        b = state.geometry.bed_elevation
        W = state.hydro_W if state.hydro_W is not None else torch.zeros_like(H)
        # the till layer's overflow feeds the transportable layer; with
        # add_water_input_to_till_storage off, all the input bypasses it
        inflow = self._water_input(state, W, runoff)
        overflow = torch.where(state.tillwat >= self.W_max, inflow, 0.0) \
            if self.add_to_till else inflow
        psi = self.rho_w * self.g * b + self.rho_i * self.g * H
        ocean = self._ocean(state.geometry.cell_type)

        def substep(W, extra, dt_sub, grads):
            W_new = torch.clamp(
                W + dt_sub * self._transport(W, overflow, dt_sub, grads),
                min=0.0)
            return torch.where(ocean, 0.0, W_new), extra

        W, _ = self._cfl_subcycle(dt, W, lambda W_, e: psi, substep,
                                  static=True)
        return state.replace(hydro_W=W)


@dataclass
class Distributed(Routing):
    """PISM ``hydrology::Distributed`` (Bueler & van Pelt 2015): the
    routing transport with psi = P + rho_w g b and the pressure evolving
    from the cavity volume balance

        dP/dt = (rho_w g / phi0) [ dW/dt|transport - (O(W) - C(W, P)) ]

    with cavity opening O = c1 |u_b| (W_r - W)_+ and creep closure
    C = c2 A P_eff^3 W, P_eff = P_overburden - P, clipped to
    0 <= P <= P_overburden; |u_b| from the state's SSA velocity."""

    def __post_init__(self):
        super().__post_init__()
        cfg = self.config
        self.phi0 = cfg.get_number("hydrology.distributed.phi_0") \
            if cfg.is_set("hydrology.distributed.phi_0") \
            else cfg.get_number("hydrology.regularizing_porosity")
        self.Wr = cfg.get_number("hydrology.roughness_scale")
        self.c1 = cfg.get_number("hydrology.cavitation_opening_coefficient")
        self.c2 = cfg.get_number("hydrology.creep_closure_coefficient")
        self.A_soft = cfg.get_number("flow_law.isothermal_Glen.ice_softness")

    def step(self, state: S.ModelState, dt, runoff=None) -> S.ModelState:
        state = NullTransport.step(self, state, dt, runoff)
        H = state.geometry.ice_thickness
        b = state.geometry.bed_elevation
        W = state.hydro_W if state.hydro_W is not None else torch.zeros_like(H)
        P_ov = self.rho_i * self.g * H
        P = state.hydro_P if state.hydro_P is not None else P_ov
        u = state.u_ssa if state.u_ssa is not None else torch.zeros_like(H)
        v = state.v_ssa if state.v_ssa is not None else torch.zeros_like(H)
        speed = torch.sqrt(u ** 2 + v ** 2)
        m_b = state.basal_melt_rate if state.basal_melt_rate is not None \
            else torch.zeros_like(H)
        # the basal melt alone feeds this model (the JAX twin's inflow)
        inflow = (self.rho_i / self.rho_w) * m_b
        overflow = torch.where(state.tillwat >= self.W_max, inflow, 0.0)
        ocean = S.ocean(state.geometry.cell_type)

        def substep(W, P, dt_sub, grads):
            dW_trans = self._transport(W, overflow, dt_sub, grads)
            W_new = torch.clamp(W + dt_sub * dW_trans, min=0.0)
            opening = self.c1 * speed * torch.clamp(self.Wr - W, min=0.0)
            P_eff = torch.clamp(P_ov - P, min=0.0)
            closure = self.c2 * self.A_soft * P_eff ** 3 * W
            # (phi0 / rho_w g) dP/dt = dW/dt|transport - (opening - closure)
            dP = (self.rho_w * self.g / self.phi0) \
                * (dW_trans - (opening - closure))
            P_new = torch.minimum(torch.clamp(P + dt_sub * dP, min=0.0), P_ov)
            return torch.where(ocean, 0.0, W_new), torch.where(ocean, 0.0, P_new)

        W, P = self._cfl_subcycle(
            dt, W, lambda W_, P_: P_ + self.rho_w * self.g * b, substep,
            extra0=P)
        return state.replace(hydro_W=W, hydro_P=P)


@dataclass
class Steady(NullTransport):
    """PISM ``hydrology::SteadyState``'s role: the basal water input routed
    instantaneously down the hydraulic potential to the ice margin, the
    steady subglacial discharge per unit width ``hydro_Q`` [m^2/s] that the
    ``DischargeRouting`` frontal melt reads. No water layer of its own (the
    till ODE still runs). Each cell sends its accumulated flux to its
    steepest-descent neighbour; Q <- input + sum(upstream Q) is iterated to
    its fixed point (at most ``hydrology.steady_max_iterations`` sweeps),
    and only in a step that crosses a multiple of
    ``hydrology.steady.flux_update_interval``."""

    max_iters: int = 4096

    def __post_init__(self):
        super().__post_init__()
        cfg = self.config
        self.g = cfg.get_number("constants.standard_gravity")
        self.sh = Shifter(self.grid)
        self.max_iters = cfg.get_int("hydrology.steady_max_iterations")
        self.interval = cfg.get_number(
            "hydrology.steady.flux_update_interval", "seconds")

    def step(self, state: S.ModelState, dt, runoff=None,
             t=None) -> S.ModelState:
        """``t``: the step's end time [s]; with a stored discharge field
        the fixed point reruns only when (t - dt, t] crosses a multiple of
        the update interval, else the field is carried unchanged."""
        state = NullTransport.step(self, state, dt, runoff)
        T = self.interval
        if t is not None and T > 0.0 and state.hydro_Q is not None \
                and not math.floor(t / T) > math.floor((t - dt) / T):
            return state
        return self._solve_flux(state)

    def _directions(self, psi, icy):
        """The steepest-descent neighbour of each icy cell: 0 (a sink: a
        local minimum or the margin) or 1..4 = E, W, N, S; neighbours
        outside the ice are outlets at -inf potential. Ties go to the
        first candidate in that order."""
        sh = self.sh
        best = torch.zeros(psi.shape, dtype=torch.int32, device=psi.device)
        low = None
        for k, (jy, ix) in enumerate(((0, 1), (0, -1), (1, 0), (-1, 0))):
            cand = torch.where(sh(icy, jy, ix), sh(psi, jy, ix), -math.inf)
            if low is None:
                low = cand
                continue
            take = cand < low
            best = torch.where(take, k, best)
            low = torch.where(take, cand, low)
        return torch.where(icy & (low < psi), best + 1, 0)

    def _solve_flux(self, state: S.ModelState) -> S.ModelState:
        global STEADY_SWEEPS
        sh, grid = self.sh, self.grid
        geom = state.geometry
        H = geom.ice_thickness
        icy = S.icy(geom.cell_type)
        # the water input [m^3/s] per cell: all melt routes once the till is
        # saturated (as Routing's overflow)
        m_b = state.basal_melt_rate if state.basal_melt_rate is not None \
            else torch.zeros_like(H)
        inflow = (self.rho_i / self.rho_w) * m_b
        overflow = torch.where(icy & (state.tillwat >= self.W_max), inflow, 0.0)
        inp = overflow * grid.dx * grid.dy
        psi = self.rho_w * self.g * geom.bed_elevation + self.rho_i * self.g * H
        direction = self._directions(psi, icy)

        # a neighbour drains into a cell if it exists (the shifts clamp at a
        # non-periodic edge, which would alias an edge cell as its own
        # upstream neighbour) and points at it
        My, Mx = psi.shape
        ix = torch.arange(Mx, device=psi.device)[None, :].expand(My, Mx)
        iy = torch.arange(My, device=psi.device)[:, None].expand(My, Mx)
        true_ = torch.ones_like(icy)
        has = {(0, 1): true_ if grid.periodic_x else ix < Mx - 1,
               (0, -1): true_ if grid.periodic_x else ix > 0,
               (1, 0): true_ if grid.periodic_y else iy < My - 1,
               (-1, 0): true_ if grid.periodic_y else iy > 0}
        # the neighbour at +x drains here if its direction is W (2), etc.
        drains = [((jy, ix_), has[(jy, ix_)] & (sh(direction, jy, ix_) == d))
                  for (jy, ix_), d in (((0, 1), 2), ((0, -1), 1), ((1, 0), 4),
                                       ((-1, 0), 3))]

        def sweep(Q):
            s = None
            for (jy, ix_), m in drains:
                term = torch.where(m, sh(Q, jy, ix_), 0.0)
                s = term if s is None else s + term
            return inp + s

        Q, it = inp, 0
        while it < self.max_iters:
            before = Q
            for _ in range(min(hostsync.CHECK_EVERY, self.max_iters - it)):
                Q = sweep(Q)
                it += 1
            if not hostsync.host(torch.any(Q != before)):
                break
        STEADY_SWEEPS += it
        # the discharge per unit width [m^2/s] through the cell's outflow
        # face (east and west faces span dy, north and south ones dx)
        face_len = torch.where((direction == 1) | (direction == 2),
                               Q.new_tensor(grid.dy), Q.new_tensor(grid.dx))
        return state.replace(hydro_Q=Q / face_len)


def hydrology_from_config(grid, config, device="cuda"):
    """The hydrology model of ``hydrology.model``, with the water input
    field of ``hydrology.surface_input.file`` (``water_input_rate``, its
    last record) on ``device``."""
    name = config.get_string("hydrology.model")
    surface_input = None
    path = config.get_string("hydrology.surface_input.file")
    if path:
        from ..io.bootstrap import read_forcing_fields
        fields, _ = read_forcing_fields(path, grid, ["water_input_rate"])
        if "water_input_rate" not in fields:
            raise ValueError(
                f"hydrology.surface_input.file {path!r}: no water_input_rate")
        a = fields["water_input_rate"]
        surface_input = torch.as_tensor(a[-1] if a.ndim == 3 else a,
                                        dtype=torch.float64, device=device)
    kw = dict(grid=grid, config=config, surface_input=surface_input)
    if name in ("null", ""):
        return NullTransport(**kw)
    if name == "routing":
        return Routing(**kw)
    if name == "distributed":
        return Distributed(**kw)
    if name == "steady":
        return Steady(**kw)
    raise ValueError(f"unknown hydrology model {name!r}")
