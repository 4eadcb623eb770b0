"""Bed deformation (port of ``pism_tpu/model/beddef.py``): pointwise
isostasy (``bed_deformation.model = iso``, PISM
``bed::PointwiseIsostasy``), the bed model of verification test H, and the
Lingle & Clark (1985) viscous half-space under an elastic plate
(``lc``, PISM ``bed::LingleClark``) with its update interval, elastic
option and uplift-rate initialization. ``given`` raises
``NotImplementedError``.

Lingle-Clark is solved spectrally on a zero-padded grid
(``bed_deformation.lc.grid_size_factor``) with ``torch.fft.rfft2``; the
JAX package uses XLA's FFT there, outside any Pallas kernel. The per-mode
Crank-Nicolson update of the viscous displacement u(k) of

    2 eta |k| du/dt = -(rho_r g + D k^4) u - q,     q = rho_i g (H - H_ref)

keeps the JAX cast order: the wavenumber tables (float64 on the host) are
cast to the field dtype, and dt is cast before the division. The update
interval's gate compares host floats (the step's end time), so it costs no
sync.

On an ensemble's member axis (``(B, My, Mx)`` fields) ``members_step`` is
the JAX package's ``vmap`` of its gated step: each member's gate compares
its own step end, the members whose gate opened are solved in one batched
transform with a ``(B, 1, 1)`` effective dt each, and the others keep their
bed and displacement.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
import numpy as np
import torch

from .. import state as S
from ..config import require


@dataclass
class PointwiseIsostasy:
    """db = -(rho_i / rho_r) (H - H_ref)."""

    grid: object
    config: object

    def __post_init__(self):
        cfg = self.config
        self.f = cfg.get_number("constants.ice.density") / \
            cfg.get_number("bed_deformation.lithosphere_density")

    def step(self, state: S.ModelState, dt, t=None) -> S.ModelState:
        g = state.geometry
        bed = state.bed_reference - self.f * (g.ice_thickness
                                              - state.bed_load_reference)
        return state.replace(geometry=g.replace(bed_elevation=bed))

    def initialize(self, state: S.ModelState) -> S.ModelState:
        return state.replace(
            bed_reference=state.geometry.bed_elevation,
            bed_load_reference=state.geometry.ice_thickness)


@dataclass
class LingleClark:
    grid: object
    config: object

    def __post_init__(self):
        cfg = self.config
        self.rho_i = cfg.get_number("constants.ice.density")
        self.rho_r = cfg.get_number("bed_deformation.mantle_density")
        self.g = cfg.get_number("constants.standard_gravity")
        self.D = cfg.get_number("bed_deformation.lithosphere_flexural_rigidity")
        self.eta = cfg.get_number("bed_deformation.mantle_viscosity")
        self.include_elastic = cfg.get_flag("bed_deformation.lc.elastic_model")
        # solve only every interval; between solves the bed is frozen and
        # the load anomaly keeps accumulating
        self.update_interval = cfg.get_number(
            "bed_deformation.update_interval", "seconds")
        fac = cfg.get_int("bed_deformation.lc.grid_size_factor")
        grid = self.grid
        self.Ny = fac * grid.My
        self.Nx = fac * grid.Mx
        ky = np.fft.fftfreq(self.Ny, grid.dy) * 2.0 * np.pi
        kx = np.fft.rfftfreq(self.Nx, grid.dx) * 2.0 * np.pi
        KY, KX = np.meshgrid(ky, kx, indexing="ij")
        k = np.sqrt(KX ** 2 + KY ** 2)
        k2 = k * k
        # float64 tables, as the JAX package forms them before its casts
        # (k ** 4 as XLA's integer power: squared twice)
        self._alpha64 = self.rho_r * self.g + self.D * (k2 * k2)
        self._two_eta_k64 = 2.0 * self.eta * np.maximum(k, 1e-12)
        self._tables = {}

    def _table(self, dtype, device):
        """(alpha, 2 eta |k|) cast to ``dtype`` on ``device``."""
        key = (dtype, str(device))
        if key not in self._tables:
            self._tables[key] = tuple(
                torch.as_tensor(a).to(device=device, dtype=dtype)
                for a in (self._alpha64, self._two_eta_k64))
        return self._tables[key]

    def _pad(self, a):
        return torch.nn.functional.pad(
            a, (0, self.Nx - self.grid.Mx, 0, self.Ny - self.grid.My))

    def _crop(self, a):
        return a[..., :self.grid.My, :self.grid.Mx]

    def _irfft(self, a_hat):
        return self._crop(torch.fft.irfft2(a_hat, s=(self.Ny, self.Nx)))

    def step(self, state: S.ModelState, dt, t=None) -> S.ModelState:
        """The bed after a step of ``dt`` seconds ending at model time
        ``t`` (host floats): with an update interval T > 0 only when the
        step crosses a multiple of T, with the effective dt max(T, dt)."""
        T = self.update_interval
        if t is not None and T > 0.0:
            if not math.floor(t / T) > math.floor((t - dt) / T):
                return state
            return self._solve(state, max(T, dt))
        return self._solve(state, dt)

    def members_step(self, state: S.ModelState, dts, ends,
                     active) -> S.ModelState:
        """``step`` for an ensemble's members: ``dts``, ``ends`` and
        ``active`` host lists of their steps (in the field dtype), step
        ends and whether they step. The members whose gate opens are
        solved with the effective dt each would take alone; no solve runs
        if no gate opens."""
        T = self.update_interval
        if T > 0.0:
            opens = [a and math.floor(e / T) > math.floor((e - d) / T)
                     for d, e, a in zip(dts, ends, active)]
            dts = [max(T, d) for d in dts]
        else:
            opens = list(active)
        if not any(opens):
            return state
        U = state.bed_uplift
        dt = torch.tensor(dts, dtype=torch.float64, device=U.device)
        solved = self._solve(state, dt.to(U.dtype).view(-1, 1, 1))
        return S.select_members(torch.tensor(opens, device=U.device),
                                solved, state)

    def _solve(self, state: S.ModelState, dt) -> S.ModelState:
        """One solve over ``dt``: a host float, or the members' (B, 1, 1)
        tensor in the field dtype."""
        g = state.geometry
        H_ref = state.bed_load_reference   # reference load thickness
        bed_ref = state.bed_reference      # undeformed bed
        U = state.bed_uplift               # viscous displacement field

        dload = g.ice_thickness - H_ref
        q = self.rho_i * self.g * self._pad(dload)
        q_hat = torch.fft.rfft2(q)
        U_hat = torch.fft.rfft2(self._pad(U).to(q.dtype))
        alpha, two_eta_k = self._table(q.dtype, q.device)
        # divisions by 0-dim tensors: the card divides a tensor by a Python
        # scalar as a product with its reciprocal
        if not torch.is_tensor(dt):
            dt = torch.tensor(dt, dtype=q.dtype, device=q.device)
        a_coef = two_eta_k / dt
        U_hat_new = ((a_coef - 0.5 * alpha) * U_hat - q_hat) \
            / (a_coef + 0.5 * alpha)
        # k = 0: the mean displacement at its relaxed value
        U_hat_new[..., 0, 0] = -q_hat[..., 0, 0] / torch.tensor(
            self.rho_r * self.g, dtype=q.dtype, device=q.device)
        U_new = self._irfft(U_hat_new)

        bed = bed_ref + U_new
        if self.include_elastic:
            bed = bed + self._irfft(-q_hat / alpha)
        geom = g.replace(bed_elevation=bed.to(g.bed_elevation.dtype))
        return state.replace(geometry=geom, bed_uplift=U_new.to(U.dtype))

    def initialize(self, state: S.ModelState,
                   uplift_rate=None) -> S.ModelState:
        """Record the reference (assumed-equilibrium) bed and load.

        ``uplift_rate`` [m/s] (or the file named by
        ``bed_deformation.bed_uplift_file``, variable ``dbdt``) bootstraps
        the viscous displacement so that the initial d(bed)/dt is the
        observed uplift: with zero load anomaly dU/dt = -alpha U /
        (2 eta k), inverted per mode for U0; the reference bed becomes
        bed - U0, so the current bed is reproduced exactly."""
        g = state.geometry
        bed = g.bed_elevation
        if uplift_rate is None:
            path = self.config.get_string("bed_deformation.bed_uplift_file")
            if path:
                from ..io.bootstrap import read_and_regrid
                flds = read_and_regrid(path, self.grid,
                                       variables=["dbdt", "uplift"])
                u = flds.get("dbdt", flds.get("uplift"))
                if u is None:
                    raise ValueError(f"{path!r} has no dbdt/uplift variable")
                uplift_rate = np.nan_to_num(u, nan=self.config.get_number(
                    "bootstrapping.defaults.uplift"))
        U0 = torch.zeros_like(bed)
        bed_ref = bed
        if uplift_rate is not None:
            up = self._pad(torch.as_tensor(uplift_rate).to(
                device=bed.device, dtype=bed.dtype))
            up_hat = torch.fft.rfft2(up)
            alpha, two_eta_k = self._table(up.dtype, up.device)
            U0_hat = -(two_eta_k * up_hat) / alpha
            U0_hat[0, 0] = 0.0   # mean displacement free
            U0 = self._irfft(U0_hat)
            # the step pins the padded domain's k = 0 mode, which after crop
            # and re-pad is the cropped region's sum: remove its mean
            U0 = (U0 - torch.mean(U0)).to(bed.dtype)
            bed_ref = bed - U0
        return state.replace(bed_reference=bed_ref,
                             bed_load_reference=g.ice_thickness,
                             bed_uplift=U0)


def bed_deformation_from_config(grid, config):
    require(config, "bed_deformation.model", ("none", "", "iso", "lc"))
    name = config.get_string("bed_deformation.model")
    if name == "iso":
        return PointwiseIsostasy(grid=grid, config=config)
    if name == "lc":
        return LingleClark(grid=grid, config=config)
    return None
