"""Output scheduling: snapshots, spatial series, scalar series, backups
(port of ``pism_tpu/model/output.py``; PISM ``src/icemodel/output*.cc``).

The three output channels (``-save_times`` snapshots,
``-extra_file/-extra_times/-extra_vars`` spatial series,
``-ts_file/-ts_times/-ts_vars`` scalar series) and wall-clock backups
(``-backup_interval``) run on the host at segment boundaries;
``IceModel.run`` ends each segment on the next requested output time so
records land exactly (PISM ``time_stepping.hit_*_times``). Every file of a
run is written in ``format`` (``output.format``: ``netcdf4`` or
``netcdf3``).

With ``async_io`` (``output.async``) the NetCDF writes run on one worker
thread in submission order. The diagnostics are computed, and every field
a write reads is copied to the host, on the main thread before the write is
queued, so the next step can never change what a queued write reads. An
exception on the writer thread is raised again by the next ``process``,
``flush`` or ``close``.
"""

from __future__ import annotations

import queue as _queue
import threading as _threading
import time as _time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import diagnostics as diag
from .. import state as S
from ..io import checkpoint as ckpt
from ..io.nc4 import File

_XY = ("time", "y", "x")


class _AsyncWriter:
    """One worker thread executing write closures in order."""

    def __init__(self):
        self._q: _queue.Queue = _queue.Queue()
        self._err = None
        self.seconds = 0.0   # time spent in the tasks
        self._thread = _threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while True:
            task = self._q.get()
            try:
                if task is None:
                    return
                tic = _time.perf_counter()
                try:
                    task()
                except Exception as e:      # raised by the next call
                    if self._err is None:
                        self._err = e
                self.seconds += _time.perf_counter() - tic
            finally:
                self._q.task_done()

    def _raise(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def submit(self, task):
        self._raise()
        self._q.put(task)

    def drain(self):
        self._q.join()
        self._raise()

    def stop(self):
        self._q.put(None)
        self._thread.join()
        self._raise()


def _times(seq) -> List[float]:
    return sorted(set(float(s) for s in seq))


def _host(x) -> np.ndarray:
    """A host copy of ``x`` that no later step can write into."""
    if torch.is_tensor(x):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x)


def _host_state(state: S.ModelState) -> S.ModelState:
    return S.map_tensors(state, lambda x: x.detach().to("cpu", copy=True))


def _floats(values) -> List[float]:
    """Host floats of a list of 0-dim tensors and Python numbers, in one
    transfer."""
    idx = [i for i, v in enumerate(values) if torch.is_tensor(v)]
    out = [float(v) for v in values]
    if idx:
        got = torch.stack([values[i].to(torch.float64) for i in idx]).tolist()
        for i, v in zip(idx, got):
            out[i] = v
    return out


@dataclass
class OutputManager:
    grid: object
    config: object
    # snapshots: full model state at given times (model seconds)
    snapshot_times: Sequence[float] = ()
    snapshot_file: str = "snapshots_{kyr:.3f}.nc"
    # spatial series
    extra_times: Sequence[float] = ()
    extra_vars: Sequence[str] = ("thk", "usurf", "velbar_mag", "mask")
    extra_file: Optional[str] = None
    # scalar series
    ts_times: Sequence[float] = ()
    ts_vars: Sequence[str] = ("ice_volume_glacierized", "ice_area_glacierized",
                              "max_velocity")
    ts_file: Optional[str] = None
    # wall-clock backups
    backup_interval: float = 0.0   # seconds of wall time; 0 disables
    backup_file: str = "backup.nc"
    # the runtime viewer (-view) is not ported
    view_vars: Sequence[str] = ()
    async_io: bool = True
    format: Optional[str] = None   # default: the config's output.format

    def __post_init__(self):
        if self.view_vars:
            raise NotImplementedError(
                "-view (PNG frames of the runtime viewer) is not implemented "
                "in pism_tpu_torch (ROADMAP Queue 1 item 4)")
        if self.format is None:
            self.format = self.config.get_string("output.format") \
                if self.config is not None else "netcdf4"
        self.extra_vars = diag.expand_names(self.extra_vars)
        self.ts_vars = tuple(self.ts_vars)
        diag.require_known(self.extra_vars, (diag.SPATIAL, diag.SPATIAL_RATE),
                           "-extra_vars")
        diag.require_known(self.ts_vars, (diag.SCALAR, diag.RATE), "-ts_vars")
        self._snap = _times(self.snapshot_times)
        self._extra = _times(self.extra_times)
        self._ts = _times(self.ts_times)
        self._ts_rates = [n for n in self.ts_vars if n in diag.RATE]
        self._extra_rates = [n for n in self.extra_vars
                             if n in diag.SPATIAL_RATE]
        #: IceModel.run fills StepStats.cell only for this
        self.needs_cell_budget = bool(self._extra_rates)
        self._ts_records: List[dict] = []
        self._last_backup_wall = _time.time()
        self._ts_prev = self._extra_prev = None
        #: seconds spent on the main thread preparing records
        self.main_seconds = 0.0
        self._writer_seconds = 0.0
        if self.config is not None:
            File.set_compression_level(
                self.config.get_int("output.compression_level"))
        fv = None if self.config is None else \
            self.config.get_number("output.fill_value")
        self._fill = fv
        self._extra_f = self._ts_f = None
        if self.extra_file and self._extra:
            self._extra_f = File(self.extra_file, "w", format=self.format)
            ckpt._setup_dims(self._extra_f, self.grid, self.config)
            self._setup_bounds(self._extra_f)
            if self.config is not None:
                ckpt.write_projection(self._extra_f, self.grid, self.config)
        if self.ts_file and self._ts:
            self._ts_f = File(self.ts_file, "w", format=self.format)
            units, cal = "seconds since 1-1-1", "365_day"
            if self.config is not None:
                cal = self.config.get_string("time.calendar")
                units = "seconds since " \
                    + self.config.get_string("time.reference_date")
            self._ts_f.define_dimension("time", None, attrs={
                "units": units, "calendar": cal})
            self._setup_bounds(self._ts_f)
        self._writer = _AsyncWriter() if self.async_io else None

    @staticmethod
    def _setup_bounds(f):
        """CF time bounds: the reporting windows of the rate quantities."""
        f.define_dimension("nv", 2)
        f.set_var_attr("time", "bounds", "time_bnds")

    @property
    def writer_seconds(self) -> float:
        """Seconds the writer thread spent in writes (0 without it)."""
        return self._writer.seconds if self._writer is not None \
            else self._writer_seconds

    def _sample(self, state, t, model, stats, scalars=False, cells=False):
        """Cumulative sample for the rate windows; host copies are taken
        only of what a channel's rate diagnostics need."""
        s = {"t": float(t)}
        if scalars:
            vals = [diag.SCALAR["ice_volume"].func(state, model, t),
                    diag.SCALAR["ice_volume_glacierized"].func(state, model, t)]
            if stats is not None:
                vals += [stats.sum_smb, stats.sum_bmb, stats.sum_div_flux,
                         stats.sum_nonneg, stats.sum_discharge,
                         stats.sum_calving, stats.sum_frontal_melt,
                         stats.sum_forced_retreat, float(stats.nsteps)]
            else:
                vals += [0.0] * 9
            vals = _floats(vals)
            s["vol"], s["vol_gl"], s["sums"] = vals[0], vals[1], vals[2:]
        if cells:
            s["cell"] = None if stats is None or stats.cell is None \
                else tuple(_host(x) for x in stats.cell)
            s["H"] = _host(state.geometry.ice_thickness)
            s["topg"] = _host(state.geometry.bed_elevation)
            # the subglacial water amount: till plus transportable water
            water = None if state.tillwat is None else _host(state.tillwat)
            if state.hydro_W is not None:
                W = _host(state.hydro_W)
                water = W if water is None else water + W
            s["water"] = water
        return s

    def start(self, state, t: float, model) -> None:
        """Record the run-start sample, so the first reporting window of the
        rate diagnostics covers [run start, first output time]."""
        self._ts_prev = self._sample(state, t, model, None,
                                     scalars=bool(self._ts_rates))
        self._extra_prev = self._sample(state, t, model, None,
                                        cells=bool(self._extra_rates))

    @staticmethod
    def _window(prev, cur, model):
        dt = max(cur["t"] - prev["t"], 1e-30)
        d = [a - b for a, b in zip(cur["sums"], prev["sums"])]
        return diag.Window(dt=dt, d_volume=cur["vol"] - prev["vol"],
                           d_smb=d[0], d_bmb=d[1], d_flow=d[2], d_nonneg=d[3],
                           d_discharge=d[4], rho_i=model.rho_i,
                           d_calving=d[5], d_frontal_melt=d[6],
                           d_forced_retreat=d[7], d_nsteps=d[8],
                           d_volume_glacierized=cur["vol_gl"] - prev["vol_gl"])

    @staticmethod
    def _window2d(prev, cur, model):
        dt = max(cur["t"] - prev["t"], 1e-30)
        z = np.zeros(cur["H"].shape)
        c1 = cur["cell"] if cur["cell"] is not None else (z,) * 8
        c0 = prev["cell"] if prev["cell"] is not None else (z,) * 8
        d = [a - b for a, b in zip(c1, c0)]
        return diag.Window2D(
            dt=dt, d_thickness=cur["H"] - prev["H"], d_flow=d[0], d_smb=d[1],
            d_bmb=d[2], d_nonneg=d[3], d_discharge=d[4], d_calving=d[5],
            d_frontal_melt=d[6], d_forced_retreat=d[7], rho_i=model.rho_i,
            d_topg=cur["topg"] - prev["topg"],
            d_water=cur["water"] - prev["water"]
            if cur["water"] is not None and prev["water"] is not None
            else None,
            cell_area=model.grid.dx * model.grid.dy)

    # -- scheduling ----------------------------------------------------------
    def next_time(self, t: float) -> float:
        """Earliest pending output time after t (inf if none), over the
        channels whose ``time_stepping.hit_*_times`` flag is on."""
        eps = 1e-3
        chans = []
        if self.config is None:
            chans = [self._snap, self._extra, self._ts]
        else:
            for s, key in ((self._snap, "time_stepping.hit_save_times"),
                           (self._extra, "time_stepping.hit_extra_times"),
                           (self._ts, "time_stepping.hit_ts_times")):
                if self.config.get_flag(key):
                    chans.append(s)
        cands = [s[0] for s in chans if s and s[0] > t + eps]
        return min(cands) if cands else np.inf

    def _submit(self, task) -> None:
        if self._writer is not None:
            self._writer.submit(task)
        else:
            task()

    @staticmethod
    def _due(times, t) -> bool:
        """Pop every time up to t; True if there was one (several due times
        coalesce into one record)."""
        due = False
        while times and times[0] <= t + 1e-3:
            times.pop(0)
            due = True
        return due

    # -- processing ----------------------------------------------------------
    def process(self, state, t: float, model, stats=None) -> None:
        tic = _time.perf_counter()
        while self._snap and self._snap[0] <= t + 1e-3:
            ts = self._snap.pop(0)
            path = self.snapshot_file.format(kyr=ts / 3.15569259747e10, t=ts)
            self._save(path, state, t)
        if self._due(self._extra, t):
            self._write_extra(state, t, model, stats)
        if self._due(self._ts, t):
            self._write_ts(state, t, model, stats)
        if self.backup_interval > 0 and \
                _time.time() - self._last_backup_wall > self.backup_interval:
            self.write_backup(state, t)
        self.main_seconds += _time.perf_counter() - tic

    def _save(self, path, state, t):
        host = _host_state(state)
        self._submit(lambda: ckpt.save_state(path, host, self.grid, t,
                                             config=self.config,
                                             format=self.format))

    def write_backup(self, state, t: float) -> None:
        """Write a full-state backup now (wall-clock schedule or SIGUSR1)."""
        self._save(self.backup_file, state, t)
        self._last_backup_wall = _time.time()

    def _write_extra(self, state, t, model, stats=None):
        f = self._extra_f
        if f is None:
            return
        inst = [n for n in self.extra_vars if n not in diag.SPATIAL_RATE]
        rates = self._extra_rates
        values = {n: _host(v) for n, v in
                  diag.compute_spatial(inst, state, model, t).items()}
        cur = self._sample(state, t, model, stats, cells=bool(rates))
        prev = self._extra_prev if self._extra_prev is not None else cur
        rate_values = {}
        if rates:
            rate_values = {n: _host(v) for n, v in diag.compute_spatial_rates(
                rates, self._window2d(prev, cur, model)).items()}
        self._extra_prev = cur
        t0, grid, fv = prev["t"], self.grid, self._fill

        def task():
            n = f.append_time(t)
            f.write("time_bnds", np.asarray([[t0, t]]), ("time", "nv"),
                    time_index=n)
            for name, arr in values.items():
                d = diag.SPATIAL[name]
                dims = _XY
                if arr.ndim == 3 and arr.shape[-1] == grid.Mz:
                    dims = _XY + ("z",)
                    if not f.has_dimension("z"):
                        f.define_dimension("z", grid.Mz, grid.z, attrs={
                            "units": "m", "axis": "Z", "positive": "up"})
                elif arr.ndim == 3:
                    # a layer-indexed field (litho_temp), as the JAX
                    # package writes it
                    dims = _XY + ("nl",)
                    if not f.has_dimension("nl"):
                        f.define_dimension("nl", arr.shape[-1])
                f.write(name, arr[None], dims,
                        {"units": d.units, "long_name": d.long_name,
                         "_FillValue": fv}, time_index=n)
            for name, arr in rate_values.items():
                d = diag.SPATIAL_RATE[name]
                f.write(name, arr[None], _XY,
                        {"units": d.units, "long_name": d.long_name,
                         "cell_methods": "time: mean", "_FillValue": fv},
                        time_index=n)
            f.flush()

        self._submit(task)

    def _write_ts(self, state, t, model, stats=None):
        f = self._ts_f
        if f is None:
            return
        inst = [n for n in self.ts_vars if n not in diag.RATE]
        rates = self._ts_rates
        values = diag.compute_scalar(inst, state, model, t)
        cur = self._sample(state, t, model, stats, scalars=bool(rates))
        prev = self._ts_prev if self._ts_prev is not None else cur
        rate_values = {}
        if rates:
            rate_values = {n: float(v) for n, v in diag.compute_rates(
                rates, self._window(prev, cur, model)).items()}
        self._ts_prev = cur
        t0 = prev["t"]

        def task():
            n = f.append_time(t)
            f.write("time_bnds", np.asarray([[t0, t]]), ("time", "nv"),
                    time_index=n)
            rec = {"time": t}
            for table, vals, extra in ((diag.SCALAR, values, {}),
                                       (diag.RATE, rate_values,
                                        {"cell_methods": "time: mean"})):
                for name, v in vals.items():
                    d = table[name]
                    f.write(name, np.asarray(v).reshape(1), ("time",),
                            {"units": d.units, "long_name": d.long_name,
                             **extra}, time_index=n)
                    rec[name] = v
            self._ts_records.append(rec)
            f.flush()

        self._submit(task)

    def flush(self):
        """Block until every queued write is in its file."""
        if self._writer is not None:
            self._writer.drain()

    def close(self):
        """Finish the queued writes and close the files; raises a writer
        thread's exception after the files are closed."""
        try:
            if self._writer is not None:
                writer, self._writer = self._writer, None
                self._writer_seconds = writer.seconds
                writer.stop()
        finally:
            for f in (self._extra_f, self._ts_f):
                if f is not None:
                    f.close()
            self._extra_f = self._ts_f = None
