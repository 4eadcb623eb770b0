"""Forcing evaluated at a host time: ``ScalarForcing`` (port of
``pism_tpu/util/forcing.py``; PISM ``src/util/ScalarForcing.cc``), a
(time, value) series, periodized or clamped at its ends, linearly
interpolated in time; and ``TimeStack``, the interval lookup of the
``Given`` couplers' field stacks.

The JAX package bakes the series into its jitted step and interpolates at
a traced time. Here the step's time is a host float, so the interval and
weight are host arithmetic (numpy on the series' times) that needs no
device sync; a scalar enters the fields as a Python float, a stack's
weight rounded to the fields' dtype, as the JAX package casts it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .units import SEC_PER_YEAR


@dataclass(frozen=True)
class ScalarForcing:
    times: np.ndarray      # [s], increasing
    values: np.ndarray
    periodic: bool = False

    @staticmethod
    def from_arrays(times_years, values, periodic: bool = False) -> "ScalarForcing":
        t = np.asarray(times_years, float) * SEC_PER_YEAR
        order = np.argsort(t)
        return ScalarForcing(t[order], np.asarray(values, float)[order],
                             periodic)

    @staticmethod
    def from_file(path: str, variable: str, time_name: str = "time",
                  periodic: bool = False, calendar: str = "365_day",
                  reference_date: str = "1-1-1") -> "ScalarForcing":
        """Read a (time, value) series (e.g. a ``delta_T`` file); dated CF
        time axes are aligned to model time under the run calendar
        (``util.timecal.parse_time_units``)."""
        from ..io.nc4 import File
        from .timecal import parse_time_units
        with File(path, "r") as f:
            t = np.asarray(f.read(time_name), float)
            units = dict(f.read_attrs(time_name)).get("units", b"seconds")
            if isinstance(units, bytes):
                units = units.decode()
            v = np.asarray(f.read(variable), float)
        scale, offset = parse_time_units(str(units), calendar, reference_date)
        return ScalarForcing(t * scale + offset, v, periodic)

    def __call__(self, t) -> float:
        """Value at model time ``t`` [s] (a host float)."""
        tt = float(t)
        t0, t1 = float(self.times[0]), float(self.times[-1])
        if self.periodic:
            period = t1 - t0
            tt = t0 + float(np.mod(tt - t0, max(period, 1.0)))
        return float(np.interp(tt, self.times, self.values))


def _scalar(x, dtype):
    """A host float as a numpy scalar of a tensor dtype (its arithmetic
    rounds as the JAX package's casts do)."""
    return (np.float32 if dtype == torch.float32 else np.float64)(x)


def _stack_time(times, period: float, t: float):
    times = np.asarray(times, np.float64)
    if period > 0.0:
        t = times[0] + np.mod(t - times[0], period)
    return t, times


def linear_slice(f, times, period: float, t: float, dtype):
    """Piecewise-linear in time between the records of a ``(Nt, My, Mx)``
    stack (a 2D field, or no ``times``: itself), the weight found on the
    host in float64 and rounded to ``dtype``; clamped at the ends,
    ``period`` > 0 cycles the series."""
    if times is None or f.ndim == 2:
        return f.to(dtype)
    tt, times = _stack_time(times, period, t)
    k = int(np.clip(np.searchsorted(times, tt, side="right") - 1,
                    0, times.shape[0] - 2))
    w = np.clip((tt - times[k]) / max(times[k + 1] - times[k], 1e-30),
                0.0, 1.0)
    w = _scalar(w, dtype)
    return float(_scalar(1.0, dtype) - w) * f[k].to(dtype) \
        + float(w) * f[k + 1].to(dtype)


def constant_slice(f, times, period: float, t: float, dtype):
    """Piecewise-constant over the stack's intervals (the record at or
    before ``t``, clamped at the ends)."""
    if times is None or f.ndim == 2:
        return f.to(dtype)
    tt, times = _stack_time(times, period, t)
    k = int(np.clip(np.searchsorted(times, tt, side="right") - 1,
                    0, times.shape[0] - 1))
    return f[k].to(dtype)


class TimeStack:
    """Interval lookup in a sorted ``times`` axis [s] at a host time, with
    ``period`` > 0 cycling the series (the ``Given`` couplers' ``_t``)."""

    times: Optional[np.ndarray]
    period: float

    def _linear(self, f, t, dtype):
        """Piecewise-linear in time (a 2D field or no times: itself)."""
        return linear_slice(f, self.times, self.period, t, dtype)

    def _constant(self, f, t, dtype):
        """Piecewise-constant over the stack's intervals."""
        return constant_slice(f, self.times, self.period, t, dtype)
