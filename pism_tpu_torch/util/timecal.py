"""Model time and calendars.

The reference (PISM ``src/util/Time.cc`` + bundled calcalcs C library) keeps
model time as seconds since a reference date under a CF calendar
(``365_day``, ``360_day``, ``gregorian``, ``none``). We implement the same
semantics in pure Python; this runs on the host only (time never enters
tensor code: it is a Python float (f64) in seconds on the host).

A copy of ``pism_tpu/util/timecal.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .units import SEC_PER_YEAR

_DAYS_PER_MONTH_365 = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


def _is_gregorian_leap(y: int) -> bool:
    return (y % 4 == 0 and y % 100 != 0) or (y % 400 == 0)


@dataclass(frozen=True)
class Calendar:
    name: str = "365_day"

    @property
    def year_length(self) -> float:
        """Length of one calendar year in seconds (mean year for gregorian)."""
        if self.name in ("365_day", "noleap"):
            return 365.0 * 86400.0
        if self.name == "360_day":
            return 360.0 * 86400.0
        if self.name in ("gregorian", "standard", "proleptic_gregorian"):
            return 365.2425 * 86400.0
        if self.name == "none":
            return SEC_PER_YEAR
        raise ValueError(f"unknown calendar {self.name!r}")

    def year_fraction(self, t_seconds: float) -> float:
        """Fraction of the year elapsed at time t (for periodic forcings)."""
        yl = self.year_length
        return (t_seconds % yl) / yl


@dataclass(frozen=True)
class Time:
    """Run-time bookkeeping: start/end, current time in seconds.

    Mirrors PISM ``pism::Time`` (``-y``/``-ys``/``-ye`` options, seconds
    internally, years at the UI).
    """

    start: float  # seconds
    end: float  # seconds
    calendar: Calendar = field(default_factory=Calendar)
    reference_date: str = "1-1-1"   # model t = 0 (reference time.reference_date)

    @staticmethod
    def from_years(ys: float = 0.0, ye: float = None, y: float = None,
                   calendar: str = "365_day",
                   reference_date: str = "1-1-1") -> "Time":
        cal = Calendar(calendar)
        yl = cal.year_length
        if ye is None:
            ye = ys + (y if y is not None else 0.0)
        return Time(start=ys * yl, end=ye * yl, calendar=cal,
                    reference_date=reference_date)

    @staticmethod
    def from_config(cfg) -> "Time":
        """Run time from time.{calendar,reference_date,start,end,run_length}
        (reference Time::init: every CLI time option is one of these)."""
        ys = cfg.get_number("time.start", "years")
        ye = cfg.get_number("time.end", "years")
        if ye <= ys:
            ye = ys + cfg.get_number("time.run_length", "years")
        return Time.from_years(
            ys=ys, ye=ye,
            calendar=cfg.get_string("time.calendar"),
            reference_date=cfg.get_string("time.reference_date"))

    @property
    def cf_units(self) -> str:
        """CF units string of the model time axis."""
        return f"seconds since {self.reference_date}"

    def date_string(self, t_seconds: float) -> str:
        """Calendar date of model time t (runtime summaries). Paleo times
        before the epoch fall back to decimal years."""
        ref = date_to_seconds(self.calendar.name, self.reference_date)
        tt = ref + t_seconds
        if tt < 0:
            return f"{self.years(t_seconds):.3f} a"
        y, m, d, sec = seconds_to_date(self.calendar.name, tt)
        return f"{y:04d}-{m:02d}-{d:02d}"

    def years(self, t_seconds: float) -> float:
        return t_seconds / self.calendar.year_length

    def seconds(self, t_years: float) -> float:
        return t_years * self.calendar.year_length

    @property
    def run_length(self) -> float:
        return self.end - self.start


# ---------------------------------------------------------------- dates
def _parse_date(s: str):
    """Parse a CF reference date 'Y-M-D[ h:m:s]' -> (y, m, d, sec_of_day)."""
    s = str(s).strip()
    parts = s.split()
    ymd = parts[0].split("-")
    if len(ymd) < 3:
        raise ValueError(f"cannot parse date {s!r} (want Y-M-D)")
    y, m, d = int(ymd[0]), int(ymd[1]), int(ymd[2])
    sec = 0.0
    if len(parts) > 1:
        hms = parts[1].split(":")
        sec = float(hms[0]) * 3600.0
        if len(hms) > 1:
            sec += float(hms[1]) * 60.0
        if len(hms) > 2:
            sec += float(hms[2])
    return y, m, d, sec


def _days_in_month(cal_name: str, y: int, m: int) -> int:
    if cal_name == "360_day":
        return 30
    d = _DAYS_PER_MONTH_365[m - 1]
    if m == 2 and cal_name in ("gregorian", "standard",
                               "proleptic_gregorian") \
            and _is_gregorian_leap(y):
        return 29
    return d


def date_to_seconds(cal_name: str, date) -> float:
    """Seconds from the calendar epoch 0001-01-01 00:00:00 to ``date``
    (reference ``Time.cc`` + calcalcs role). Supports 365_day/noleap,
    360_day and (proleptic) gregorian; 'none' treats Y-M-D numerically
    on the 365-day layout."""
    y, m, d, sec = _parse_date(date) if isinstance(date, str) else date
    if cal_name == "360_day":
        days = (y - 1) * 360 + (m - 1) * 30 + (d - 1)
    elif cal_name in ("gregorian", "standard", "proleptic_gregorian"):
        yy = y - 1
        days = yy * 365 + yy // 4 - yy // 100 + yy // 400
        days += sum(_days_in_month(cal_name, y, mm) for mm in range(1, m))
        days += d - 1
    else:  # 365_day / noleap / none
        days = (y - 1) * 365 + sum(_DAYS_PER_MONTH_365[:m - 1]) + (d - 1)
    return days * 86400.0 + sec


def seconds_to_date(cal_name: str, t: float):
    """Inverse of :func:`date_to_seconds` (for display / CF attributes):
    (year, month, day, seconds_of_day)."""
    days = int(t // 86400.0)
    sec = t - days * 86400.0
    if cal_name == "360_day":
        y = days // 360 + 1
        rem = days % 360
        return y, rem // 30 + 1, rem % 30 + 1, sec
    y = 1
    # gregorian: step by 400-year blocks then scan (runs on the host only)
    if cal_name in ("gregorian", "standard", "proleptic_gregorian"):
        block = 146097  # days per 400 gregorian years
        y += 400 * (days // block)
        days = days % block
        while True:
            yl = 366 if _is_gregorian_leap(y) else 365
            if days < yl:
                break
            days -= yl
            y += 1
    else:
        y += days // 365
        days = days % 365
    m = 1
    while days >= _days_in_month(cal_name, y, m):
        days -= _days_in_month(cal_name, y, m)
        m += 1
    return y, m, days + 1, sec


def parse_time_units(units: str, calendar: str, reference_date: str):
    """Decompose a CF time-units string '<unit> since <date>' into
    ``(scale_to_seconds, offset_seconds)`` so that
    ``t_model = value * scale + offset`` with t_model = seconds since the
    MODEL reference date (reference ``Time::convert_time_bounds`` role:
    dated forcing files line up with model time under the run calendar)."""
    u = str(units).strip()
    low = u.lower()
    scales = {"second": 1.0, "sec": 1.0, "s": 1.0,
              "minute": 60.0, "min": 60.0,
              "hour": 3600.0, "h": 3600.0,
              "day": 86400.0, "d": 86400.0,
              "year": None, "a": None}
    if " since " in low:
        unit_part, date_part = low.split(" since ", 1)
        unit_part = unit_part.strip().rstrip("s")
        scale = scales.get(unit_part, None)
        cal = Calendar(calendar)
        if scale is None:   # years since: use the calendar year length
            scale = cal.year_length
        offset = date_to_seconds(calendar, date_part.strip()) \
            - date_to_seconds(calendar, reference_date)
        return scale, offset
    # fallbacks without a reference date (historical files): 'years' keeps
    # the package-wide SEC_PER_YEAR convention (the CLI's -ys/-ye use it),
    # anything else is model seconds
    if "year" in low or low in ("a", "common_years"):
        return SEC_PER_YEAR, 0.0
    return 1.0, 0.0
