"""Verbosity-leveled logger (port of ``pism_tpu/util/logger.py``; PISM
``src/util/Logger.cc``): printing gated by a verbosity threshold (1 =
errors and warnings only, 2 = the default per-segment summaries, 3 =
component detail, 4 = solver detail, 5 = tracing). The port drives one
process, so every message prints.

Usage::

    from pism_tpu_torch.util.logger import log, set_verbosity
    set_verbosity(3)
    log.message(2, "t = %.1f a, dt = %.3f a", t, dt)
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field


@dataclass
class Logger:
    verbosity: int = 2
    stream: object = None          # defaults to stdout lazily
    _t0: float = field(default_factory=time.time)

    def message(self, threshold: int, fmt: str, *args) -> None:
        """Print if ``verbosity >= threshold`` (PISM ``Logger::message``)."""
        if self.verbosity < threshold:
            return
        out = self.stream or sys.stdout
        print(fmt % args if args else fmt, file=out)
        out.flush()

    def warning(self, fmt: str, *args) -> None:
        """Printed at verbosity 1 and above (PISM prints warnings there)."""
        if self.verbosity < 1:
            return
        out = self.stream or sys.stderr
        print("WARNING: " + (fmt % args if args else fmt), file=out)
        out.flush()

    def error(self, fmt: str, *args) -> None:
        out = self.stream or sys.stderr
        print("ERROR: " + (fmt % args if args else fmt), file=out)
        out.flush()

    def wall_time(self) -> float:
        """Seconds since the logger was created."""
        return time.time() - self._t0


#: process-global logger
log = Logger()


def set_verbosity(level: int) -> None:
    log.verbosity = int(level)


def get_verbosity() -> int:
    return log.verbosity
