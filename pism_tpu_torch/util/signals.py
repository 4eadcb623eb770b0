"""POSIX signal handling for long runs (port of
``pism_tpu/util/signals.py``; PISM ``IceModel::process_signals``): SIGTERM
asks the run to stop cleanly at the next segment boundary (the final state
is still written), SIGUSR1 asks for a backup and the run continues.
``IceModel.run`` polls a :class:`SignalMonitor` between segments, so a
signal never interrupts a step.
"""

from __future__ import annotations

import signal
import threading


class SignalMonitor:
    """Context manager that latches SIGTERM / SIGUSR1 into flags.

    Handlers are installed on ``__enter__`` and the previous ones restored
    on ``__exit__``. Only the main thread can install handlers; a monitor
    entered on another thread stays inert (both queries return False)."""

    def __init__(self):
        self._stop = False
        self._backup = False
        self._saved = {}

    def _on_term(self, signum, frame):
        self._stop = True

    def _on_usr1(self, signum, frame):
        self._backup = True

    def __enter__(self) -> "SignalMonitor":
        if threading.current_thread() is threading.main_thread():
            for sig, fn in ((signal.SIGTERM, self._on_term),
                            (signal.SIGUSR1, self._on_usr1)):
                self._saved[sig] = signal.signal(sig, fn)
        return self

    def __exit__(self, *exc):
        for sig, old in self._saved.items():
            signal.signal(sig, old)
        self._saved.clear()
        return False

    def stop_requested(self) -> bool:
        """True once SIGTERM was received (sticky)."""
        return self._stop

    def take_backup_request(self) -> bool:
        """True if SIGUSR1 arrived since the last call; clears the latch."""
        if self._backup:
            self._backup = False
            return True
        return False
