"""Profiling (port of ``pism_tpu/util/profiling.py``; PISM ``-profile``):

- ``trace(logdir)``: a ``torch.profiler`` run around the block that writes
  a Chrome trace (host ops and, on a card, the kernels) into ``logdir``;
- ``annotate(name)``: a named range in that trace
  (``torch.profiler.record_function``);
- ``Timings``: named host wall-clock accumulators.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block; writes ``logdir/trace.json`` (Chrome format)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    import torch
    return torch.profiler.record_function(name)


class Timings:
    """Named wall-clock accumulators (PISM's per-stage summary table)."""

    def __init__(self):
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        tic = time.time()
        try:
            yield
        finally:
            self._total[name] += time.time() - tic
            self._count[name] += 1

    def report(self) -> str:
        lines = [f"{'stage':<28} {'calls':>7} {'total [s]':>10} {'mean [ms]':>10}"]
        for name in sorted(self._total, key=self._total.get, reverse=True):
            tot, cnt = self._total[name], self._count[name]
            lines.append(f"{name:<28} {cnt:>7d} {tot:>10.2f} "
                         f"{1000.0 * tot / max(cnt, 1):>10.2f}")
        return "\n".join(lines)
