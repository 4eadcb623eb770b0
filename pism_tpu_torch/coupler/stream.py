"""Streamed time-series forcing with read-ahead (port of
``pism_tpu/coupler/stream.py``): the records of a forcing too large to
load up front are read from the file during the run.

A :class:`ForcingStream` keeps a bounded cache of decoded records in a pool
of host buffers (page-locked when the records go to a card), and a reader
thread reads the next ``lookahead`` records whenever one is consumed; the
file's decode runs beside the device work. ``slice_at(t, device)`` is a
lookup in that cache and one ``non_blocking`` copy to the device. The
buffers are allocated once, on the caller's thread, before the first read:
the reader thread makes no CUDA call (a page-locked allocation would
synchronise the device). A buffer whose record left the cache is reused
only once the copy last made from it has completed (its event, queried
without waiting).

Records are piecewise-constant in time, clamped at the ends or cycled
with ``period``, as the loaded-up-front couplers' stacks. Files are read
through ``io/nc4.py`` (classic NetCDF is memory-mapped, one record read at
a time).
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from ..io.nc4 import ClassicFile, File, _is_classic


class ForcingStream:
    def __init__(self, path: str, var: str, time_var: str = "time", *,
                 lookahead: int = 4, cache_slices: int = 16,
                 period: float = None, dtype=np.float32,
                 time_extrapolation: bool = True):
        self.path = path
        self.var = var
        self.period = period
        self.lookahead = lookahead
        self.cache_slices = max(cache_slices, lookahead + 2)
        self.dtype = dtype
        #: input.forcing.time_extrapolation: with False, a time outside the
        #: covered interval stops the run instead of holding the end values
        self.time_extrapolation = time_extrapolation
        self._f = ClassicFile(path, mmap=True) if _is_classic(path) \
            else File(path, "r")
        self.times = np.asarray(self._f.read(time_var), np.float64)
        shp = self._f.shape(var)
        self.nt = shp[0]
        self.shape = tuple(shp[1:])
        self._cache: "OrderedDict[int, int]" = OrderedDict()  # record -> slot
        self._bufs = None          # the buffer pool, on the first lookup
        self._events = []          # per slot: the event of its last copy
        self._free = []
        self._retired = []         # slots whose record left the cache
        self._lock = threading.Lock()
        self._io_lock = threading.Lock()
        self._closed = False
        self.prefetch_hits = 0
        self.misses = 0

    # -- host side ---------------------------------------------------------
    def _read_into(self, idx: int, slot: int) -> bool:
        """Record ``idx`` into buffer ``slot``; False once closed."""
        with self._io_lock:
            if self._closed:
                return False
            data = self._f.read_slice(self.var, idx)
        np.copyto(self._bufs[slot].numpy(), data, casting="unsafe")
        return True

    def _allocate(self, device) -> None:
        pin = torch.device(device).type == "cuda"
        n = self.cache_slices + self.lookahead + 2
        tdt = torch.from_numpy(np.zeros(1, self.dtype)).dtype
        self._bufs = [torch.empty(self.shape, dtype=tdt, pin_memory=pin)
                      for _ in range(n)]
        self._events = [None] * n
        self._free = list(range(n))

    def _reclaim(self, wait: bool = False) -> None:
        """Under the lock: retired slots whose last copy has completed go
        back to the free list; ``wait``: wait for the oldest one's copy if
        none has."""
        keep = []
        for slot in self._retired:
            ev = self._events[slot]
            if ev is None or ev.query():
                self._events[slot] = None
                self._free.append(slot)
            else:
                keep.append(slot)
        self._retired = keep
        if wait and not self._free and self._retired:
            slot = self._retired.pop(0)
            self._events[slot].synchronize()
            self._events[slot] = None
            self._free.append(slot)

    def _insert(self, idx: int, slot: int) -> None:
        """Under the lock: a freshly read record into the cache (a record
        read twice at once keeps the first copy)."""
        if idx in self._cache:
            self._free.append(slot)
            return
        self._cache[idx] = slot
        while len(self._cache) > self.cache_slices:
            _, old = self._cache.popitem(last=False)
            self._retired.append(old)

    def _get(self, idx: int) -> int:
        """The slot holding record ``idx`` (read now on a miss)."""
        idx = int(np.clip(idx, 0, self.nt - 1))
        with self._lock:
            self._reclaim()
            slot = self._cache.get(idx)
            miss = slot is None
            if not miss:
                self._cache.move_to_end(idx)
                self.prefetch_hits += 1
            else:
                self.misses += 1
                if not self._free:
                    self._reclaim(wait=True)
                if not self._free:
                    # every slot holds a cached record: retire the oldest
                    _, old = self._cache.popitem(last=False)
                    self._retired.append(old)
                    self._reclaim(wait=True)
                slot = self._free.pop()
        if miss:
            self._read_into(idx, slot)
            with self._lock:
                self._insert(idx, slot)
                slot = self._cache[idx]
        self._trigger_prefetch(idx)
        return slot

    def _trigger_prefetch(self, idx: int) -> None:
        def work():
            for j in range(idx + 1, idx + 1 + self.lookahead):
                jj = j % self.nt if self.period else min(j, self.nt - 1)
                with self._lock:
                    if jj in self._cache or not self._free:
                        continue
                    slot = self._free.pop()
                if not self._read_into(jj, slot):
                    return
                with self._lock:
                    self._insert(jj, slot)
        threading.Thread(target=work, daemon=True).start()

    def _index_of(self, t: float) -> int:
        tt = t % self.period if self.period else t
        if not self.time_extrapolation and not self.period:
            t0, t1 = self.times[0], self.times[-1]
            # the last record covers [times[-1], +one spacing)
            span = (self.times[-1] - self.times[0]) \
                / max(self.nt - 1, 1) if self.nt > 1 else 0.0
            if tt < t0 - 1e-6 or tt > t1 + span + 1e-6:
                raise RuntimeError(
                    f"forcing {self.var!r} from {self.path!r} does not "
                    f"cover model time {tt:.6g} s "
                    "(input.forcing.time_extrapolation is off)")
        return int(np.clip(np.searchsorted(self.times, tt, side="right") - 1,
                           0, self.nt - 1))

    @staticmethod
    def config_kwargs(config):
        """The streaming settings of the config: the cache size from
        input.forcing.buffer_size (climate_forcing.buffer_size wins when
        set) and the time-extrapolation policy."""
        n = config.get_int("climate_forcing.buffer_size") \
            if config.is_set("climate_forcing.buffer_size") \
            else config.get_int("input.forcing.buffer_size")
        return dict(cache_slices=n,
                    time_extrapolation=config.get_flag(
                        "input.forcing.time_extrapolation"))

    # -- device side ---------------------------------------------------------
    def slice_at(self, t: float, device="cpu") -> torch.Tensor:
        """The record at model time ``t`` (a host float; piecewise
        constant) on ``device``: a cache lookup and one copy, which on a
        card is ``non_blocking`` from page-locked memory."""
        if self._bufs is None:
            self._allocate(device)
        slot = self._get(self._index_of(float(t)))
        buf = self._bufs[slot]
        if torch.device(device).type != "cuda":
            return buf.clone()
        out = buf.to(device, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        with self._lock:
            self._events[slot] = ev
        return out

    def close(self):
        with self._io_lock:
            self._closed = True
            self._f.close()
