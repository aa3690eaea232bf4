"""In-library counters and timers (queryable observability).

The reference's only tracing is compile-time printf (``SHOW_STAT``,
``PRF`` — ``LzmaEnc.c:6-22``, ``Lzma2Enc.c:34``); its only runtime
metric is the ``ICompressProgress`` callback.  This module is the
queryable equivalent: cheap process-wide counters/timers the schedulers
update as they run, so a production deployment can ask *where work went*
(host vs device lanes, fallbacks, steals, retries) without rebuilding.

Usage::

    from ..utils.trace import TRACE
    TRACE.add("hybrid.dev_bytes", n)
    with TRACE.timer("scheduler.submit"):
        ...
    TRACE.snapshot()   # -> {"hybrid.dev_bytes": ..., "scheduler.submit": {...}}

Counters are always on (one lock + int add per event, negligible next to
a group decode); ``LZT_TRACE=1`` additionally prints the snapshot at
process exit.
"""

from __future__ import annotations

import atexit
import os
import threading
import time
from contextlib import contextmanager


class Tracer:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._timers: dict[str, list[float]] = {}   # [count, total_s, max_s]

    def add(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def peak(self, name: str, value: float) -> None:
        """Counter ``name`` becomes the largest value it was given."""
        with self._lock:
            self._counters[name] = max(self._counters.get(name, value), value)

    @contextmanager
    def timer(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.record(name, time.monotonic() - t0)

    def record(self, name: str, dt: float) -> None:
        """One interval of ``dt`` seconds for timer ``name``, measured by
        the caller (for example with CUDA events)."""
        with self._lock:
            t = self._timers.setdefault(name, [0, 0.0, 0.0])
            t[0] += 1
            t[1] += dt
            t[2] = max(t[2], dt)

    def snapshot(self) -> dict:
        with self._lock:
            out: dict = dict(self._counters)
            for name, (cnt, tot, mx) in self._timers.items():
                out[name] = {"count": cnt, "total_s": round(tot, 6),
                             "max_s": round(mx, 6)}
            return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timers.clear()


TRACE = Tracer()

if os.environ.get("LZT_TRACE") == "1":
    @atexit.register
    def _dump():  # pragma: no cover - exit-path printing
        import json
        import sys
        snap = TRACE.snapshot()
        if snap:
            print("lzt trace: " + json.dumps(snap, sort_keys=True),
                  file=sys.stderr)
