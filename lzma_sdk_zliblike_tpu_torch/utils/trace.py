"""In-library counters, timers and spans (queryable observability).

The reference's only tracing is compile-time printf (``SHOW_STAT``,
``PRF`` — ``LzmaEnc.c:6-22``, ``Lzma2Enc.c:34``); its only runtime
metric is the ``ICompressProgress`` callback.  This module is the
queryable equivalent: cheap process-wide counters and spans the
schedulers update as they run, so a production deployment can ask *where
work went* (host vs device lanes, fallbacks, steals, retries, which step
of a call took its time) without rebuilding.

Usage::

    from ..utils.trace import TRACE
    TRACE.add("hybrid.dev_bytes", n)
    with TRACE.span("scheduler.route"):     # ``TRACE.timer`` is the same
        ...
    TRACE.snapshot()   # -> {"hybrid.dev_bytes": ..., "scheduler.route": {...}}

    with TRACE.capture() as cap:            # spans on for the block
        lzma2_uncompress(stream, prop)
    cap.take()         # -> [Span(id, name, start_ns, end_ns, parent, call)]

**Off** (the default) a span costs one ``time.perf_counter_ns()`` pair,
a check that no profiler session is on, and one locked update of its
aggregate (count, total seconds, largest), about a microsecond; counters
are one locked add.  **On**, inside ``TRACE.capture()`` or while a
``torch.profiler`` session is on in the process, every span closed in any
thread is also kept as a ``Span`` record (the first ``limit`` of them;
``dropped`` counts the rest), in memory only, and opens a
``torch.profiler.record_function`` range of its name, so that a profiler
session holds each span on its own clock beside the card's kernels and
copies.  Spans closed under a profiler session outside any capture go to
``TRACE.profiled``, one ``Capture`` for the process (``PROFILED_LIMIT``
records until taken)::

    with torch.profiler.profile(...):
        lzma2_uncompress(stream, prop)
    TRACE.profiled.take()   # the spans of the session, on its clock  A span knows its parent (the
innermost span open in the same thread, a ``contextvars`` stack) and its
call: a span opened with ``call=True`` starts a new call id, which its
descendants inherit.  ``LZT_TRACE=1`` prints the snapshot at process exit.

The device engine's decode, ``lzma2_uncompress(engine="device")``, opens
these spans once a call (never once a group or a lane), each a child of
the one above it in this list or of the root:

* ``api.lzma2_uncompress`` -- the root, a call id (the host and hybrid
  engines open the root alone);
* ``framing.scan``, ``framing.split_groups`` -- the chunk headers read and
  grouped;
* ``memory.shape_for_groups`` and its child ``memory.device_budget`` (the
  ``torch.cuda.mem_get_info`` query);
* ``scheduler.route`` -- copy-only and host-fallback groups set apart,
  the host-fallback groups decoded;
* ``scheduler.outputs`` -- only where there are such groups: the copy-only
  groups' stream bytes and the host decoder's bytes written at their
  offsets in the call's result;
* a batch's ``scheduler.assemble`` (its host arrays), ``group_decode.h2d``
  (``prep_groups``' copies to the card), ``group_decode.launch``
  (``submit_groups``: the output's allocation and K1's launch; the plain
  version's decode on the CPU), ``group_decode.wait`` (the host waiting
  for the batch's event), ``group_decode.d2h`` (``finalize_chunks``: the
  status rows, then each ok lane's used bytes copied out and written at
  their offsets in the result, piece by piece through the pinned pieces
  on the card, straight from the rows on the CPU) and
  ``scheduler.outputs`` (the lanes' status checks and the retry
  bookkeeping);
* ``api.join`` -- the result finished: its writable view released.

The 7z device route, ``containers/sevenzip.extract(engine="device")``,
opens its own root a call, ``sevenzip.extract``, and below it
``sevenzip.header`` (the archive read, its LZMA-coded header decoded),
``sevenzip.decode`` (the LZMA2 folders' chunks scanned and their groups
decoded as one batch, with the scheduler's and ``group_decode``'s spans
above inside it, and any other folder decoded on the host),
``sevenzip.filter`` (each X4 x86 launch over a BCJ folder: inside
``sevenzip.decode`` when it runs on the folder's K1 row),
``sevenzip.check`` (the folder and file CRC32s) and ``sevenzip.files``
(each file's bytes cut from the result); its counters are
``device_filters.x86_bytes`` (the bytes X4 x86 converted),
``device_filters.x86_ms`` with spans on (CUDA events around each X4 x86
launch; the host clock for the plain version) and
``sevenzip.host_folders`` (folders decoded on the host).

Decode counters: ``group_decode.lanes`` (the active lanes of each batch,
summed), ``group_decode.chain_bit_calls`` (each batch's most range-coder
bit calls in one lane, summed: the serial chain K1 walked) and, with spans
on, ``group_decode.kernel_ms`` (K1's time from CUDA events around each
launch, summed; the plain version's host time on the CPU); and
``group_decode.d2h_staged_bytes`` (the output bytes that crossed the link
through the pinned pieces: every device group's bytes on the card, none on
the CPU) and ``scheduler.host_fallback_groups``,
``scheduler.lane_retries``, ``scheduler.pallas_batches`` /
``pallas_multi_batches``.
"""

from __future__ import annotations

import atexit
import contextvars
import itertools
import os
import threading
import time
from contextlib import contextmanager
from typing import NamedTuple

# The most spans ``TRACE.profiled`` keeps until they are taken.
PROFILED_LIMIT = 1 << 18


class Span(NamedTuple):
    """One closed span of a capture; times from ``time.perf_counter_ns()``."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None     # the enclosing span in the same thread
    call: int | None       # the id of the call its root opened

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class Capture:
    """The spans closed while a capture was on: at most ``limit`` kept,
    ``dropped`` counting the rest."""

    def __init__(self, limit: int, lock: threading.Lock):
        self.limit = limit
        self.dropped = 0
        self._spans: list[Span] = []
        self._lock = lock

    def _keep(self, span: Span) -> None:    # under the tracer's lock
        if len(self._spans) < self.limit:
            self._spans.append(span)
        else:
            self.dropped += 1

    def take(self) -> list[Span]:
        """The spans kept so far, in the order they closed; the capture
        forgets them (and makes room for as many more)."""
        with self._lock:
            spans, self._spans = self._spans, []
            return spans


# (span id, call id) of the innermost open span of this thread's context
_OPEN: contextvars.ContextVar[tuple[int, int | None] | None] = \
    contextvars.ContextVar("lzt_open_span", default=None)


class Tracer:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, float] = {}
        self._timers: dict[str, list[float]] = {}   # [count, total_s, max_s]
        self._capture: Capture | None = None
        self._profiled: Capture | None = None
        self._record_function = None
        self._profiler_on = None     # torch's check, bound at first use
        self._span_ids = itertools.count(1)
        self._call_ids = itertools.count(1)

    def add(self, name: str, value: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def peak(self, name: str, value: float) -> None:
        """Counter ``name`` becomes the largest value it was given."""
        with self._lock:
            self._counters[name] = max(self._counters.get(name, value), value)

    @property
    def on(self) -> bool:
        """Whether spans are kept (inside ``capture``, or while a profiler
        session is on)."""
        return self._capture is not None or self._profiling()

    @property
    def profiled(self) -> Capture | None:
        """The spans closed under profiler sessions outside any capture
        (None until the first); ``take()`` them once a session is over."""
        return self._profiled

    def _profiling(self) -> bool:
        check = self._profiler_on
        if check is None:
            # torch's flag for a session started in any thread; the C
            # check, which sees only the starting thread's, where it lacks it
            import torch
            from torch.autograd import profiler
            check = ((lambda: profiler._is_profiler_enabled)
                     if hasattr(profiler, "_is_profiler_enabled")
                     else torch._C._autograd._profiler_enabled)
            self._profiler_on = check
        return check()

    def _session_capture(self) -> Capture:
        """``profiled``, made on the first span of a profiler session."""
        with self._lock:
            if self._profiled is None:
                from torch.profiler import record_function
                self._record_function = record_function
                self._profiled = Capture(PROFILED_LIMIT, self._lock)
            return self._profiled

    @contextmanager
    def span(self, name: str, *, call: bool = False):
        """Times the block as span ``name`` into its aggregate; with spans
        on, also keeps its record and opens a profiler range of its name.
        ``call=True`` makes it a root: a new call id for it and every span
        opened inside it."""
        cap = self._capture
        if cap is None and self._profiling():
            cap = self._session_capture()
        if cap is None:
            t0 = time.perf_counter_ns()
            try:
                yield
            finally:
                self.record(name, (time.perf_counter_ns() - t0) * 1e-9)
            return
        outer = _OPEN.get()
        parent, cid = outer if outer is not None else (None, None)
        sid = next(self._span_ids)
        if call:
            cid = next(self._call_ids)
        token = _OPEN.set((sid, cid))
        t0 = time.perf_counter_ns()
        try:
            with self._record_function(name):
                yield
        finally:
            t1 = time.perf_counter_ns()
            _OPEN.reset(token)
            with self._lock:
                self._add_time(name, (t1 - t0) * 1e-9)
                cap._keep(Span(sid, name, t0, t1, parent, cid))

    timer = span

    @contextmanager
    def capture(self, limit: int = 1 << 20):
        """Spans on for the block, in every thread; yields the ``Capture``
        that keeps them.  One capture at a time."""
        from torch.profiler import record_function
        with self._lock:
            if self._capture is not None:
                raise RuntimeError("a span capture is already on")
            self._record_function = record_function
            cap = self._capture = Capture(limit, self._lock)
        try:
            yield cap
        finally:
            with self._lock:
                self._capture = None

    def record(self, name: str, dt: float) -> None:
        """One interval of ``dt`` seconds for timer ``name``, measured by
        the caller (for example with CUDA events)."""
        with self._lock:
            self._add_time(name, dt)

    def _add_time(self, name: str, dt: float) -> None:   # under the lock
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
