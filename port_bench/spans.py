"""Spans of the traced run, taken by wrappers that this benchmark puts around
the port's module attributes at call time (as ``chip_smoke.engine_run``
does around ``G.submit_groups``).  No span lives inside the program.

Per call of ``lzma2_uncompress`` (``CallSpans``):

* ``plan_s``: host time in ``framing.scan``, ``framing.split_groups`` and
  ``utils/memory.shape_for_groups``;
* ``pack_s``: from the plan's end to K1's first launch (``_assemble``,
  ``prep_groups`` and the scheduler's routing between), plus the time in
  ``_assemble`` and ``prep_groups`` of any later batch;
* ``k1_s``: CUDA events on the launch stream around each
  ``G.submit_groups``, summed (the host clock on the CPU, where the plain
  version decodes inside the call);
* ``after_s``: from K1's end (a synchronise before the first
  ``finalize_chunks``) to the call's return: the copy out and the ordered
  join;
* ``timed``: per key of the entry point's ``TIMED``, the host time in the
  port function it names (``xz_file``: each block's ``lzma2_uncompress``,
  ``inner``, and its check, ``check``), summed.

Where a call holds several ``lzma2_uncompress`` calls (an ``.xz`` file's
blocks), ``plan_s``, ``launches`` and ``k1_s`` sum over them; the marks
``plan_end``, ``first_launch`` and ``k1_end`` are the first inner call's.

Each wrapper also opens a ``torch.profiler.record_function`` range, so the
profiler's trace can name what the host did while the card was idle.
"""

from __future__ import annotations

import dataclasses
import importlib
import time

LABELS = {"scan": "plan", "split_groups": "plan",
          "shape_for_groups": "plan", "_assemble": "pack_h2d",
          "prep_groups": "pack_h2d", "submit_groups": "k1_launch",
          "finalize_chunks": "after_k1"}


@dataclasses.dataclass
class CallSpans:
    plan_s: float = 0.0
    plan_end: float | None = None
    first_launch: float | None = None
    later_pack_s: float = 0.0
    k1_marks: list = dataclasses.field(default_factory=list)
    k1_host_s: float = 0.0
    k1_end: float | None = None
    returned: float | None = None
    launches: int = 0
    timed: dict = dataclasses.field(default_factory=dict)

    @property
    def pack_s(self) -> float:
        if self.plan_end is None or self.first_launch is None:
            return self.later_pack_s
        return self.first_launch - self.plan_end + self.later_pack_s

    @property
    def after_s(self) -> float:
        if self.k1_end is None or self.returned is None:
            return 0.0
        return self.returned - self.k1_end

    @property
    def k1_s(self) -> float:
        """K1's time in this call (read once the card has passed the
        events)."""
        return self.k1_host_s + sum(a.elapsed_time(b)
                                    for a, b in self.k1_marks) * 1e-3


class Spans:
    """Installs the wrappers (``with Spans(): ...``) and keeps one
    ``CallSpans`` per call between ``begin_call`` and ``end_call``.
    ``timed``: an entry point's ``TIMED``, wrapped besides."""

    def __init__(self, timed=()):
        self.timed = timed
        self.calls: list[CallSpans] = []
        self.current: CallSpans | None = None
        self._saved: list = []

    # -- calls --------------------------------------------------------------
    def begin_call(self) -> None:
        self.current = CallSpans()

    def end_call(self, returned: float) -> CallSpans:
        cur, self.current = self.current, None
        cur.returned = returned
        self.calls.append(cur)
        return cur

    def reset(self) -> None:
        self.calls.clear()

    # -- wrappers -----------------------------------------------------------
    def __enter__(self):
        import torch
        from lzma_sdk_zliblike_tpu_torch.models.lzma2 import framing
        from lzma_sdk_zliblike_tpu_torch.ops import group_decode as G
        from lzma_sdk_zliblike_tpu_torch.parallel import scheduler
        from lzma_sdk_zliblike_tpu_torch.utils import memory
        self._torch = torch
        self._wrap(framing, "scan", self._plan)
        self._wrap(framing, "split_groups", self._plan)
        self._wrap(memory, "shape_for_groups", self._plan_end)
        self._wrap(scheduler.BatchedLzma2Decoder, "_assemble", self._pack)
        self._wrap(G, "prep_groups", self._pack)
        self._wrap(G, "submit_groups", self._launch)
        self._wrap(G, "finalize_chunks", self._finalize)
        for module, attr, label, key in self.timed:
            self._wrap(importlib.import_module(module), attr,
                       self._timer(key), label)
        return self

    def __exit__(self, *exc):
        while self._saved:
            owner, attr, orig = self._saved.pop()
            setattr(owner, attr, orig)
        return False

    def _wrap(self, owner, attr: str, step, label: str | None = None) -> None:
        orig = getattr(owner, attr)
        label = label or f"{LABELS[attr]}.{attr}"
        record_function = self._torch.profiler.record_function

        def wrapper(*args, **kwargs):
            with record_function(label):
                return step(orig, args, kwargs)
        self._saved.append((owner, attr, orig))
        setattr(owner, attr, wrapper)

    def _timed(self, orig, args, kwargs):
        t = time.perf_counter()
        out = orig(*args, **kwargs)
        return out, t, time.perf_counter()

    def _timer(self, key: str):
        def step(orig, args, kwargs):
            out, t0, t1 = self._timed(orig, args, kwargs)
            if self.current is not None:
                timed = self.current.timed
                timed[key] = timed.get(key, 0.0) + t1 - t0
            return out
        return step

    def _plan(self, orig, args, kwargs):
        out, t0, t1 = self._timed(orig, args, kwargs)
        if self.current is not None:
            self.current.plan_s += t1 - t0
        return out

    def _plan_end(self, orig, args, kwargs):
        out, t0, t1 = self._timed(orig, args, kwargs)
        if self.current is not None:
            self.current.plan_s += t1 - t0
            self.current.plan_end = t1
        return out

    def _pack(self, orig, args, kwargs):
        out, t0, t1 = self._timed(orig, args, kwargs)
        if self.current is not None and self.current.launches:
            self.current.later_pack_s += t1 - t0
        return out

    def _launch(self, orig, args, kwargs):
        cur = self.current
        if cur is None:
            return orig(*args, **kwargs)
        if cur.first_launch is None:
            cur.first_launch = time.perf_counter()
        cur.launches += 1
        on_card = args[0].device.type == "cuda"
        if not on_card:             # the plain version decodes now
            out, t0, t1 = self._timed(orig, args, kwargs)
            cur.k1_host_s += t1 - t0
            return out
        Event = self._torch.cuda.Event
        marks = (Event(enable_timing=True), Event(enable_timing=True))
        marks[0].record()
        out = orig(*args, **kwargs)
        marks[1].record()
        cur.k1_marks.append(marks)
        return out

    def _finalize(self, orig, args, kwargs):
        cur = self.current
        if cur is not None and cur.k1_end is None:
            if self._torch.cuda.is_available():
                self._torch.cuda.synchronize()
            cur.k1_end = time.perf_counter()
        return orig(*args, **kwargs)
