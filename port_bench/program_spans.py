"""The port's own spans and counters in the traced run.

The port's ``utils/trace.TRACE`` switches its spans on by itself while a
``torch.profiler`` session is on: each span of the window is then a
``record_function`` range of its name (so ``profiling.reduce`` names idle
time by the program's own steps) and a record kept in ``TRACE.profiled``.
``window(run)``, on the first read after the window, takes those records
and the trace's counters (reset after the warm-up, so the window's), keeps
them on the run as ``run.program`` and prints the ``program spans`` line
on standard error.  A port without ``TRACE.profiled`` (one older than
these spans) yields nothing to read, and the readers of ``metrics/`` that
use this module return None.

Each call of ``lzma2_uncompress`` is one root span, ``ROOT``, with a call
id its children carry; a span's self time is its length less its direct
children's.
"""

from __future__ import annotations

import dataclasses
import json
import sys

ROOT = "api.lzma2_uncompress"


@dataclasses.dataclass
class Window:
    """The program's spans (``utils/trace.Span``) and counters
    (``TRACE.snapshot()``) of one traced window."""

    spans: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)
    dropped: int = 0


def window(run) -> Window | None:
    """The program's ``Window`` of the traced run ``run`` (None where the
    port kept no span), read from the port once and kept as
    ``run.program``; a run that already has ``program`` gives that."""
    if hasattr(run, "program"):
        return run.program
    from lzma_sdk_zliblike_tpu_torch.utils.trace import TRACE
    cap = getattr(TRACE, "profiled", None)
    spans = cap.take() if cap is not None else []
    run.program = Window(spans, TRACE.snapshot(), cap.dropped) \
        if spans else None
    if run.program is not None:
        print(summary_line(run.program), file=sys.stderr, flush=True)
    return run.program


def calls(spans) -> dict:
    """Call id -> its root span."""
    return {s.call: s for s in spans if s.name == ROOT and s.call is not None}


def per_call_ms(run, names) -> float | None:
    """Mean ms a call spends in the spans ``names`` (summed), or None where
    the window holds no call or none of those spans."""
    w = window(run)
    if w is None:
        return None
    roots = calls(w.spans)
    inside = [s for s in w.spans if s.name in names and s.call in roots]
    if not roots or not inside:
        return None
    return sum(s.end_ns - s.start_ns for s in inside) * 1e-6 / len(roots)


def self_ns(spans) -> dict:
    """Span id -> its self time in ns."""
    own = {s.id: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent in own:
            own[s.parent] -= s.end_ns - s.start_ns
    return own


def table(spans) -> dict:
    """Per span name: count, total, self and largest, in ms."""
    own = self_ns(spans)
    out: dict = {}
    for s in spans:
        row = out.setdefault(s.name, {"count": 0, "total_ms": 0.0,
                                      "self_ms": 0.0, "max_ms": 0.0})
        ms = (s.end_ns - s.start_ns) * 1e-6
        row["count"] += 1
        row["total_ms"] += ms
        row["self_ms"] += own[s.id] * 1e-6
        row["max_ms"] = max(row["max_ms"], ms)
    return out


def tree(spans, root) -> list:
    """``[name, ms, self ms, [children...]]`` of ``root``, children in the
    order they started."""
    own = self_ns(spans)
    kids: dict = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)

    def node(s):
        return [s.name, (s.end_ns - s.start_ns) * 1e-6, own[s.id] * 1e-6,
                [node(c) for c in sorted(kids.get(s.id, ()),
                                         key=lambda c: c.start_ns)]]
    return node(root)


def summary_line(window: Window) -> str:
    """One line: each span's count, total, self time and largest, the
    window's counters, the slowest call's tree, and how many spans the
    capture dropped."""
    roots = calls(window.spans)
    slowest = max(roots.values(), key=lambda s: s.end_ns - s.start_ns,
                  default=None)
    return "program spans " + json.dumps({
        "calls": len(roots), "dropped": window.dropped,
        "spans": table(window.spans),
        "counters": {k: v for k, v in window.counters.items()
                     if not isinstance(v, dict)},
        "slowest_call": tree(window.spans, slowest) if slowest else None})
