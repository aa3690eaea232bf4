"""The traced run's device trace: ``torch.profiler`` over the window, read
back from its Chrome trace.

Once another process has used the card, a profiler session can lose the
device events of its first launch or two.  So a session opens with three
throwaway launches (``torch.cuda._sleep``) before the window, as
``chip_smoke.launch_ms`` does.  The window cannot be repeated, so a K1
launch that still has no event is named in the breakdown, and the K1 time
that the CUDA events around the launches hold beyond the profiler's is
added to the busy time (K1 runs alone on its stream, so that time
overlaps no other device operation); K1's per-layer times come from CUDA
events in any case.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "window"
K1_KERNEL = "group_decode_kernel"


@contextlib.contextmanager
def session(torch):
    """A profiler session (host and device) that yields the profiler; its
    window is the ``WINDOW`` range the caller opens inside it."""
    from torch.profiler import ProfilerActivity, profile
    card = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if card else [])) as prof:
        if card:
            for _ in range(3):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        yield prof


def trace_events(prof) -> list:
    """The session's events, from its Chrome trace (written to a temporary
    file and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _op_name(ev: dict) -> str:
    name = ev.get("name", "")
    if ev.get("cat") == "kernel":
        name = re.split(r"[(<]", name.replace("(anonymous namespace)::", ""))
        name = name[0].split("::")[-1].split()
        name = name[-1] if name else "kernel"
    return name


def reduce(events: list, k1_launches: int, k1_event_s: float = 0.0) -> dict:
    """Device busy seconds, the window's length, the ten device operations
    that took most time, and the device's idle time summed by what the host
    was doing: each idle stretch cut where a host range opens or closes,
    each piece named by the innermost range open over it (``harness``
    where none of the wrappers' ranges is); the ten largest sums.  Where
    fewer than ``k1_launches`` K1 events are found, the busy time gains
    what ``k1_event_s`` (K1's CUDA-event time) holds beyond theirs."""
    spans = [e for e in events if e.get("ph") == "X"]
    windows = [e for e in spans if e.get("cat") == "user_annotation"
               and e.get("name") == WINDOW]
    if not windows:
        return {}
    w0 = float(windows[0]["ts"])
    w1 = w0 + float(windows[0]["dur"])
    dev = [e for e in spans if e.get("cat") in DEVICE_CATS
           and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    busy = _union((max(w0, float(e["ts"])),
                   min(w1, float(e["ts"]) + float(e["dur"]))) for e in dev)
    ops: dict[str, float] = {}
    k1_events = 0
    for e in dev:
        name = _op_name(e)
        ops[name] = ops.get(name, 0.0) + float(e["dur"]) * 1e-6
        k1_events += name == K1_KERNEL
    lost_s = 0.0
    if k1_events < k1_launches:
        t = ops.pop(K1_KERNEL, 0.0)
        ops[f"{K1_KERNEL} ({k1_launches - k1_events} of {k1_launches} "
            "launches without a profiler event)"] = t
        lost_s = max(0.0, k1_event_s - t)
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e["name"]) for e in spans
                   if e.get("cat") == "user_annotation"
                   and e.get("name") != WINDOW), key=lambda r: r[0])
    gaps: dict[str, float] = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        over = [h for h in host if h[0] < b and h[1] > a]
        cuts = sorted({a, b} | {x for h in over for x in h[:2] if a < x < b})
        for p, q in zip(cuts, cuts[1:]):
            mid = (p + q) / 2
            inner = [h for h in over if h[0] <= mid < h[1]]
            label = min(inner, key=lambda h: h[1] - h[0])[2] if inner \
                else "harness"
            gaps[label] = gaps.get(label, 0.0) + (q - p) * 1e-6
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6 + lost_s,
            "window_s": (w1 - w0) * 1e-6,
            "k1_events": k1_events,
            "breakdown": {"device_ops": [[n, t] for n, t in top],
                          "idle_gaps": [[n, t] for n, t in idle]}}
