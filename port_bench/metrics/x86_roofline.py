"""x86_roofline: % of X4 x86's event time that the HBM bytes bound takes:
the window's ``device_filters.x86_bytes`` read once and written once at
3.35 TB/s (``hw.py``), over its ``device_filters.x86_ms``, both counters
of the port's own trace (the traced run; ``program_spans.py``)."""

from port_bench import hw, program_spans


def read(run):
    w = program_spans.window(run)
    if w is None:
        return None
    ms = w.counters.get("device_filters.x86_ms")
    n = w.counters.get("device_filters.x86_bytes")
    if not ms or not n:
        return None
    return 100.0 * hw.decode_bytes_bound_s(n, n) / (ms * 1e-3)
