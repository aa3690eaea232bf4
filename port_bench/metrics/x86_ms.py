"""x86_ms: mean ms of X4 x86 a call: the window's
``device_filters.x86_ms`` (CUDA events around each X4 x86 launch of the 7z
route) over its calls, a counter of the port's own trace (the traced run;
``program_spans.py``).  None where the port counts no x86 time."""

from port_bench import program_spans


def read(run):
    w = program_spans.window(run)
    if w is None or not run.calls:
        return None
    ms = w.counters.get("device_filters.x86_ms")
    if not ms:
        return None
    return ms / len(run.calls)
