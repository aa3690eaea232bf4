"""device_idle_pct: % of the traced window in which no operation ran on
the card: 100 x (1 - busy_s / window_s), both from the profiler's trace
(``profiling.reduce``: the union of every kernel, copy and memset over the
window, with K1's CUDA-event time standing in for launches the profiler
lost)."""


def read(run):
    prof = run.profile
    if not prof or prof["window_s"] <= 0 or prof["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
