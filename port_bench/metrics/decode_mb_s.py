"""decode_mb_s: 10^6 original bytes per second, host clock: every byte of
the window's completed calls over the window's whole time (not a median of
calls)."""


def read(run):
    if run.window_s <= 0:
        return None
    return sum(c.out_bytes for c in run.calls if c.error is None) \
        / run.window_s / 1e6
