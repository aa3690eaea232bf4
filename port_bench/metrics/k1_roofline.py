"""k1_roofline: % of K1's event time that the HBM bytes bound takes: the
packed and unpacked bytes of the window's files, counted from their chunk
headers (so the same work whatever implements K1), read and written once
at 3.35 TB/s, over K1's summed CUDA-event time (the traced run)."""

from port_bench import hw


def read(run):
    if not run.spans:
        return None
    k1_s = sum(s.k1_s for s in run.spans)
    if k1_s <= 0:
        return None
    bound = sum(hw.decode_bytes_bound_s(c.packed, c.unpacked)
                for c in run.calls if c.error is None)
    return 100.0 * bound / k1_s
