"""k1_launches_per_call: mean ``G.submit_groups`` calls (K1 launches) a
call: one per block where each block is its own ``lzma2_uncompress`` call,
one per budget-sized batch where a call's blocks share launches (the
traced run's wrappers)."""


def read(run):
    if not run.spans:
        return None
    return sum(s.launches for s in run.spans) / len(run.spans)
