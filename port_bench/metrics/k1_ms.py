"""k1_ms: mean ms of K1 a call, CUDA events on the launch stream around
each ``G.submit_groups``, summed over the call's launches (the traced
run)."""


def read(run):
    if not run.spans or not any(s.launches for s in run.spans):
        return None
    return sum(s.k1_s for s in run.spans) / len(run.spans) * 1e3
