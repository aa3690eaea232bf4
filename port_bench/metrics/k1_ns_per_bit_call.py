"""k1_ns_per_bit_call: K1's time per step of its serial chain, ns: the
window's ``group_decode.kernel_ms`` (CUDA events around each launch)
over its ``group_decode.chain_bit_calls`` (each launch's most range-coder
bit calls in one lane), both counters of the port's own trace (the traced
run; ``program_spans.py``)."""

from port_bench import program_spans


def read(run):
    w = program_spans.window(run)
    if w is None:
        return None
    ms = w.counters.get("group_decode.kernel_ms")
    chain = w.counters.get("group_decode.chain_bit_calls")
    if not ms or not chain:
        return None
    return ms * 1e6 / chain
