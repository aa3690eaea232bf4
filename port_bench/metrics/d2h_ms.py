"""d2h_ms: mean ms a call spends in the port's own span
``group_decode.d2h``: ``finalize_chunks``' copies of each batch's output
and status rows to the host (the traced run; ``program_spans.py``)."""

from port_bench import program_spans


def read(run):
    return program_spans.per_call_ms(run, ("group_decode.d2h",))
