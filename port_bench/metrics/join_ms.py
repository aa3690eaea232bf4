"""join_ms: mean ms a call spends in the port's own spans
``scheduler.outputs`` (each group's slice copied into ``bytes``, the
batch's host output freed) and ``api.join`` (the ordered join) (the traced
run; ``program_spans.py``)."""

from port_bench import program_spans


def read(run):
    return program_spans.per_call_ms(run, ("scheduler.outputs", "api.join"))
