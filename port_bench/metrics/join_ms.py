"""join_ms: mean ms a call spends in the port's own spans
``scheduler.outputs`` (the lanes' status checks and retries, the
copy-only and host groups placed) and ``api.join`` (the result's view
released) (the traced run; ``program_spans.py``)."""

from port_bench import program_spans


def read(run):
    return program_spans.per_call_ms(run, ("scheduler.outputs", "api.join"))
