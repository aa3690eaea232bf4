"""sevenzip_check_ms: mean ms a call spends in the port's span
``sevenzip.check``: the folder and file CRC32s of
``containers/sevenzip.extract(engine="device")`` on the host (the traced
run; ``program_spans.py``, each call a root span ``sevenzip.extract``)."""

from port_bench import program_spans

ROOT = "sevenzip.extract"


def read(run):
    w = program_spans.window(run)
    if w is None:
        return None
    roots = {s.call for s in w.spans if s.name == ROOT}
    checks = [s for s in w.spans if s.name == "sevenzip.check"
              and s.call in roots]
    if not roots or not checks:
        return None
    return sum(s.end_ns - s.start_ns for s in checks) * 1e-6 / len(roots)
