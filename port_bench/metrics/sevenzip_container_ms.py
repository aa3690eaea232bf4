"""sevenzip_container_ms: mean ms a call of
``containers/sevenzip.extract(engine="device")`` spends outside the
decode, the filter and the checks: each root span ``sevenzip.extract``
less its direct children ``sevenzip.decode``, ``sevenzip.filter`` and
``sevenzip.check`` (an x86 launch on a K1 row is inside the decode), so
the header read and the files cut from the result (the traced run;
``program_spans.py``)."""

from port_bench import program_spans

ROOT = "sevenzip.extract"
INNER = ("sevenzip.decode", "sevenzip.filter", "sevenzip.check")


def read(run):
    w = program_spans.window(run)
    if w is None:
        return None
    roots = {s.id: s for s in w.spans if s.name == ROOT}
    if not roots or not any(s.name == INNER[0] and s.parent in roots
                            for s in w.spans):
        return None
    ns = sum(s.end_ns - s.start_ns for s in roots.values())
    ns -= sum(s.end_ns - s.start_ns for s in w.spans
              if s.name in INNER and s.parent in roots)
    return ns * 1e-6 / len(roots)
