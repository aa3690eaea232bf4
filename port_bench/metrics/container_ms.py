"""container_ms: mean host ms a call spends outside its blocks'
``lzma2_uncompress`` calls (the wrapper of ``containers.xz.lzma2_uncompress``)
less ``check_ms``: the headers, index and footer parsed, each block's
``bytes(body)`` copy, ``out += body`` and the final ``bytes(out)`` (the
traced run's wrappers; ``xz_file`` cells)."""


def read(run):
    spans = run.spans or ()
    if not spans or not any("inner" in s.timed for s in spans):
        return None
    outside = [c.seconds - s.timed.get("inner", 0.0)
               - s.timed.get("check", 0.0)
               for c, s in zip(run.calls, spans)]
    return sum(outside) / len(outside) * 1e3
