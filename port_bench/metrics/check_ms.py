"""check_ms: mean host ms a call spends in the port's block checks,
``containers.xz._check_compute`` (each block's CRC64), summed over the
call's blocks (the traced run's wrappers; ``xz_file`` cells)."""


def read(run):
    spans = run.spans or ()
    if not any("check" in s.timed for s in spans):
        return None
    return sum(s.timed.get("check", 0.0) for s in spans) / len(spans) * 1e3
