"""after_k1_ms: mean host ms a call takes from K1's end (a synchronise
before ``finalize_chunks``) to its return: the copy out and the ordered
join (the traced run)."""


def read(run):
    spans = [s for s in run.spans or () if s.k1_end is not None]
    if not spans:
        return None
    return sum(s.after_s for s in spans) / len(spans) * 1e3
