"""pack_h2d_ms: mean host ms a call takes from the plan's end to K1's
launch: the scheduler's routing and ``_assemble``, and ``prep_groups``'s
copy to the card (the traced run's wrappers)."""


def read(run):
    if not run.spans:
        return None
    return sum(s.pack_s for s in run.spans) / len(run.spans) * 1e3
