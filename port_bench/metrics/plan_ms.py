"""plan_ms: mean host ms a call spends in ``framing.scan``,
``framing.split_groups`` and ``utils/memory.shape_for_groups`` (the
traced run's wrappers)."""


def read(run):
    if not run.spans:
        return None
    return sum(s.plan_s for s in run.spans) / len(run.spans) * 1e3
