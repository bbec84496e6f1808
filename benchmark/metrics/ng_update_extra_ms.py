"""ng_update_extra_ms: the mean device-timeline milliseconds of the steps
that fold NG-SGD's Fisher update in (every update_period-th) minus the
mean of the other steps, from CUDA events recorded as the loop pulls each
batch."""


def read(rec):
    steps = rec.get("step_ms")
    due = rec.get("ng_due")
    if not steps or not due:
        return None
    on = [ms for ms, d in zip(steps, due) if d]
    off = [ms for ms, d in zip(steps, due) if not d]
    if not on or not off:
        return None
    return sum(on) / len(on) - sum(off) / len(off)
