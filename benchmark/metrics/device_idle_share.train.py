"""device_idle_share.train: the share of a window's step time in which the
device ran nothing (training cells).

The device's busy time per step comes from the traced span that follows
the window (the union of its kernel, copy and memset intervals over the
traced steps); the step's time from the window, which runs untraced.  The
profiler slows the host's side of a traced step, so the traced span's own
length would read the device idler than it is; the kernels' device time
it does not change.
"""


def read(rec):
    trace = rec.get("trace")
    if (not trace or "audio_s" not in rec or not rec.get("traced_steps")
            or not rec.get("steps") or rec.get("window_s", 0) <= 0):
        return None
    busy_per_step = trace["busy_s"] / rec["traced_steps"]
    return 100.0 * (1.0 - busy_per_step / (rec["window_s"] / rec["steps"]))
