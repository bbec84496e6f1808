"""recurrence_device_ms: the device milliseconds a traced step spends in
the fast-lstmp recurrence kernels of both directions (csrc/lstmp.cu's
forward and reverse walks, both passes), by kernel name, over the traced
steps.  None where the trace has none of them."""

KERNELS = ("lstmp_fwd_kernel", "lstmp_bwd_kernel", "lstmp_rev_fwd_kernel",
           "lstmp_rev_bwd_kernel")


def read(rec):
    trace, steps = rec.get("trace"), rec.get("traced_steps")
    if not trace or not steps:
        return None
    k = trace["kernels"]
    seconds = sum(k[n]["seconds"] for n in KERNELS if n in k)
    if seconds <= 0:
        return None
    return 1000.0 * seconds / steps
