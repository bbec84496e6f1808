"""lstmp_roofline_pct: the least time the H100 could take for the fast-lstmp
recurrences of the traced steps (counts/lstmp.py: per layer and pass the
larger of operations over the bf16 peak and bytes over HBM bandwidth, at
the cell's B, steps, C and R) over the device time of the recurrence
kernels in the traced span, by kernel name (csrc/lstmp.cu)."""

KERNELS = ("lstmp_fwd_kernel", "lstmp_bwd_kernel")


def read(rec):
    trace, bound = rec.get("trace"), rec.get("lstmp_bound")
    if not trace or not bound:
        return None
    k = trace["kernels"]
    count = sum(k[n]["launches"] for n in KERNELS if n in k)
    seconds = sum(k[n]["seconds"] for n in KERNELS if n in k)
    if count == 0 or seconds <= 0:
        return None
    steps = count / bound["launches_per_step"]
    return 100.0 * steps * bound["bound_s_per_step"] / seconds
