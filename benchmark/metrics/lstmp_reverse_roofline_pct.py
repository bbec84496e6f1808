"""lstmp_reverse_roofline_pct: the least time the H100 could take for the
reverse fast-lstmp recurrences of the traced steps (a BLSTM's backward
layers; counts/blstm.py: per layer and pass the larger of operations over
the bf16 peak and bytes over HBM bandwidth, at the cell's B, steps, C and
R) over the device time of the reverse-walk kernels in the traced span,
by kernel name (csrc/lstmp.cu).  None where the trace has no reverse-walk
kernel or the record no bound."""

KERNELS = ("lstmp_rev_fwd_kernel", "lstmp_rev_bwd_kernel")


def read(rec):
    trace, bound = rec.get("trace"), rec.get("lstmp_reverse_bound")
    if not trace or not bound:
        return None
    k = trace["kernels"]
    count = sum(k[n]["launches"] for n in KERNELS if n in k)
    seconds = sum(k[n]["seconds"] for n in KERNELS if n in k)
    if count == 0 or seconds <= 0:
        return None
    steps = count / bound["launches_per_step"]
    return 100.0 * steps * bound["bound_s_per_step"] / seconds
