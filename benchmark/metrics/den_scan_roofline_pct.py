"""den_scan_roofline_pct: the least time the H100 could take for the den's
scans (counts/den_scan.py: the larger of operations over the bf16 peak and
bytes over HBM bandwidth, at the cell's F, L, N and T) over their device
time in the traced span, by kernel name (csrc/den_scan.cu's kernels)."""

SCAN_KERNELS = ("fwd_init_kernel", "fwd_operand_kernel", "fwd_product_kernel",
                "fwd_update_kernel", "bwd_init_kernel", "bwd_operand_kernel",
                "bwd_product_kernel", "bwd_update_kernel", "sum_parts_kernel",
                "plane_product_kernel")


def read(rec):
    trace = rec.get("trace")
    if not trace:
        return None
    k = trace["kernels"]
    scans = sum(k[n]["launches"] for n in ("fwd_init_kernel",
                                           "bwd_init_kernel") if n in k)
    seconds = sum(k[n]["seconds"] for n in SCAN_KERNELS if n in k)
    if scans == 0 or seconds <= 0:
        return None
    return 100.0 * scans * rec["den_scan_bound"]["bound_s"] / seconds
