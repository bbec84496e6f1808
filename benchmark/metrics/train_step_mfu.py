"""train_step_mfu: the model's FLOPs per step (counts/, from the
configuration's shapes) times the window's steps, over the window's
seconds, as a share of the H100's bf16 peak."""

from benchmark.counts.peaks import H100_PEAK_BF16_FLOPS


def read(rec):
    if not rec.get("steps") or rec.get("window_s", 0) <= 0:
        return None
    return (100.0 * rec["flops_per_step"] * rec["steps"]
            / rec["window_s"] / H100_PEAK_BF16_FLOPS)
