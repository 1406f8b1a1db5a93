"""train_step.mfu: the model's operations in the optimizer steps run in the
window (two forwards and one backward per micro-batch, from the real
lengths, ``counts.train_micro_flops``) over the window's seconds times the
bf16 peak, in percent.  Only steps run before the profiler started
count, with their seconds."""

from portbench.counts import PEAK_BF16_FLOPS


def read(rec):
    s = rec.get("clean_s")
    return 100.0 * rec["mfu_flops"] / (s * PEAK_BF16_FLOPS) if s else None
