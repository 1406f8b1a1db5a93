"""fused_ln.roofline: the summed bound of the fused residual LayerNorm
launches of the profiled optimizer steps over the device time of their
``ln_fwd_kernel`` and ``ln_bwd_kernel`` launches, in percent."""

from portbench.harness import device_seconds


def read(rec):
    prof = rec.get("profile")
    if not prof:
        return None
    dev, _ = device_seconds(prof, "ln_fwd_kernel", "ln_bwd_kernel")
    return 100.0 * prof["bounds"]["ln"] / dev if dev > 0 and prof["bounds"]["ln"] else None
