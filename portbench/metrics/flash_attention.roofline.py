"""flash_attention.roofline: the summed bound of the flash-attention
launches of the profiled optimizer steps (``counts.train_kernel_bounds``)
over the device time of every ``flash_`` kernel in them, in percent."""

from portbench.harness import device_seconds


def read(rec):
    prof = rec.get("profile")
    if not prof:
        return None
    dev, _ = device_seconds(prof, "flash_")
    return 100.0 * prof["bounds"]["flash"] / dev if dev > 0 and prof["bounds"]["flash"] else None
