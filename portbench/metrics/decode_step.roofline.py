"""decode_step.roofline: the summed bound of the decode steps in the
profiled stretch over the device time of their ``decode_step_kernel``
launches, in percent."""

from portbench.harness import device_seconds


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof.get("decode_bound_s"):
        return None
    dev, launches = device_seconds(prof, "decode_step_kernel")
    return 100.0 * prof["decode_bound_s"] / dev if dev > 0 and launches else None
