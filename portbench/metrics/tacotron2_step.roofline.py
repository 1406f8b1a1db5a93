"""tacotron2_step.roofline: the summed bound of the Tacotron 2 decoder
steps in the profiled stretch (``counts_tacotron2``) over the device time
of every launch whose kernel name holds ``tacotron2_step`` (one a step,
or each of a step's launches should it take more), in percent."""

from portbench.harness import device_seconds


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof.get("t2_bound_s"):
        return None
    dev, launches = device_seconds(prof, "tacotron2_step")
    return 100.0 * prof["t2_bound_s"] / dev if dev > 0 and launches else None
