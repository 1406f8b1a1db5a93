"""decode.host_ms_per_step: the program's ``decode.loop`` spans less the
time they spent in the per-step stop readback (``readback_ns``, the host
waiting for the device), over their steps, in ms: the host's own work a
step.  Loops as ``decode.loop_ms_per_step``."""

from portbench import spans


def read(rec):
    loops = spans.decode_loops(rec)
    return spans.ms_per_step(loops, lambda s: s.ns - s.attrs["readback_ns"]) if loops else None
