"""decode.loop_ms_per_step: the program's ``decode.loop`` spans over the
steps they counted (``steps``), in ms, over the clean stretch (a stream:
its chunks after the first, as ``decode.ms_per_step``)."""

from portbench import spans


def read(rec):
    loops = spans.decode_loops(rec)
    return spans.ms_per_step(loops, lambda s: s.ns) if loops else None
