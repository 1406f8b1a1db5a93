"""decode.ms_per_step: host milliseconds of the harness's spans around the
synthesizer's decoding (whole ``synthesize`` batches; for a stream, its
chunks after the first), over the decode steps ``Synthesizer.steps_decoded``
counted in them.  Only spans before the profiler
started count."""


def read(rec):
    return rec["decode_span_s"] * 1e3 / rec["decode_steps"] if rec.get("decode_steps") else None
