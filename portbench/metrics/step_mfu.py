"""step_mfu: the decode steps' summed bound (``counts.decode_step_bytes_flops``;
at these widths every step is bound by bytes, so this is the share of the
HBM bandwidth the whole step reaches) over the host time of the spans that
ran them, in percent.  Only spans before the profiler
started count."""


def read(rec):
    return 100.0 * rec["decode_bound_s"] / rec["decode_span_s"] if rec.get("decode_span_s") else None
