"""batcher.fill_ms: mean of the program's ``batcher.fill`` span (from taking
a batch's first request to closing the batch) over the clean stretch's
batches."""

from portbench import spans


def read(rec):
    traces = spans.clean_traces(rec)
    fills = spans.named(traces, "batcher.fill") if traces else []
    return sum(s.ns for s in fills) / len(fills) / 1e6 if fills else None
