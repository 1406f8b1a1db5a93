"""batcher.queued_p95_ms: 95th percentile, over the requests of the clean
stretch's batches, of the program's ``batcher.queued`` span (``submit`` to
the start of the request's batch's ``synthesize``), in ms."""

from portbench import spans
from portbench.harness import percentile


def read(rec):
    traces = spans.clean_traces(rec)
    if traces is None:
        return None
    return percentile([s.ns / 1e6 for s in spans.named(traces, "batcher.queued")], 95)
