"""batcher.queue_wait_p95_ms: 95th percentile over requests of the start of
the batch that served a request minus the time the request was due (the
harness's span around each batch the batcher hands to the synthesizer)."""

from portbench.harness import percentile


def read(rec):
    return percentile(rec.get("queue_wait_ms", []), 95)
