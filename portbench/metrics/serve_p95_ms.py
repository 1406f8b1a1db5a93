"""serve_p95_ms: 95th percentile, over every request due in the window, of
the time from when it was due to the mel in the caller's hand.  A request
that failed counts as 1e9 ms."""

from portbench.harness import percentile


def read(rec):
    return percentile([min(v, 1e9) for v in rec["latency_ms"]], 95)
