"""first_chunk_p90_ms: 90th percentile, over the window's stream requests,
of the time from the ``Synthesizer.stream`` call to its first chunk."""

from portbench.harness import percentile


def read(rec):
    return percentile(rec["first_chunk_ms"], 90)
