"""stream.setup_ms: per request, the first chunk's time minus the decode
steps run before it times the request's median ms per step of its later
chunks: a difference, not a span; the median over the window's requests."""

from portbench.harness import percentile


def read(rec):
    return percentile(rec.get("stream_setup_ms", []), 50)
