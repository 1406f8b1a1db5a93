"""stream.plan_ms: median, over the stream requests of the clean stretch, of
their ``decode.plan`` spans (a chunk of rows' PE table, permuted cross K/V,
caches and ``DecodeStep``), in ms."""

from portbench import spans
from portbench.harness import percentile


def read(rec):
    traces = spans.clean_traces(rec)
    if traces is None:
        return None
    return percentile([sum(s.ns for s in group if s.name == "decode.plan") / 1e6
                       for group in traces.values()
                       if any(s.name == "decode.plan" for s in group)], 50)
