"""synth.prepare_ms: median, over the decode calls (batches or stream
requests) of the clean stretch, of the program's ``synth.g2p`` plus
``decode.init`` spans (text to ids; the encoder, the cross K/V and the
plan of each chunk of rows), in ms."""

from portbench import spans
from portbench.harness import percentile


def read(rec):
    traces = spans.clean_traces(rec)
    if traces is None:
        return None
    per_call = [sum(s.ns for s in group if s.name in ("synth.g2p", "decode.init")) / 1e6
                for group in traces.values() if any(s.name == "decode.init" for s in group)]
    return percentile(per_call, 50)
