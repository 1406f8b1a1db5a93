"""decode.plan_hit_share: the share, in %, of the clean stretch's
``decode.plan`` spans (one a chunk of rows of a decode) whose ``hit`` is
true: the shape's decode-step preparation (plan, its tables on the device,
the PE rows) came from the program's cache.  A program whose spans carry
no ``hit`` gives None."""

from portbench import spans


def read(rec):
    traces = spans.clean_traces(rec)
    if traces is None:
        return None
    plans = [s for s in spans.named(traces, "decode.plan") if "hit" in s.attrs]
    if not plans:
        return None
    return 100.0 * sum(bool(s.attrs["hit"]) for s in plans) / len(plans)
