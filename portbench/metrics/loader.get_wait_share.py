"""loader.get_wait_share: the program's ``data.wait`` spans (the training
loop blocked on the prefetch queue) over its ``train.step`` spans, summed
over the clean stretch, in percent."""

from portbench import spans


def read(rec):
    traces = spans.clean_traces(rec)
    if not traces:
        return None
    step = sum(group[0].ns for group in spans.train_steps(traces))
    wait = sum(s.ns for s in spans.named(traces, "data.wait"))
    return 100.0 * wait / step if step else None
