"""train_step.host_ms: mean, over the clean stretch's optimizer steps, of
the program's ``train.step`` span less its ``train.readback`` (the host
waiting for the device), in ms: the host's own work a step."""

from portbench import spans


def read(rec):
    traces = spans.clean_traces(rec)
    steps = spans.train_steps(traces) if traces else []
    host = [group[0].ns - sum(s.ns for s in group if s.name == "train.readback")
            for group in steps]
    return sum(host) / len(host) / 1e6 if host else None
