"""The readers of the program's own spans (``portbench/spans.py``) after a
whole run of each traffic kind on the CPU at a tiny configuration, as
``run.py`` calls them: every reader gives a number, and what they select is
the window's clean stretch: the selected decode loops' steps are the
record's ``decode_steps``, the selected optimizer steps the window's, the
selected requests the batcher's count over the window."""

import copy

import pytest
import torch

from portbench import harness, spans
from portbench.tests.test_portbench_faults import serve_cell, tiny_config, train_cell

NEW = {
    "ljspeech.serve-poisson": ["batcher.queued_p95_ms.serve", "batcher.fill_ms.serve",
                               "decode.loop_ms_per_step.serve", "decode.host_ms_per_step.serve",
                               "synth.prepare_ms.serve"],
    "ljspeech.stream-b1": ["decode.loop_ms_per_step.stream", "decode.host_ms_per_step.stream",
                           "synth.prepare_ms.stream", "stream.plan_ms.stream"],
    "paper.serve-backlog": ["decode.loop_ms_per_step.backlog", "decode.host_ms_per_step.backlog",
                            "synth.prepare_ms.backlog"],
    "paper.train-buckets": ["train_step.host_ms.train", "loader.get_wait_share.train"],
}


def cell(name):
    if name == "ljspeech.serve-poisson":
        return serve_cell()
    if name == "paper.train-buckets":
        return train_cell()
    c = copy.deepcopy(harness.cell_spec(name))
    c["params"].update(frames=256, n_checked=4, pool=400)
    if name == "paper.serve-backlog":
        c["params"].update(clients=8)
    return c


def test_every_new_span_metric_is_in_the_benchmark():
    s = harness.benchmark_spec()
    for name, metrics in NEW.items():
        listed = {e["name"] for e in harness.cell_metrics(s, name, True)}
        assert set(metrics) <= listed, name
    entries = {e["name"]: e for e in s["per_layer"]}
    assert all(entries[m]["source"] == "program_span" for ms in NEW.values() for m in ms)
    assert sum(len(ms) for ms in NEW.values()) == 14


@pytest.mark.parametrize("name", list(NEW))
def test_span_readers_read_the_windows_clean_stretch(name):
    config = tiny_config(cell(name)["config"])
    rec = harness.run_cell(name, 2**31 + 33, 2.0, False, device="cpu", config_override=config,
                           cell_override=cell(name), t_start=harness.process_start())
    for metric in NEW[name]:
        value = harness.reader(metric).read(rec)
        assert isinstance(value, float) and value >= 0.0, (metric, value)
    traces = spans.clean_traces(rec)
    if name == "paper.train-buckets":
        steps = spans.train_steps(traces)
        assert len(steps) == rec["attempted"] > 0
        assert len(spans.named(traces, "data.wait")) >= rec["attempted"]
        return
    loops = spans.decode_loops(rec)
    assert sum(s.attrs["steps"] for s in loops) == rec["decode_steps"] > 0
    if "batcher" in rec:
        assert len(spans.named(traces, "batcher.queued")) == rec["batcher"]["n_requests"]
        assert len(spans.named(traces, "batcher.batch")) == rec["batcher"]["n_batches"]
    else:  # one trace a request, each with its set-up
        assert len(spans.named(traces, "decode.init")) == rec["attempted"]
    # the readers leave the metrics the harness prints as they were
    out = harness.result_line(name, rec, True, torch.device("cpu"))
    assert set(NEW[name]) <= set(out["metrics"])


def test_no_tracer_gives_no_value(monkeypatch):
    """A program without ``utils/trace.py`` (an older checkout): every span
    reader returns None and the line leaves the metric out."""
    import builtins

    real = builtins.__import__

    def no_trace(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "transformertts_tpu_torch.utils" and "trace" in (fromlist or ()):
            raise ImportError("cannot import name 'trace'")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_trace)
    rec = {"setup_s": 1.0, "first_chunk_ms": []}
    for metric in {m for ms in NEW.values() for m in ms}:
        assert harness.reader(metric).read(rec) is None, metric


@pytest.mark.card
def test_span_ranges_leave_the_device_timeline_alone(cuda_device):
    """Under a running profiler the spans are host ranges only: nothing of
    theirs lands on the device's timeline, where ``device_idle`` reads."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from transformertts_tpu_torch.utils import trace

    x = torch.ones(512, 512, device=cuda_device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with trace.span("probe.outer"):
            for _ in range(3):
                with trace.step_range("probe.step"):
                    x = (x @ x) * 1e-3
        torch.cuda.synchronize()
    events = {(e.name, e.device_type) for e in prof.events()}
    assert {("probe.outer", DeviceType.CPU), ("probe.step", DeviceType.CPU)} <= events
    assert not [n for n, d in events if n.startswith("probe.") and d != DeviceType.CPU]
