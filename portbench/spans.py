"""What the per-layer metrics of the program's own spans read: the spans of
the run's clean stretch from the tracer's ring
(``transformertts_tpu_torch/utils/trace.py``), grouped by trace id (one
batch, one stream request, one optimizer step, one loader wait).

The stretch is the one the harness's own span metrics count: from the
window's start to the first span recorded under a running profiler.  The
window's start is the process's start plus ``setup_s``, on the
``time.time()`` clock, carried onto the spans' clock through the tracer's
``CLOCK`` pair; ``harness.process_start`` reads ``/proc`` in 10-ms ticks,
so a trace counts when its first span starts no more than ``SLACK_NS``
before it.  Every warm-up trace starts 100 ms or more before the window
(a whole batch, stream or optimizer step), and the window's first one
within a millisecond after it.  A trace counts only if none of its spans
ran under the profiler.

A program without the tracer gives no spans, and every reader then returns
None: the metric is left out of the line.
"""

from __future__ import annotations

from portbench import harness

SLACK_NS = 25_000_000


def clean_traces(rec) -> dict[int, list] | None:
    """{trace id: its spans, by start} of the stretch's clean traces, or
    None without the tracer.  A request's own trace (its ``batcher.queued``)
    counts with the batch that served it."""
    try:
        from transformertts_tpu_torch.utils import trace
    except ImportError:
        return None
    every = trace.spans()
    wall0, ns0 = trace.CLOCK
    lo = ns0 + round((harness.process_start() + rec["setup_s"] - wall0) * 1e9) - SLACK_NS
    hi = min((s.start_ns for s in every if s.profiled and s.start_ns >= lo), default=None)
    by: dict[int, list] = {}
    for s in every:
        by.setdefault(s.trace, []).append(s)
    out = {}
    for tid, group in by.items():
        group.sort(key=lambda s: s.start_ns)
        first = group[0].start_ns
        if (group[0].name != "batcher.queued" and first >= lo and (hi is None or first < hi)
                and not any(s.profiled for s in group)):
            out[tid] = group
    served = [r for b in named(out, "batcher.batch") for r in b.attrs["requests"]]
    out.update((r, by[r]) for r in served if r in by)
    return out


def named(traces: dict, name: str) -> list:
    """The spans called ``name`` in ``traces``."""
    return [s for group in traces.values() for s in group if s.name == name]


def decode_loops(rec) -> list | None:
    """The clean stretch's ``decode.loop`` spans.  In a stream (a record
    with ``first_chunk_ms``) those that decoded a request's first chunk,
    before its first ``decode.postnet``, are left out, as
    ``decode.ms_per_step.stream`` leaves out the steps before the first
    chunk."""
    traces = clean_traces(rec)
    if traces is None:
        return None
    if "first_chunk_ms" not in rec:
        return named(traces, "decode.loop")
    loops = []
    for group in traces.values():
        post = next((s.start_ns for s in group if s.name == "decode.postnet"), None)
        if post is not None:
            loops += [s for s in group if s.name == "decode.loop" and s.start_ns > post]
    return loops


def ms_per_step(loops, ns_of) -> float | None:
    """Σ ``ns_of(loop)`` over Σ steps, in ms; None without a step."""
    if not loops:
        return None
    steps = sum(s.attrs["steps"] for s in loops)
    return sum(ns_of(s) for s in loops) / steps / 1e6 if steps else None


def train_steps(traces: dict) -> list[list]:
    """The clean optimizer steps, each as its trace's spans (``train.step``
    first)."""
    return [group for group in traces.values() if group[0].name == "train.step"]
