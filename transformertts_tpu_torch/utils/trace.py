"""Spans and counters inside the port, kept in memory, on the profiler's
clock when one runs.

A span is one stretch of host work at a layer's boundary: a name
``<layer>.<part>``, a start and an end in ``time.perf_counter_ns()``, the
span it ran inside (``parent``), a trace id shared by every span of one
request, batch or optimizer step (``trace``), whether a ``torch.profiler``
was running when it began (``profiled``), and a few attributes (``attrs``:
rows, steps, readback_ns, ...).  Every span goes into one ring of
``MAX_SPANS`` in this process (``spans()`` copies it); nothing is written
to disk.

Tracing is always on, with no switch: a span costs two clock reads, one
small object and one read of the profiler's flag, a few microseconds.
Under a running profiler a span also opens a host range of its name, so it
sits on the profiler's host timeline beside the CUDA events and names the
device's idle gaps; without a profiler no range is opened.  The range is
the profiler's own operator kind (``torch._C._profiler._RecordFunctionFast``,
scope ``FUNCTION``), not ``torch.profiler.record_function``: for a
``record_function`` range (scope ``USER_SCOPE``) the profiler also draws an
annotation over the device work launched inside it, on the device's
timeline, so that a device trace would read the device busy through every
span; and one costs ~13 us even with no profiler running.

Host spans around asynchronous CUDA work measure the time the host takes to
dispatch that work, not the device's time, which stays with the device
trace.  A span that ends in a readback (``.cpu()``, ``.tolist()``,
``bool(t)``) also holds the host's wait for the device's queue; the decode
loop counts that wait apart (``readback_ns``).

The spans of the port (the layer's module in brackets):

- ``batcher.queued`` (``infer/serving.py``): a request from ``submit`` to
  the start of its batch's ``synthesize``, recorded by the worker under the
  request's own trace id; ``batcher.wait``: the worker blocked on an empty
  queue; ``batcher.fill``: from taking a batch's first request to closing
  it; ``batcher.batch``: ``synthesize`` through delivery (``rows``,
  ``requests``: the requests' trace ids).  ``fill`` and ``batch`` share the
  batch's trace id.
- ``synth.g2p``, ``synth.deliver`` (``infer/api.py``, and each chunk's copy
  in ``infer/streaming.py``): text to padded ids; copies to the host,
  per-row slicing and denormalization.
- ``decode.init`` with ``decode.encode``, ``decode.cross_kv`` and one
  ``decode.plan`` per chunk of rows (``rows``); ``decode.loop`` (``steps``,
  ``readback_ns``: the time spent reading the stop vote back, summed over
  the loop's steps); ``decode.postnet`` (``infer/decode.py``,
  ``infer/streaming.py``).  Under a running profiler each decode step is a
  ``decode.step`` range on the profiler's timeline and nothing more.
- ``train.step`` (``micro``, ``frames``: padded mel frames) with
  ``train.micro`` (``train.forward_free``, ``train.forward``,
  ``train.backward``), ``train.grads``, ``train.readback`` and
  ``train.optimizer`` (``train/train_step.py``).
- ``data.wait`` (``data/prefetch.py``): the consumer blocked on the
  prefetch queue.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch

MAX_SPANS = 65_536
# one reading of the wall clock and of the spans' clock, to carry a
# time.time() instant onto the spans' clock
CLOCK = (time.time(), time.perf_counter_ns())

_ring: collections.deque = collections.deque(maxlen=MAX_SPANS)
_ids = itertools.count(1)
_local = threading.local()
_profiler_on = torch._C._autograd._profiler_enabled
_Range = torch._C._profiler._RecordFunctionFast  # a host range under a running profiler


class Span:
    """One recorded span; ``ns`` is its length."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "trace", "profiled", "attrs")

    def __init__(self, name, trace: int, parent, attrs: dict):
        self.name, self.trace, self.parent, self.attrs = name, trace, parent, attrs
        self.id = next(_ids)
        self.start_ns = self.end_ns = 0
        self.profiled = False

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.ns / 1e6:.3f} ms, trace={self.trace}, "
                f"parent={self.parent}, profiled={self.profiled}, {self.attrs})")


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


def new_id() -> int:
    """A fresh id, for a trace that begins before its first span (a request
    at ``submit``)."""
    return next(_ids)


def profiling() -> bool:
    """Whether a ``torch.profiler`` is running."""
    return _profiler_on()


class span:
    """``with span(name, trace_id=None, **attrs) as s:`` records a span
    around the block; attributes may be added to ``s.attrs`` inside it.  Its
    parent is the innermost span open in this thread; its trace id is
    ``trace_id``, else the parent's (or the ``scope``'s), else a new one."""

    __slots__ = ("name", "trace_id", "attrs", "s", "rf")

    def __init__(self, name: str, trace_id: int | None = None, **attrs):
        self.name, self.trace_id, self.attrs, self.rf = name, trace_id, attrs, None

    def __enter__(self) -> Span:
        stack = _stack()
        top = stack[-1] if stack else None
        s = self.s = Span(self.name, self.trace_id or (top.trace if top else next(_ids)),
                          top.id if top else None, self.attrs)
        if _profiler_on():
            s.profiled = True
            self.rf = _Range(self.name)
            self.rf.__enter__()
        stack.append(s)
        s.start_ns = time.perf_counter_ns()
        return s

    def __exit__(self, *exc) -> None:
        s = self.s
        s.end_ns = time.perf_counter_ns()
        _stack().pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _ring.append(s)


class scope:
    """``with scope(trace_id=None) as tid:`` joins the spans opened in the
    block to trace ``tid`` (``trace_id``, else the open span's, else a new
    one) without a span of its own: a generator resumed once per chunk keeps
    one trace across its resumptions."""

    __slots__ = ("trace_id",)

    def __init__(self, trace_id: int | None = None):
        self.trace_id = trace_id

    def __enter__(self) -> int:
        stack = _stack()
        top = stack[-1] if stack else None
        tid = self.trace_id or (top.trace if top else next(_ids))
        join = Span.__new__(Span)  # not recorded: carries the trace and the open span's id
        join.trace, join.id = tid, top.id if top else None
        stack.append(join)
        return tid

    def __exit__(self, *exc) -> None:
        _stack().pop()


def record(name: str, start_ns: int, end_ns: int, trace_id: int | None = None,
           **attrs) -> Span:
    """Records a span that began earlier, perhaps in another thread (a
    request's wait in the queue), with no parent."""
    s = Span(name, trace_id or next(_ids), None, attrs)
    s.start_ns, s.end_ns, s.profiled = start_ns, end_ns, _profiler_on()
    _ring.append(s)
    return s


def step_range(name: str):
    """A host range for one step of a loop, to enter only when
    ``profiling()``: the loop's steps are no spans of their own."""
    return _Range(name)


def spans() -> list[Span]:
    """The ring's spans, oldest first by their end."""
    return list(_ring.copy())


def _pct(sorted_ns: list[int], q: float) -> float:
    pos = (len(sorted_ns) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(sorted_ns) - 1)
    return (sorted_ns[lo] + (sorted_ns[hi] - sorted_ns[lo]) * (pos - lo)) / 1e6


def summary() -> dict:
    """Per span name over the ring: ``count``, ``p50_ms`` and ``p95_ms``."""
    by: dict[str, list[int]] = {}
    for s in spans():
        by.setdefault(s.name, []).append(s.ns)
    out = {}
    for name in sorted(by):
        ns = sorted(by[name])
        out[name] = {"count": len(ns), "p50_ms": _pct(ns, 0.5), "p95_ms": _pct(ns, 0.95)}
    return out
