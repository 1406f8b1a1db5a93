"""The port's spans (``utils/trace.py``) on the CPU: nesting and trace ids
across threads, the bounded ring, ``record_function`` ranges only under a
running profiler, and the spans each layer records: the batcher, the
decode loops' step counts, the train step and the loader's waits."""

import dataclasses
import json
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from transformertts_tpu_torch.config import tiny_config
from transformertts_tpu_torch.data.prefetch import prefetch
from transformertts_tpu_torch.infer import DynamicBatcher, Synthesizer, make_decode_fn
from transformertts_tpu_torch.infer.serving import make_http_server
from transformertts_tpu_torch.infer.streaming import make_stream_fns, stream_chunks
from transformertts_tpu_torch.models import TransformerTTS
from transformertts_tpu_torch.models.factory import runtime_model_kwargs
from transformertts_tpu_torch.train.train_step import create_train_state, make_train_step
from transformertts_tpu_torch.utils import trace

TEXTS = ["Hello world.", "A second, longer sentence, with a comma.", "It is 1984."]
TIMEOUT = 120


def _cfg(**runtime):
    cfg = tiny_config()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, d_model=64, encoder_n_layers=1,
                                  decoder_n_layers=1, encoder_d_ffn=128, decoder_d_ffn=128,
                                  postnet_n_layers=2),
        runtime=dataclasses.replace(cfg.runtime, stop_threshold=2.0, **runtime),
    ).validate()


def _model(cfg):
    torch.manual_seed(0)
    return TransformerTTS(cfg.model, **runtime_model_kwargs(cfg, device="cpu"))


def _since(t0: int, name: str | None = None) -> list:
    """The ring's spans that began at or after ``t0``, by start."""
    out = [s for s in trace.spans() if s.start_ns >= t0 and (name is None or s.name == name)]
    return sorted(out, key=lambda s: s.start_ns)


@pytest.fixture(scope="module")
def synth():
    cfg = _cfg()
    return Synthesizer(cfg, state_dict=_model(cfg).state_dict(),
                       stats={"mean": -4.0, "std": 2.5}, device="cpu")


def test_spans_nest_with_their_parents_and_traces():
    with trace.span("t.outer", rows=2) as outer:
        with trace.span("t.inner") as inner:
            inner.attrs["steps"] = 3
        with trace.scope() as tid:
            with trace.span("t.joined") as joined:
                pass
    with trace.span("t.next") as nxt:
        pass
    with trace.span("t.given", trace_id=tid) as given:
        pass
    assert outer.parent is None and inner.parent == outer.id and joined.parent == outer.id
    assert inner.trace == joined.trace == outer.trace == tid == given.trace
    assert nxt.trace != outer.trace and nxt.parent is None
    assert outer.attrs == {"rows": 2} and inner.attrs == {"steps": 3}
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= joined.start_ns <= outer.end_ns
    ring = trace.spans()
    assert ring.index(inner) < ring.index(joined) < ring.index(outer)  # by their end
    # a span opened in another thread does not nest under this thread's open span
    got = []
    with trace.span("t.here") as here:
        t = threading.Thread(target=lambda: got.append(trace.span("t.there").__enter__()))
        t.start()
        t.join(timeout=TIMEOUT)
    assert not t.is_alive() and got[0].parent is None and got[0].trace != here.trace


def test_a_trace_crosses_threads():
    """A trace id made in one thread (a request at ``submit``) joins the spans
    another thread records, opened in a scope or recorded after the fact."""
    tid = trace.new_id()
    t0 = time.perf_counter_ns()

    def worker():
        with trace.scope(tid):
            with trace.span("t.worker") as s:
                pass
        return s, trace.record("t.waited", t0, time.perf_counter_ns(), trace_id=tid, rows=1)

    with ThreadPoolExecutor(1) as pool:
        s, rec = pool.submit(worker).result(timeout=TIMEOUT)
    assert s.trace == rec.trace == tid and rec.parent is None
    assert rec.start_ns == t0 <= rec.end_ns and rec.attrs == {"rows": 1}
    assert rec in trace.spans()


def test_the_ring_stays_bounded():
    t0 = time.perf_counter_ns()
    for i in range(trace.MAX_SPANS + 10):
        trace.record("t.flood", t0, t0 + i)
    ring = trace.spans()
    assert len(ring) == trace.MAX_SPANS
    assert ring[-1].ns == trace.MAX_SPANS + 9 and ring[0].name == "t.flood"


def test_ranges_only_under_a_running_profiler(monkeypatch, synth):
    from torch.profiler import ProfilerActivity, profile

    def refuse(*a, **k):
        raise AssertionError("a range opened without a profiler")

    with monkeypatch.context() as m:  # without a profiler none is opened
        m.setattr(trace, "_Range", refuse)
        m.setattr(torch.profiler, "record_function", refuse)
        with trace.span("t.off") as off:
            synth.synthesize(TEXTS[0], max_len=4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("t.on") as on:
            synth.synthesize(TEXTS[0], max_len=6)
    with trace.span("t.after") as after:
        pass
    assert on.profiled and not off.profiled and not after.profiled
    names = [e.name for e in prof.events()]
    assert "t.on" in names and "t.off" not in names and "t.after" not in names
    for name in ("synth.g2p", "decode.init", "decode.encode", "decode.cross_kv", "decode.plan",
                 "decode.loop", "decode.postnet", "synth.deliver"):
        assert names.count(name) == 1, name
    assert names.count("decode.step") == 6  # one range a step, under the profiler only
    # operator-kind ranges, not record_function's user scope (whose device-side
    # annotation would read as device work)
    assert {e.scope for e in prof.events() if e.name == "t.on"} == {0}
    assert all(s.profiled for s in _since(on.start_ns) if s.start_ns < on.end_ns)


def test_batcher_records_each_request_and_batch(synth):
    t0 = time.perf_counter_ns()
    with DynamicBatcher(synth, max_batch=4, max_wait_ms=100.0, max_len=6) as batcher:
        submitted = []
        with ThreadPoolExecutor(6) as pool:
            def one(i):
                a = time.perf_counter_ns()
                fut = batcher.submit(TEXTS[i % 3])
                submitted.append((a, time.perf_counter_ns()))
                return fut.result(timeout=TIMEOUT)
            mels = list(pool.map(one, range(6)))
        stats = batcher.stats()
        server = make_http_server(batcher)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            url = f"http://127.0.0.1:{server.server_address[1]}/healthz"
            with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
                health = json.loads(r.read())
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=TIMEOUT)
    assert not thread.is_alive() and len(mels) == 6
    queued, batches = _since(t0, "batcher.queued"), _since(t0, "batcher.batch")
    fills = _since(t0, "batcher.fill")
    assert len(queued) == stats["n_requests"] == 6
    assert len(batches) == len(fills) == stats["n_batches"]
    assert sorted(b.attrs["rows"] for b in batches) == sorted(
        n for n, c in stats["batch_hist"].items() for _ in range(c))
    # a request's id, made in the submitting thread, is its queued span's and
    # its batch's; the queued span starts inside submit
    assert sorted(r for b in batches for r in b.attrs["requests"]) == sorted(
        q.trace for q in queued)
    assert all(any(a <= q.start_ns <= b for a, b in submitted) for q in queued)
    for b in batches:
        fill = next(f for f in fills if f.trace == b.trace)
        assert fill.end_ns <= b.start_ns
        assert all(b.start_ns <= q.end_ns <= b.end_ns
                   for q in queued if q.trace in b.attrs["requests"])
        kids = [s.name for s in _since(t0) if s.trace == b.trace and s.parent == b.id]
        assert kids == ["synth.g2p", "decode.init", "decode.loop", "decode.postnet",
                        "synth.deliver"]
    assert len(_since(t0, "batcher.wait")) >= len(batches)
    summary = health["trace"]
    assert health["n_requests"] == 6 and summary["batcher.batch"]["count"] >= len(batches)
    assert 0 <= summary["batcher.queued"]["p50_ms"] <= summary["batcher.queued"]["p95_ms"]


def _decode_steps(kind, use_kernel):
    """(n_steps the decode reports, its spans) of one decode of ``kind``."""
    if kind == "speculative":
        cfg = _cfg(decode_speculative_k=4, decode_speculative_tau=0.15)
    else:  # the kernel loop decodes the one-shot batch of 3 as chunks of 2 and 1 rows
        cfg = _cfg(decode_megakernel_max_batch=2)
    model = _model(cfg)
    rng = np.random.default_rng(0)
    b = 1 if kind != "oneshot" else 3
    phoneme = rng.integers(1, 60, (b, 16)).astype(np.int32)
    lens = np.array([16, 9, 12][:b], np.int32)
    t0 = time.perf_counter_ns()
    if kind == "stream":
        fns = make_stream_fns(model, cfg, max_len=24, chunk=8, use_kernel=use_kernel,
                              device="cpu")
        with trace.scope():  # the stream's calls under one trace, as Synthesizer.stream runs them
            n_steps = sum(steps for *_, steps in stream_chunks(fns, cfg, fns[0](phoneme, lens),
                                                                24))
    else:
        fn = make_decode_fn(model, cfg, max_len=24, use_kernel=use_kernel, device="cpu")
        n_steps = fn(phoneme, lens)["n_steps"]
    return n_steps, _since(t0)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("kind", ["oneshot", "stream", "speculative"])
def test_decode_loop_steps_add_up_to_n_steps(kind, use_kernel):
    n_steps, got = _decode_steps(kind, use_kernel)
    loops = [s for s in got if s.name == "decode.loop"]
    assert n_steps > 0 and sum(s.attrs["steps"] for s in loops) == n_steps
    assert all(0 <= s.attrs["readback_ns"] <= s.ns for s in loops)
    assert len(loops) == (3 if kind == "stream" else 1)  # 24 frames in chunks of 8
    init = next(s for s in got if s.name == "decode.init")
    kids = [s for s in got if s.parent == init.id]
    rows = [2, 1] if kind == "oneshot" and use_kernel else [3 if kind == "oneshot" else 1]
    assert [s.name for s in kids] == ["decode.encode", "decode.cross_kv"] + ["decode.plan"] * len(
        rows)
    assert [s.attrs["rows"] for s in kids[2:]] == rows
    assert {s.trace for s in got} == {init.trace}  # one decode, one trace
    assert len([s for s in got if s.name == "decode.postnet"]) == (3 if kind == "stream" else 1)


def test_synthesizer_stream_keeps_one_trace_across_chunks(synth):
    t0 = time.perf_counter_ns()
    chunks = list(synth.stream(TEXTS[1], chunk=8, max_len=24))
    got = _since(t0)
    assert len(chunks) == 3 and len({s.trace for s in got}) == 1
    names = [s.name for s in got]
    assert names[:2] == ["synth.g2p", "decode.init"] and names.count("decode.loop") == 3
    assert names.count("synth.deliver") == 3 * 3  # each chunk: two copies and the caller's mel


@pytest.mark.parametrize("scheduled_sampling", [True, False], ids=["ss", "tf"])
def test_train_step_records_its_phases(scheduled_sampling):
    cfg = _cfg()
    cfg = cfg.replace(training=dataclasses.replace(cfg.training, warmup_steps=10)).validate()
    model = _model(cfg)
    state = create_train_state(model, cfg)
    step_fn = make_train_step(model, cfg, scheduled_sampling=scheduled_sampling)
    rng = np.random.default_rng(0)
    k, b, tp, tm = 2, 2, 12, 24
    batch = {"phoneme": rng.integers(1, 60, (k, b, tp)).astype(np.int32),
             "melspec": rng.standard_normal((k, b, tm, 80)).astype(np.float32),
             "phoneme_lens": np.full((k, b), tp, np.int32),
             "melspec_lens": np.full((k, b), tm, np.int32)}
    t0 = time.perf_counter_ns()
    step_fn(state, batch, 0.5, torch.Generator().manual_seed(0))
    got = _since(t0)
    step = next(s for s in got if s.name == "train.step")
    assert step.attrs == {"micro": k, "frames": k * b * tm} and step.parent is None
    kids = [s.name for s in got if s.parent == step.id]
    assert kids == ["train.micro"] * k + ["train.grads", "train.readback", "train.optimizer"]
    micro = ["train.forward_free"] if scheduled_sampling else []
    for m in (s for s in got if s.name == "train.micro"):
        assert [s.name for s in got if s.parent == m.id] == micro + ["train.forward",
                                                                     "train.backward"]
    assert {s.trace for s in got} == {step.trace}


def test_prefetch_records_each_wait():
    waits = []
    t0 = time.perf_counter_ns()
    assert list(prefetch(iter(range(3)), waits=waits)) == [0, 1, 2]
    got = _since(t0, "data.wait")
    assert len(waits) == 4 and got == waits  # three items and the end
    assert len({s.trace for s in waits}) == 4 and all(s.parent is None for s in waits)
