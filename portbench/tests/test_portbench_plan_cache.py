"""The decode step prepared once per shape (``DecodeWeights`` in
``transformertts_tpu_torch/infer/decode.py``) and ``decode.plan_hit_share``,
which reads it.

On the CPU: the reader's share over the spans that carry ``hit``, and None
from a program whose spans carry none.  On the chip (``-m card``): the
same batch decoded cold (every cache emptied) and warm gives the same
frames, stop logits and lengths, bit for bit, and after
``Synthesizer.warmup`` as the serving cells call it, a full-length batch
finds its shape prepared."""

import time
import types

import pytest
import torch

from portbench import harness, spans

READER = "decode.plan_hit_share.serve"


def _span(name, **attrs):
    return types.SimpleNamespace(name=name, attrs=attrs)


@pytest.mark.parametrize("hits,share", [([True, True, False, True], 75.0), ([True], 100.0),
                                        ([False, False], 0.0), ([], None)])
def test_hit_share_counts_the_spans_with_hit(monkeypatch, hits, share):
    traces = {1: [_span("decode.init"), *(_span("decode.plan", rows=2, hit=h) for h in hits)],
              2: [_span("decode.plan", rows=1), _span("decode.loop", steps=3)]}
    monkeypatch.setattr(spans, "clean_traces", lambda rec: traces)
    assert harness.reader(READER).read({"setup_s": 1.0}) == share


def test_hit_share_is_none_without_the_tracer(monkeypatch):
    monkeypatch.setattr(spans, "clean_traces", lambda rec: None)
    for cell in ("serve", "stream", "backlog"):
        assert harness.reader(f"decode.plan_hit_share.{cell}").read({"setup_s": 1.0}) is None


def _forget_plans():
    from transformertts_tpu_torch.ops import decode_step as ds

    ds._plan_of.cache_clear()
    ds._card_plan_of.cache_clear()
    ds.self_chunks.cache_clear()


def _cfg(name: str, frames: int = 576):
    return harness.program_config(harness.config_spec(name), {"infer_max_len": frames,
                                                              "stop_threshold": 2.0})


@pytest.mark.card
@pytest.mark.parametrize("name,b", [("ljspeech", 6), ("paper", 8)])
def test_cold_and_warm_decodes_are_bit_identical(cuda_device, name, b):
    from transformertts_tpu_torch.infer.decode import DecodeWeights, make_decode_fn
    from transformertts_tpu_torch.models import TransformerTTS
    from transformertts_tpu_torch.utils import trace

    cfg = _cfg(name)
    torch.manual_seed(b)
    model = TransformerTTS(cfg.model, dtype=torch.bfloat16, device=cuda_device)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn_like(p))
    gen = torch.Generator().manual_seed(7)
    phoneme = torch.randint(1, 60, (b, 128), generator=gen)
    lens = torch.randint(40, 129, (b,), generator=gen)
    outs = []
    for cold in (True, False):
        if cold:
            _forget_plans()
            weights = DecodeWeights(model)
            fn = make_decode_fn(model, cfg, device=cuda_device, weights=weights)
        t0 = time.perf_counter_ns()
        outs.append(fn(phoneme, lens))
        hits = [s.attrs["hit"] for s in trace.spans()
                if s.name == "decode.plan" and s.start_ns >= t0]
        assert hits == [not cold] * len(hits) and hits
    for k in ("pred_melspec", "pred_stop", "n_frames_per_row"):
        assert torch.equal(outs[0][k], outs[1][k]), k
    assert outs[0]["n_steps"] == outs[1]["n_steps"]


@pytest.mark.card
def test_full_length_batches_hit_after_warmup(cuda_device):
    from transformertts_tpu_torch.infer.api import Synthesizer
    from transformertts_tpu_torch.models import TransformerTTS
    from transformertts_tpu_torch.utils import trace

    cfg = _cfg("ljspeech")
    model = TransformerTTS(cfg.model, dtype=torch.bfloat16, device=cuda_device)
    _forget_plans()
    synth = Synthesizer(cfg, state_dict=model.state_dict(), device=cuda_device)
    synth.warmup(batch_sizes=tuple(range(1, 9)), buckets=tuple(cfg.runtime.phoneme_buckets),
                 max_len=64)
    for b in (3, 8, 1):
        t0 = time.perf_counter_ns()
        synth.synthesize(["A sentence of a few words to read."] * b, max_len=576)
        hits = [s.attrs["hit"] for s in trace.spans()
                if s.name == "decode.plan" and s.start_ns >= t0]
        assert hits == [True], (b, hits)
