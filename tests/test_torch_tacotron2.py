"""Tacotron 2 on the port (``models/tacotron2.py``, the Tacotron 2 rows of
``infer/decode.py``, ``ops/tacotron2_step.py``) against the benchmark's plain
float32 reference (``portbench/reference/tacotron2.py``), on seeded random
weights (``portbench/reference/tacotron2_weights.py``) at NVIDIA's widths
divided by 8 (embedding and encoder 64, LSTM cells 128, prenet 32,
attention 16 with 4 location filters of k 31, postnet 64), Tp <= 24 and
<= 40 steps, on the CPU.

Tolerance (fp32): max |port - reference| <= 1e-5 x max(1, max |reference|).
The port and the reference compute the same sums in another order (the
kernel's plain version also folds the location dense layer into the
convolution), and the recurrent state carries each step's rounding into
the next: the gaps measured here are 2e-8 to 3.3e-7.  With stop votes
forced at every offset of the lag window (``tests/decode_votes.py``), both
Tacotron 2 loops read them ``LAG`` steps late and equal, bit for bit, the
loops that read them after every step.

The tests marked ``card`` run on the GPU (``python -m pytest
tests/test_torch_tacotron2.py -m card``) at the published widths: the
kernel loop against the plain loop, in bf16, B 1 and 8, Tp 192, 576
steps; and the same batch decoded cold and warm.
"""

import copy
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import masks
from portbench.reference.tacotron2 import PlainT2, prenet_seed
from portbench.reference.tacotron2_weights import make_weights
from tests import decode_votes
from transformertts_tpu_torch.config import config_from_dict, load_config
from transformertts_tpu_torch.infer import decode
from transformertts_tpu_torch.infer.api import Synthesizer
from transformertts_tpu_torch.infer.decode import make_decode_fn
from transformertts_tpu_torch.models.tacotron2 import Tacotron2
from transformertts_tpu_torch.ops.decode_step import prenet_keep

TOL = 1e-5
SMALL = dict(symbols_embedding_dim=64, encoder_embedding_dim=64, attention_rnn_dim=128,
             decoder_rnn_dim=128, prenet_dim=32, attention_dim=16, attention_location_n_filters=4,
             postnet_embedding_dim=64)
STEPS = 40
ROOT = Path(__file__).resolve().parents[1]


def conf(**runtime):
    c = copy.deepcopy(harness.config_spec("tacotron2"))
    c["model"].update(SMALL)
    c["runtime"].update(compute_dtype="float32", stop_threshold=2.0, phoneme_buckets=[24],
                        infer_max_len=STEPS, **runtime)
    return c


def model_of(c, seed=11):
    cfg = harness.program_config(c)
    model = Tacotron2(cfg.model, dtype=torch.float32, device="cpu")
    w = make_weights(c["model"], seed, "cpu")
    model.load_state_dict(w, strict=True)
    return cfg, model, w


def batch():
    rng = np.random.default_rng(5)
    lens = np.array([24, 13, 19])
    ids = np.where(np.arange(24)[None] < lens[:, None], rng.integers(4, 84, (3, 24)), 0)
    return torch.as_tensor(ids), torch.as_tensor(lens)


def close(a, ref):
    gap = float((a.float() - ref.float()).abs().max() / ref.float().abs().max().clamp(min=1.0))
    assert gap <= TOL, gap


def reference(c, w, ids, lens, frames, rows):
    ref = PlainT2(c["model"], w)
    memories = [ref.encode(ids[i, : lens[i]]) for i in range(len(lens))]
    mel, gate = ref.decode(memories, frames, rows, prenet_seed(c["training"]["seed"]),
                           c["runtime"].get("infer_prenet_dropout", 0.0))
    return mel, gate, ref.postnet(frames)


@torch.no_grad()
@pytest.mark.parametrize("case", ["forward", "batch", "rows_alone", "kernel_loop", "stream"])
def test_tacotron2_against_reference(case):
    c = conf(infer_prenet_dropout=0.0 if case == "rows_alone" else 0.5)
    cfg, model, w = model_of(c)
    ids, lens = batch()
    rate, seed = cfg.runtime.infer_prenet_dropout, prenet_seed(c["training"]["seed"])
    if case == "forward":  # teacher-forced on random frames, the prenet's masks of rows 0-2
        frames = torch.randn(3, STEPS, 80, generator=torch.Generator().manual_seed(2))
        scale = 1.0 / (1.0 - rate)
        def keep(t):
            return [prenet_keep(t, i, 3, 32, rate, seed) for i in (0, 1)], scale

        out = model(ids, frames, lens, prenet_keep=keep)
        mel, gate, _ = reference(c, w, ids, lens, frames, [0, 1, 2])
        close(out["pred_melspec"], mel)
        close(out["pred_stop"], gate)
        close(out["post_melspec"], PlainT2(c["model"], w).postnet(mel))
        return
    plain = make_decode_fn(model, cfg, use_kernel=False, device="cpu")(ids, lens)
    if case == "batch":  # the greedy decode of a padded batch, read as the benchmark reads it
        mel, gate, post = reference(c, w, ids, lens, plain["pred_melspec"], [0, 1, 2])
        close(plain["pred_melspec"], mel)
        close(plain["pred_stop"], gate)
        close(plain["post_melspec"], post)
    elif case == "rows_alone":  # no masks: each row of the padded batch decodes as alone
        for i in range(3):
            one = make_decode_fn(model, cfg, use_kernel=False, device="cpu")(
                ids[i: i + 1, : lens[i]], lens[i: i + 1])
            close(plain["pred_melspec"][i], one["pred_melspec"][0])
            close(plain["pred_stop"][i], one["pred_stop"][0])
    elif case == "kernel_loop":  # the kernel's plain version, op for op, in the kernel loop
        kern = make_decode_fn(model, cfg, use_kernel=True, device="cpu")(ids, lens)
        assert kern["n_steps"] == plain["n_steps"] == STEPS
        for k in ("pred_melspec", "pred_stop", "post_melspec"):
            close(kern[k], plain[k])
    else:  # Synthesizer.stream's chunks against its one-shot decode of the same text
        synth = Synthesizer(cfg, state_dict=w, stats={"mean": -5.0, "std": 2.0}, device="cpu")
        text = "A short sentence for the stream."
        one = synth.synthesize(text)[0]
        chunks = list(synth.stream(text, chunk=20))
        assert [ch.shape[1] for ch in chunks] == [20, 20]
        close(torch.as_tensor(np.concatenate(chunks, axis=1)), torch.as_tensor(one))


@pytest.mark.parametrize("t, layer, rows, d, rate, seed, row0", [
    (0, 0, 1, 256, 0.5, 1234 ^ 0x5EED, 0), (575, 1, 8, 256, 0.5, 42 ^ 0x5EED, 0),
    (17, 1, 3, 32, 0.1, 2**31 + 5, 5), (999, 0, 8, 256, 0.9, 0, 0)])
def test_reference_mask_hash_is_prenet_keep(t, layer, rows, d, rate, seed, row0):
    r = torch.arange(row0, row0 + rows, dtype=torch.int64)[:, None]
    col = torch.arange(d, dtype=torch.int64)[None, :]
    ref = masks.keep_from_index(r * d + col, 2 * t + layer, seed, rate)
    assert torch.equal(ref, prenet_keep(t, layer, rows, d, rate, seed, row0))


@pytest.mark.parametrize("name", ["portbench:tacotron2", "portbench:ljspeech", "portbench:paper"]
                         + sorted(p.name for p in (ROOT / "configs").glob("*.yaml")))
def test_config_files_read(name):
    if name.startswith("portbench:"):
        raw = harness.config_spec(name.split(":")[1])
        cfg = config_from_dict({k: raw[k] for k in ("model", "audio", "training", "loss",
                                                    "runtime")})
    else:
        import yaml

        raw = yaml.safe_load((ROOT / "configs" / name).read_text())
        cfg = load_config(ROOT / "configs" / name)
    for key, value in raw["model"].items():
        assert getattr(cfg.model, key) == (tuple(value) if isinstance(value, list) else value)
    arch = "tacotron2" if name == "portbench:tacotron2" else "transformer_tts"
    assert cfg.model.architecture == arch
    if arch == "tacotron2":
        assert (cfg.model.encoder_embedding_dim, cfg.model.decoder_rnn_dim,
                cfg.model.attention_location_kernel_size) == (512, 1024, 31)
        for bad in ({"reduction_factor": 2}, {"architecture": "wavenet"}):
            with pytest.raises(ValueError):
                dataclasses.replace(cfg.model, **bad).validate()


@pytest.mark.parametrize("path", ["speculative", "window", "train_step", "trainer", "variables"])
def test_tacotron2_refuses_what_it_lacks(path, tmp_path):
    runtime = {"speculative": {"decode_speculative_k": 4},
               "window": {"decode_attn_window": 3}}.get(path, {})
    c = conf(**runtime)
    cfg, model, w = model_of(c)
    with pytest.raises(ValueError, match="tacotron2"):
        if path in ("speculative", "window"):
            make_decode_fn(model, cfg, use_kernel=False, device="cpu")
        elif path == "train_step":
            from transformertts_tpu_torch.train.train_step import make_train_step

            make_train_step(model, cfg)
        elif path == "trainer":
            from transformertts_tpu_torch.train.trainer import Trainer

            Trainer(cfg, tmp_path, device="cpu")
        else:
            Synthesizer(cfg, variables={"params": {}}, device="cpu")


@torch.no_grad()
@pytest.mark.parametrize("last", decode_votes.last_votes() + [STEPS - 1])
@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_tacotron2_late_stop_readback_equals_per_step_readback(monkeypatch, use_kernel, last):
    """The Tacotron 2 rows (``T2PlainRows``, and ``T2KernelRows`` on the
    kernel's plain version) with the last of 3 rows voting at each offset of
    the lag window or at the last step: read ``LAG`` steps late, the result
    equals the one read after every step bit for bit, and the steps run past
    the stop are rolled back and counted."""
    c = conf(infer_prenet_dropout=0.5)
    cfg, model, _ = model_of(c)
    ids, lens = batch()
    votes = decode_votes.vote_steps(3, last)
    fn = make_decode_fn(model, cfg, stop_threshold=decode_votes.THRESHOLD, use_kernel=use_kernel,
                        device="cpu")
    runs = {lag: decode_votes.decode_with_votes(monkeypatch, lag, votes, lambda: fn(ids, lens))
            for lag in (1, decode.LAG)}
    decode_votes.assert_same(runs[1][0], runs[decode.LAG][0])
    for lag, (out, loops, calls) in runs.items():
        ran, waits = decode_votes.lag_counts(STEPS, last, lag)
        assert out["n_steps"] == out["n_frames"] == last + 1
        decode_votes.assert_rolled_back(out, slice(0, 3), last + 1, 1)
        assert calls == ran and loops[0].attrs["overrun"] == ran - last - 1
        assert loops[0].attrs["waits"] == waits


# ------------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the chip (-m card)")
    return torch.device("cuda", 0)


def card_model(dev, seed=2**31 + 3):
    c = harness.config_spec("tacotron2")
    cfg = harness.program_config(c, {"infer_max_len": 576, "stop_threshold": 2.0})
    model = Tacotron2(cfg.model, dtype=torch.bfloat16, device=dev)
    model.load_state_dict(make_weights(c["model"], seed, dev), strict=True)
    gen = torch.Generator().manual_seed(seed)
    return cfg, model, gen


@pytest.mark.card
@torch.no_grad()
@pytest.mark.parametrize("b", [1, 8])
def test_card_kernel_loop_against_plain_loop(b, cuda):
    """576 forced steps at Tp 192 (prenet dropout 0.5), bf16: frames within
    0.01 and stop logits within 0.005 of the plain loop's (relative to
    max(1, max |plain|); measured 1.5e-3 and 7e-4: the kernel sums in
    another order, over bf16 operands, and the recurrence carries it)."""
    cfg, model, gen = card_model(cuda)
    lens = torch.randint(96, 193, (b,), generator=gen)
    lens[0] = 192
    ids = torch.where(torch.arange(192)[None] < lens[:, None],
                      torch.randint(4, 84, (b, 192), generator=gen), 0)
    kern = make_decode_fn(model, cfg, device=cuda)(ids, lens)
    plain = make_decode_fn(model, cfg, use_kernel=False, device=cuda)(ids, lens)
    assert kern["n_steps"] == plain["n_steps"] == 576
    for k, tol in (("pred_melspec", 0.01), ("pred_stop", 0.005), ("post_melspec", 0.05)):
        ref = plain[k].float()
        gap = float((kern[k].float() - ref).abs().max() / ref.abs().max().clamp(min=1.0))
        assert gap <= tol, (k, gap)


@pytest.mark.card
@torch.no_grad()
def test_card_cold_and_warm_decodes_are_bit_equal(cuda):
    from transformertts_tpu_torch.utils import trace

    cfg, model, gen = card_model(cuda)
    synth = Synthesizer(cfg, state_dict=model.state_dict(), stats={"mean": -5.0, "std": 2.0},
                        device=cuda)
    texts = ["A sentence of a few words.", "Another one, a little longer than that."] * 4
    cold = synth.synthesize(texts, max_len=576)
    synth.warmup(batch_sizes=(8,), buckets=tuple(cfg.runtime.phoneme_buckets), max_len=16)
    mark = len(trace.spans())
    warm = synth.synthesize(texts, max_len=576)
    hits = [s.attrs.get("hit") for s in trace.spans()[mark:] if s.name == "decode.plan"]
    assert hits == [True]
    assert all(np.array_equal(a, b) for a, b in zip(cold, warm))
