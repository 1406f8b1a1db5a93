"""The port's streaming decode vs the JAX package's, and vs its own one-shot
decode.

``stream_decode`` / ``make_stream_fns`` / ``Synthesizer.stream`` / ``cli
serve`` of the port on the CPU, against JAX ``stream_decode`` and
``Synthesizer.stream`` (the XLA loop on the CPU) on the same weights
(``convert.torch_state_from_jax``) and inputs: B = 2 with ragged lengths,
window W in {0, 2}, reduction factor r in {1, 2}, chunk 4, max_len 16, stop
threshold 2.0 (as JAX ``tests/test_streaming.py``).

Tolerances, as max|port - jax| <= tol * max(1, max|jax|): pre-postnet
frames 1e-4 (``tests/test_torch_decode.py``'s: each frame is fed back, so
per-step summation-order differences of 1e-6 grow over the steps); postnet
frames 1e-4 as well (the postnet adds 5 convolutions of those frames, as
the one-shot decode's ``post_melspec`` in the same file).  Within the port
the stream computes the one-shot decode's steps, so its frames are equal
bit for bit; the windowed postnet equals the full-buffer postnet within
1e-5 (other convolution shapes, other summation order).  With stop votes
forced across the chunks' boundaries (``tests/decode_votes.py``), the
stream that reads them ``LAG`` steps late equals, bit for bit, the one that
reads them after every step.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from tests import decode_votes
from tests.test_torch_models import assert_close, configs, jax_model_and_variables, port_model
from transformertts_tpu.infer.api import Synthesizer as JaxSynthesizer
from transformertts_tpu.infer.streaming import stream_decode as jax_stream_decode
from transformertts_tpu_torch import cli
from transformertts_tpu_torch.infer import Synthesizer
from transformertts_tpu_torch.infer import decode as decode_mod
from transformertts_tpu_torch.infer.decode import make_decode_fn
from transformertts_tpu_torch.infer.streaming import (
    make_stream_fns,
    postnet_overlap,
    stream_chunks,
    stream_decode,
)

TOL = 1e-4
MAX_LEN, CHUNK = 16, 4
STATS = {"mean": -5.0, "std": 2.0}


def _inputs(b, seed=0):
    rng = np.random.default_rng(seed)
    phoneme = rng.integers(1, 60, (b, 12)).astype(np.int32)
    lens = np.array(([12, 9] * b)[:b], np.int32)
    return phoneme, lens


def _cat(chunks):
    pre = np.concatenate([p for p, _ in chunks], axis=1)
    post = np.concatenate([q for _, q in chunks], axis=1)
    return pre, post


@functools.lru_cache(maxsize=None)
def _models(r=1, **runtime):
    jcfg, pcfg = configs(r, **runtime)
    jmodel, variables = jax_model_and_variables(jcfg)
    return jcfg, pcfg, jmodel, variables, port_model(pcfg, variables)


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("window", [0, 2])
def test_stream_matches_jax(window, r):
    jcfg, pcfg, jmodel, variables, model = _models(r, decode_attn_window=window)
    phoneme, lens = _inputs(2)
    ref = _cat(list(jax_stream_decode(jmodel, jcfg, variables, phoneme, lens, max_len=MAX_LEN,
                                      chunk=CHUNK, stop_threshold=2.0)))
    ours = _cat(list(stream_decode(model, pcfg, phoneme, lens, max_len=MAX_LEN, chunk=CHUNK,
                                   stop_threshold=2.0, device="cpu")))
    for what, a, b in zip(("pre-postnet", "postnet"), ours, ref):
        assert a.shape == b.shape == (2, MAX_LEN, 80), (what, a.shape, b.shape)
        assert_close(a, b, TOL, what)


@pytest.mark.parametrize("window", [0, 2])
def test_stream_equals_oneshot_and_windowed_postnet(window):
    """The stream's frames are the one-shot decode's, bit for bit; post_fn
    on clamped windows equals the full-buffer postnet on the same frames."""
    _, pcfg, _, _, model = _models(decode_attn_window=window)
    phoneme, lens = _inputs(2)
    one = make_decode_fn(model, pcfg, max_len=MAX_LEN, stop_threshold=2.0, device="cpu")(
        phoneme, lens)
    pre, post = _cat(list(stream_decode(model, pcfg, phoneme, lens, max_len=MAX_LEN,
                                        chunk=CHUNK, stop_threshold=2.0, device="cpu")))
    np.testing.assert_array_equal(pre, one["pred_melspec"].numpy())
    assert_close(post, one["post_melspec"], 1e-5, "stream postnet")
    _, _, post_fn = make_stream_fns(model, pcfg, max_len=MAX_LEN, chunk=CHUNK, device="cpu")
    frames = torch.cat([torch.zeros((2, 1, 80)), one["pred_melspec"]], dim=1)
    for start in range(0, MAX_LEN, CHUNK):
        assert_close(post_fn(frames, start), one["post_melspec"][:, start:start + CHUNK],
                     1e-5, f"post_fn at {start}")
    assert postnet_overlap(pcfg) == 10


def test_stream_early_stop_ends_the_generator():
    _, pcfg, _, variables, _ = _models()
    model = port_model(pcfg, variables)
    with torch.no_grad():
        model.stop_linear.Dense_0.bias.fill_(100.0)  # votes at the first frame
    chunks = list(stream_decode(model, pcfg, *_inputs(2), max_len=MAX_LEN, chunk=CHUNK,
                                device="cpu"))
    assert sum(p.shape[1] for p, _ in chunks) == 1


def test_stream_checks_chunk_divisibility():
    _, pcfg, _, _, model = _models()
    with pytest.raises(ValueError, match="multiple of chunk"):
        make_stream_fns(model, pcfg, max_len=10, chunk=4, device="cpu")
    _, pcfg2, _, _, model2 = _models(2)
    with pytest.raises(ValueError, match="multiple of reduction_factor"):
        make_stream_fns(model2, pcfg2, max_len=15, chunk=3, device="cpu")


@pytest.mark.parametrize("window", [0, 2])
def test_stream_kernel_loop_equals_plain_loop(window):
    """``use_kernel=True``: every step through the decode-step wrapper (its
    plain version on the CPU)."""
    _, pcfg, _, _, model = _models(decode_attn_window=window)
    phoneme, lens = _inputs(2)
    outs = [_cat(list(stream_decode(model, pcfg, phoneme, lens, max_len=MAX_LEN, chunk=CHUNK,
                                    stop_threshold=2.0, use_kernel=k, device="cpu")))
            for k in (True, False)]
    for what, a, b in zip(("pre-postnet", "postnet"), *outs):
        assert_close(a, b, TOL, what)


def test_stream_row_chunks_run_in_lockstep():
    """10 rows with ``decode_megakernel_max_batch`` 8: two row chunks of 8
    and 2 rows take every step together and equal the unsplit plain
    stream; a chunk whose rows have all voted keeps stepping with the
    other."""
    _, pcfg, _, _, model = _models(decode_megakernel_max_batch=8)
    phoneme, lens = _inputs(10, seed=3)
    init, chunk_fn, _ = make_stream_fns(model, pcfg, max_len=MAX_LEN, chunk=CHUNK,
                                        stop_threshold=2.0, use_kernel=True, device="cpu")
    state = init(phoneme, lens)
    assert [rows.b for rows in state.rows] == [8, 2]
    state.votes.voted[:8] = True  # every row of the first chunk has voted
    state, _, n = chunk_fn(state)
    assert n == CHUNK and [rows.t for rows in state.rows] == [CHUNK, CHUNK]
    fns = make_stream_fns(model, pcfg, max_len=MAX_LEN, chunk=CHUNK, stop_threshold=2.0,
                          use_kernel=True, device="cpu")
    state = fns[0](phoneme, lens)
    split = list(stream_chunks(fns, pcfg, state, MAX_LEN))
    assert sum(s for _, _, s in split) == state.n_steps == 2 * MAX_LEN  # both chunks' steps
    plain = _cat(list(stream_decode(model, pcfg, phoneme, lens, max_len=MAX_LEN, chunk=CHUNK,
                                    stop_threshold=2.0, use_kernel=False, device="cpu")))
    for what, a, b in zip(("pre-postnet", "postnet"), _cat([s[:2] for s in split]), plain):
        assert_close(a, b, TOL, what)


def test_synthesizer_stream_matches_jax():
    text = "Hello world, this streams."
    jcfg, pcfg, _, variables, _ = _models(stop_threshold=2.0)
    ref = list(JaxSynthesizer(jcfg, variables=variables, stats=STATS).stream(
        text, chunk=CHUNK, max_len=MAX_LEN - 2))
    synth = Synthesizer(pcfg, variables=variables, stats=STATS, device="cpu")
    ours = list(synth.stream(text, chunk=CHUNK, max_len=MAX_LEN - 2))
    assert [m.shape for m in ours] == [m.shape for m in ref] == [(80, CHUNK)] * 4
    assert all(m.dtype == np.float32 for m in ours)
    assert_close(np.concatenate(ours, 1), np.concatenate(ref, 1), TOL, "Synthesizer.stream")
    assert synth.steps_decoded == MAX_LEN


SERVE_SETS = ["model.d_model=64", "model.encoder_n_layers=1", "model.decoder_n_layers=1",
              "model.encoder_d_ffn=128", "model.decoder_d_ffn=128", "model.postnet_n_layers=2",
              "runtime.compute_dtype=float32", "runtime.phoneme_buckets=[16,32]",
              "runtime.infer_max_len=12", "runtime.stop_threshold=2.0"]


def test_cli_serve_writes_the_files(tmp_path, capsys):
    sets = [f"path.preprocessed={tmp_path}", *SERVE_SETS]
    import wave

    from transformertts_tpu_torch.config import load_config
    from transformertts_tpu_torch.models import TransformerTTS
    from transformertts_tpu_torch.train.checkpoint import CheckpointManager
    from transformertts_tpu_torch.train.train_step import create_train_state

    cfg = load_config(None, sets)
    model = TransformerTTS(cfg.model, device="cpu", generator=torch.Generator().manual_seed(1))
    CheckpointManager(tmp_path / "ckpt").save(3, create_train_state(model, cfg), epoch=1)
    (tmp_path / "lines.txt").write_text("Hello world.\n\n  \nA second line.\n")
    cli.main(["serve", "--ckpt", str(tmp_path / "ckpt"), "--out-dir", str(tmp_path / "out"),
              "--chunk", "8", "--wav", "--input", str(tmp_path / "lines.txt"),
              "--device", "cpu", *[a for s in sets for a in ("--set", s)]])
    assert "served 2 utterances" in capsys.readouterr().out
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "utt_0000.npy", "utt_0000.wav", "utt_0001.npy", "utt_0001.wav"]
    for i in range(2):
        mel = np.load(tmp_path / "out" / f"utt_{i:04d}.npy")
        assert mel.shape == (80, 16) and np.isfinite(mel).all()  # 12 rounded up to 2 chunks
        with wave.open(str(tmp_path / "out" / f"utt_{i:04d}.wav")) as w:
            assert w.getnframes() == 15 * 256
    one = Synthesizer(cfg, checkpoint_dir=tmp_path / "ckpt", device="cpu")
    np.testing.assert_array_equal(
        np.load(tmp_path / "out" / "utt_0000.npy"),
        np.concatenate(list(one.stream("Hello world.", chunk=8)), axis=1))


def test_stream_ignores_prenet_dropout_and_speculative_decode():
    """As the JAX stream: it reads neither option."""
    _, pcfg, _, _, model = _models()
    phoneme, lens = _inputs(2)
    base = _cat(list(stream_decode(model, pcfg, phoneme, lens, max_len=MAX_LEN, chunk=CHUNK,
                                   stop_threshold=2.0, device="cpu")))
    cfg = pcfg.replace(runtime=dataclasses.replace(
        pcfg.runtime, infer_prenet_dropout=0.5, decode_speculative_k=4))
    other = _cat(list(stream_decode(model, cfg, phoneme, lens, max_len=MAX_LEN, chunk=CHUNK,
                                    stop_threshold=2.0, device="cpu")))
    for a, b in zip(base, other):
        np.testing.assert_array_equal(a, b)


LAG_CHUNK = 20  # positions a chunk: one wait inside it and one at its end
LAG_SETUPS = {  # id -> (use_kernel, B, r, window): B 10 is two chunks of rows in lockstep
    "kernel-b10-r1-w0": (True, 10, 1, 0),
    "plain-b2-r2-w2": (False, 2, 2, 2),
}


@pytest.mark.parametrize("last", [12 + v for v in decode_votes.last_votes()])
@pytest.mark.parametrize("setup", list(LAG_SETUPS))
def test_stream_late_stop_readback_equals_per_step_readback(monkeypatch, setup, last):
    """The stream (``run_lockstep``, 2 chunks of 20 positions) with the last
    row voting at each offset of the lag window from position 12 on: in the
    first chunk, at its last position, and in the second.  Every chunk the
    generator yields, the frames and stop logits of the state, and the steps
    run are those of the votes read after every step, bit for bit; every
    ``decode.loop`` counts the steps it ran past the batch's stop as
    ``overrun`` and its waits as ``lag_counts`` says."""
    use_kernel, b, r, window = LAG_SETUPS[setup]
    _, pcfg, _, _, model = _models(r, decode_attn_window=window, decode_megakernel_max_batch=8)
    votes = decode_votes.vote_steps(b, last)
    max_len = 2 * LAG_CHUNK * r
    fns = make_stream_fns(model, pcfg, max_len=max_len, chunk=LAG_CHUNK * r,
                          stop_threshold=decode_votes.THRESHOLD, use_kernel=use_kernel,
                          device="cpu")

    def run():
        state = fns[0](*_inputs(b, seed=3))
        return state, list(stream_chunks(fns, pcfg, state, max_len))

    runs = {lag: decode_votes.decode_with_votes(monkeypatch, lag, votes, run)
            for lag in (1, decode_mod.LAG)}
    (one, chunks_one), _, _ = runs[1]
    (late, chunks_late), _, _ = runs[decode_mod.LAG]
    assert [s for *_, s in chunks_one] == [s for *_, s in chunks_late]
    for (p1, q1, _), (p2, q2, _) in zip(chunks_one, chunks_late, strict=True):
        np.testing.assert_array_equal(p1, p2)
        np.testing.assert_array_equal(q1, q2)
    assert torch.equal(one.frames, late.frames) and torch.equal(one.stops, late.stops)
    assert one.t == late.t == last + 1 and one.n_steps == late.n_steps
    assert not late.frames[:, (last + 1) * r + 1:].any()
    for lag, ((state, _), loops, calls) in runs.items():
        start = 0
        for s in loops:
            stop = last - start if start <= last else None
            n = 0 if stop is None else min(start + LAG_CHUNK, 2 * LAG_CHUNK) - start
            ran, w = decode_votes.lag_counts(n, stop if stop is not None and stop < n else None,
                                             lag)
            assert s.attrs["waits"] == w
            assert s.attrs["overrun"] == ran * len(state.rows) - s.attrs["steps"]
            start += s.attrs["steps"] // len(state.rows)
        assert sum(s.attrs["overrun"] for s in loops) == calls - state.n_steps
