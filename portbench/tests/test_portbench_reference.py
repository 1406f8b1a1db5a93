"""The plain reference against the program's plain path at a tiny
configuration on the CPU, in float32: the teacher-forced forward, the
greedy decode read at each served position, and the scheduled-sampling
training step with its dropout, loss and optimizer update."""

import copy

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference.model import Plain, fp8, shift_right
from portbench.reference.train import Trainer
from portbench.reference.weights import make_weights, param_shapes

TINY = dict(d_model=64, encoder_n_layers=1, decoder_n_layers=2, encoder_n_head=2,
            decoder_n_head=2, encoder_d_ffn=128, decoder_d_ffn=128)


def tiny(name="ljspeech", **runtime):
    c = copy.deepcopy(harness.config_spec(name))
    c["model"].update(TINY)
    c["runtime"].update(compute_dtype="float32", **runtime)
    return c


def program_model(c, weights):
    from transformertts_tpu_torch.models import TransformerTTS
    from transformertts_tpu_torch.models.factory import runtime_model_kwargs

    cfg = harness.program_config(c)
    model = TransformerTTS(cfg.model, **runtime_model_kwargs(cfg, "cpu"))
    model.load_state_dict(weights, strict=True)
    return cfg, model


def test_weights_cover_the_program_state_dict():
    c = tiny()
    shapes = param_shapes(c["model"])
    _, model = program_model(c, make_weights(c["model"], 5, "cpu"))
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == shapes


def batch(seed=0, b=3, tp=16, tm=24):
    g = torch.Generator().manual_seed(seed)
    p_lens = torch.tensor([tp, tp - 5, 7][:b])
    m_lens = torch.tensor([tm, tm - 7, 9][:b])
    ids = torch.randint(4, 84, (b, tp), generator=g) * (torch.arange(tp) < p_lens[:, None])
    mel = torch.randn((b, tm, 80), generator=g) * (torch.arange(tm) < m_lens[:, None])[..., None]
    return ids, mel, p_lens, m_lens


def test_teacher_forced_forward():
    c = tiny()
    w = make_weights(c["model"], 6, "cpu")
    _, model = program_model(c, w)
    ids, mel, p_lens, m_lens = batch()
    with torch.no_grad():
        out = model(ids, mel, p_lens, m_lens, return_alignments=True)
        ref = Plain(c["model"], w)
        x, al = ref.decode(ref.encode(ids, p_lens), shift_right(mel), p_lens, m_lens, align=True)
        pred, stop = ref.heads(x)
        post = ref.postnet(pred)
    for got, want in ((out["pred_melspec"], pred), (out["pred_stop"], stop),
                      (out["post_melspec"], post), (out["alignments"], al)):
        assert torch.allclose(got, want, atol=2e-5, rtol=1e-5)


def test_served_decode_and_control():
    from transformertts_tpu_torch.infer.api import Synthesizer

    c = tiny(stop_threshold=2.0, infer_max_len=48, phoneme_buckets=[16, 32])
    w = make_weights(c["model"], 7, "cpu")
    syn = Synthesizer(harness.program_config(c), state_dict=w, stats=c["stats"], device="cpu")
    seen = {}
    orig = syn._decode_fn

    def decode_fn(max_len, stop_threshold):
        fn = orig(max_len, stop_threshold)

        def decode(ph, lens):
            seen["out"], seen["ph"], seen["lens"] = fn(ph, lens), ph, lens
            return seen["out"]
        return decode

    syn._decode_fn = decode_fn
    mels = syn.synthesize(["The cat sat.", "And all of it was there, by the sea."], max_len=48)
    out = seen["out"]
    with torch.no_grad():
        ph, lens = torch.as_tensor(seen["ph"]).long(), torch.as_tensor(seen["lens"]).long()
        mel, stop, post = Plain(c["model"], w).served(ph, lens, out["pred_melspec"])
        low_mel, _, _ = Plain(c["model"], w, q=fp8).served(ph, lens, out["pred_melspec"])
    assert torch.allclose(out["pred_melspec"], mel, atol=2e-5)
    assert torch.allclose(out["pred_stop"], stop, atol=2e-5)
    served = torch.as_tensor(mels[1]).t()
    want = post[1] * (c["stats"]["std"] + 1e-8) + c["stats"]["mean"]
    assert torch.allclose(served, want, atol=1e-4)
    # the float8 control lies far further from the reference than the program
    prog = float((out["pred_melspec"] - mel).abs().max())
    assert float((low_mel - mel).abs().max()) > 100 * max(prog, 1e-6)


@pytest.mark.parametrize("name", ["ljspeech", "paper"])
def test_training_step(name):
    """Two optimizer steps of the program's scheduled-sampling step and of
    the reference from the same weights, batch and generator (ljspeech
    runs guided attention through the plain cross-attention, paper through
    the flash path's mask)."""
    from transformertts_tpu_torch.train.train_step import create_train_state, make_train_step

    c = tiny(name)
    w = make_weights(c["model"], 8, "cpu")
    cfg, model = program_model(c, w)
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg, scheduled_sampling=True)
    ids, mel, p_lens, m_lens = batch(1)
    b = {"phoneme": ids[None].repeat(2, 1, 1), "melspec": mel[None].repeat(2, 1, 1, 1),
         "phoneme_lens": p_lens[None].repeat(2, 1), "melspec_lens": m_lens[None].repeat(2, 1)}
    gen = torch.Generator().manual_seed(99)
    ref_gen = torch.Generator().manual_seed(99)
    ref = Trainer(c, w)
    for i in range(2):
        state, metrics = step(state, b, 0.5, gen)
        got = ref.step(b, 0.5, ref_gen)
        assert float(metrics["total"]) == pytest.approx(got["loss"], rel=1e-5)
        assert float(metrics["grad_norm"]) == pytest.approx(got["grad_norm"], rel=1e-4)
        if i == 0:  # leaves with a gradient nought to rounding move by round-off under Adam
            norms = {n: float(g.norm()) for n, g in got["grads"].items()}
            med = float(np.median(list(norms.values())))
            moved = {n for n, v in norms.items() if v >= 1e-3 * med}
    assert len(moved) > 0.8 * len(norms)
    for n, p in model.named_parameters():
        if n not in moved:
            continue
        dp_prog = (p.detach() - w[n]).norm()
        dp_ref = (ref.params[n].detach() - w[n]).norm()
        assert float((dp_prog - dp_ref).abs()) <= 1e-3 * max(float(dp_ref), 1e-9), n
    assert np.isfinite(got["loss"])
