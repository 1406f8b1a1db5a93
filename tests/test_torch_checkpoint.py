"""The port's checkpoints: save / restore, retention, interrupted saves, the
EMA rules of the JAX package, ``Synthesizer(checkpoint_dir=...)``, the CLI's
``synthesize --wav``, and the decode's repacking of weights that changed
since its last call.

Synthesizer against the trainer's eval model (fp32): the weights must be
equal bit for bit; the decodes, by models built with and without the fused
ops' plain versions, within 1e-5 * max(1, max|ref|).
"""

import dataclasses
import json
import wave

import numpy as np
import pytest
import torch

from tests.test_data import corpus  # noqa: F401  (fixture)
from tests.test_torch_trainer import micro_overrides
from transformertts_tpu_torch import cli
from transformertts_tpu_torch.config import load_config, tiny_config
from transformertts_tpu_torch.infer import Synthesizer
from transformertts_tpu_torch.infer.decode import make_decode_fn
from transformertts_tpu_torch.models import TransformerTTS
from transformertts_tpu_torch.train.checkpoint import CheckpointManager
from transformertts_tpu_torch.train.train_step import create_train_state, make_train_step
from transformertts_tpu_torch.train.trainer import Trainer


def _cfg(ema_decay=0.0):
    cfg = tiny_config()
    return cfg.replace(training=dataclasses.replace(cfg.training, ema_decay=ema_decay))


def _state(cfg, seed):
    """A state with every tensor random: parameters, BatchNorm statistics,
    Adam moments and (when kept) the EMA copy."""
    gen = torch.Generator().manual_seed(seed)
    model = TransformerTTS(cfg.model, device="cpu", generator=gen)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if "running_" in name:
                buf.copy_(torch.rand(buf.shape, generator=gen) + 0.5)
    state = create_train_state(model, cfg)
    for what in ("mu", "nu"):
        for t in state.opt_state[what].values():
            t.copy_(torch.randn(t.shape, generator=gen))
    state.opt_state["count"] = 7 + seed
    state.step = 9 + seed
    if state.ema_params is not None:
        for t in state.ema_params.values():
            t.copy_(torch.randn(t.shape, generator=gen))
    return state


def _equal_dicts(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("ema", [0.0, 0.9])
def test_save_then_restore_gives_equal_tensors(tmp_path, ema):
    cfg = _cfg(ema)
    saved = _state(cfg, seed=1)
    mgr = CheckpointManager(tmp_path)
    mgr.save(saved.step, saved, epoch=3, extra={"note": "x"})
    restored, epoch = mgr.restore(_state(cfg, seed=2))
    assert epoch == 3 and restored.step == saved.step and mgr.latest_step() == saved.step
    assert _equal_dicts(restored.model.state_dict(), saved.model.state_dict())
    assert restored.opt_state["count"] == saved.opt_state["count"]
    for what in ("mu", "nu"):
        assert _equal_dicts(restored.opt_state[what], saved.opt_state[what])
    if ema:
        assert _equal_dicts(restored.ema_params, saved.ema_params)
    else:
        assert restored.ema_params is None
    meta = json.loads((tmp_path / str(saved.step) / "meta.json").read_text())
    assert meta["has_ema"] is bool(ema) and meta["note"] == "x"
    mgr.close()


def test_max_to_keep_and_interrupted_saves(tmp_path):
    cfg = _cfg()
    state = _state(cfg, seed=0)
    mgr = CheckpointManager(tmp_path, max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore(state) == (None, 0)
    for step in (2, 4, 6):
        mgr.save(step, state, epoch=step // 2)
    assert mgr.all_steps() == [4, 6]
    # a save cut short: its temporary directory, or a step directory whose
    # meta.json (written last) is missing, is not a checkpoint
    (tmp_path / ".tmp-8").mkdir()
    (tmp_path / ".tmp-8" / "state.pt").write_bytes(b"partial")
    (tmp_path / "10").mkdir()
    (tmp_path / "10" / "state.pt").write_bytes(b"partial")
    assert mgr.latest_step() == 6
    assert mgr.restore(_state(cfg, seed=3))[1] == 3
    mgr.save(8, state, epoch=4)  # the leftover temporary directory is replaced
    assert mgr.all_steps() == [6, 8] and not (tmp_path / ".tmp-8").exists()


def test_ema_transitions(tmp_path):
    """The JAX package's rules (``transformertts_tpu/train/checkpoint.py:145-170``)."""
    on, off = _cfg(0.9), _cfg(0.0)
    with_ema, without = CheckpointManager(tmp_path / "ema"), CheckpointManager(tmp_path / "no")
    saved_ema, saved_plain = _state(on, 1), _state(off, 2)
    with_ema.save(1, saved_ema, 1)
    without.save(1, saved_plain, 1)

    # both keep EMA: restored as saved
    state, _ = with_ema.restore(_state(on, 3))
    assert _equal_dicts(state.ema_params, saved_ema.ema_params)
    # the template keeps EMA, the disk has none: a COPY of the parameters
    state, _ = without.restore(_state(on, 4))
    params = dict(state.model.named_parameters())
    assert _equal_dicts(state.ema_params, {k: p.detach() for k, p in params.items()})
    assert all(state.ema_params[k].data_ptr() != p.data_ptr() for k, p in params.items())
    # the disk has EMA, the template does not: adopted for evaluation ...
    state, _ = with_ema.restore(_state(off, 5))
    assert _equal_dicts(state.ema_params, saved_ema.ema_params)
    assert state.eval_params is state.ema_params
    # ... and dropped for EMA-off training
    state, _ = with_ema.restore(_state(off, 6), adopt_ema=False)
    assert state.ema_params is None
    # neither: none
    assert without.restore(_state(off, 7))[0].ema_params is None


def test_decode_repacks_weights_changed_since_its_last_call():
    """The kernel loop packs the decoder weights for the decode-step kernel:
    after an optimizer step the same closure decodes what a fresh one does."""
    cfg = _cfg()
    cfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime, stop_threshold=2.0))
    model = TransformerTTS(cfg.model, device="cpu", generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    phoneme, lens = rng.integers(1, 60, (2, 16)), np.array([16, 11])

    def decoder():
        return make_decode_fn(model, cfg, max_len=8, use_kernel=True, device="cpu")

    decode = decoder()
    before = decode(phoneme, lens)["post_melspec"]
    batch = {"phoneme": rng.integers(1, 60, (1, 2, 8)),
             "melspec": rng.standard_normal((1, 2, 16, 80)).astype(np.float32),
             "phoneme_lens": np.array([[8, 5]]), "melspec_lens": np.array([[16, 11]])}
    make_train_step(model, cfg)(create_train_state(model, cfg), batch, 1.0,
                                torch.Generator().manual_seed(0))
    after = decode(phoneme, lens)["post_melspec"]
    assert not torch.equal(after, before)
    assert torch.equal(after, decoder()(phoneme, lens)["post_melspec"])


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):  # noqa: F811
    """One epoch with EMA on: the checkpoint's eval params are the EMA copy."""
    root, out, _ = corpus
    exp = tmp_path_factory.mktemp("exp")
    overrides = micro_overrides(root, out, exp, "training.num_epochs=1",
                                "training.ema_decay=0.9", "runtime.stop_threshold=2.0")
    trainer = Trainer(load_config(None, overrides), exp / "run", resume=False, device="cpu")
    trainer.plots_on = False
    trainer.fit()
    return overrides, exp / "run", trainer


def test_synthesizer_reads_the_trainers_checkpoint(trained):
    overrides, run, trainer = trained
    cfg = trainer.cfg
    synth = Synthesizer(cfg, checkpoint_dir=run / "checkpoints", device="cpu")
    assert _equal_dicts(synth.model.state_dict(), trainer.eval_model.state_dict())
    ema = trainer.state.ema_params
    assert not torch.equal(ema["emb.weight"], trainer.model.emb.weight)  # EMA, not live
    assert torch.equal(synth.model.emb.weight, ema["emb.weight"])
    last = trainer.last_free_decode
    ours = make_decode_fn(synth.model, cfg, device="cpu")(last["phoneme"], last["phoneme_lens"])
    ref = last["out"]["post_melspec"]
    err = float((ours["post_melspec"] - ref).abs().max())
    assert ours["n_frames"] == last["out"]["n_frames"]
    assert err <= 1e-5 * max(1.0, float(ref.abs().max()))


def test_synthesizer_refuses_what_it_cannot_read(tmp_path):
    from transformertts_tpu.train.checkpoint import CheckpointManager as OrbaxManager

    cfg = _cfg()
    with pytest.raises(FileNotFoundError):
        Synthesizer(cfg, checkpoint_dir=tmp_path / "missing", device="cpu")
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        Synthesizer(cfg, checkpoint_dir=tmp_path / "empty", device="cpu")
    orbax = OrbaxManager(tmp_path / "orbax")
    orbax.save(1, {"w": np.zeros(3, np.float32)}, epoch=1)
    orbax.close()
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        Synthesizer(cfg, checkpoint_dir=tmp_path / "orbax", device="cpu")


def test_cli_synthesize_writes_a_wav(trained, tmp_path, capsys):
    overrides, run, trainer = trained
    args = ["--device", "cpu", *[a for o in overrides for a in ("--set", o)]]
    cli.main(["synthesize", "--ckpt", str(run / "checkpoints"), "--text", "Hello world.",
              "--out", str(tmp_path / "mel.npy"), "--wav", str(tmp_path / "out.wav"), *args])
    mel = np.load(tmp_path / "mel.npy")
    assert mel.shape == (80, 16) and np.isfinite(mel).all()
    with wave.open(str(tmp_path / "out.wav")) as w:
        assert (w.getnchannels(), w.getsampwidth(), w.getframerate()) == (1, 2, 22050)
        assert w.getnframes() == 15 * 256
    assert "wrote 16 frames" in capsys.readouterr().out


def test_cli_refuses_unported_verbs(trained, tmp_path, capsys, monkeypatch):
    """``serve`` is ported (tests/test_torch_streaming.py) and serves;
    ``train --distributed`` is ported (tests/test_torch_parallel.py) and,
    outside torchrun's environment, exits naming what is missing."""
    overrides, run, _ = trained
    (tmp_path / "none.txt").write_text("\n")
    cli.main(["serve", "--ckpt", str(run / "checkpoints"), "--device", "cpu",
              "--input", str(tmp_path / "none.txt"), "--out-dir", str(tmp_path / "out"),
              *[a for o in overrides for a in ("--set", o)]])
    assert "served 0 utterances" in capsys.readouterr().out
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(SystemExit, match="torchrun's environment; RANK, WORLD_SIZE"):
        cli.main(["train", "--distributed", "--device", "cpu",
                  *[a for o in overrides for a in ("--set", o)]])
