"""The port's ``Trainer`` on its own (the cases of ``tests/test_trainer.py``),
and resume: with dropout and EMA on, 1 epoch plus a resumed epoch equals 2
uninterrupted epochs bit for bit on the CPU."""

import dataclasses
import json
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tests.test_data import corpus  # noqa: F401  (fixture)
from tests.test_torch_trainer import micro_overrides
from transformertts_tpu_torch.config import Config, load_config
from transformertts_tpu_torch.train.checkpoint import CheckpointManager
from transformertts_tpu_torch.train.trainer import TIMING_KEYS, Trainer


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):  # noqa: F811
    root, out, _ = corpus
    exp = tmp_path_factory.mktemp("exp")
    cfg = load_config(None, micro_overrides(root, out, exp,
                                            "training.teacher_forcing_warmup_epochs=0"))
    trainer = Trainer(cfg, exp / "run1", resume=False, profile_steps=1, device="cpu")
    return cfg, exp, trainer, trainer.fit()


def test_fit_completes(trained):
    _, _, _, result = trained
    assert result["epochs"] == 2
    assert np.isfinite(result["best_val"])


def test_history_written(trained):
    _, exp, _, _ = trained
    hist = json.loads((exp / "run1" / "history.json").read_text())
    assert len(hist) == 2
    assert {"epoch", "total", "val_loss", "audio_s_per_s", "p_tf", "val_free_mel_l1",
            "val_free_mcd", "val_free_len_ratio", *TIMING_KEYS} <= set(hist[0])
    assert hist[1]["p_tf"] < 1.0  # linear decay kicks in after epoch 0
    assert hist[0]["audio_s_per_s"] > 0 and 0.0 <= hist[0]["loader_wait_share"] < 1.0
    assert hist[0]["step_ms_median"] > 0 and hist[0]["ckpt_save_ms"] > 0
    first_s = 1e-3 * hist[0]["loader_wait_first_ms"]
    assert 0 < first_s <= hist[0]["loader_wait_share"] * hist[0]["epoch_s"]


def test_plots_written(trained):
    _, exp, _, _ = trained
    for sub in ("mels_batch", "align_batch", "align_single", "mels_single"):
        assert list((exp / "run1" / sub).glob("*.png")), sub


def test_profile_trace_written(trained):
    """``profile_steps`` traces that many steps after the first of the
    first epoch with ``torch.profiler``."""
    _, exp, _, _ = trained
    traces = list((exp / "run1" / "profile").glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_scheduled_sampling_plots_written_at_train_time(trained):
    """Epoch 1 runs with p_tf < 1 and log_interval 1: the mixed decoder
    inputs of the actual training batch are plotted (ref:
    lightning_module.py:82)."""
    _, exp, _, _ = trained
    assert list((exp / "run1" / "mels_scheduled").glob("epoch_0001_step_*.png"))


def test_checkpoint_and_resume(trained):
    cfg, exp, _, _ = trained
    assert CheckpointManager(exp / "run1" / "checkpoints").latest_step() == 4
    again = Trainer(cfg, exp / "run1", resume=True, device="cpu")
    assert again.start_epoch == 2 and again.state.step == 4
    assert again.fit()["epochs"] == 0  # nothing left to do


def test_best_checkpoint_retained(trained):
    cfg, exp, _, result = trained
    hist = json.loads((exp / "run1" / "history.json").read_text())
    metric = cfg.training.keep_best_metric
    assert metric == "val_free_mcd_dtw"
    best_row = min((h for h in hist if metric in h), key=lambda h: h[metric])
    best = CheckpointManager(exp / "run1" / "checkpoints_best")
    assert best.latest_step() == 2 * (best_row["epoch"] + 1)
    assert result["best_" + metric] == best_row[metric]


def test_guided_weight_anneal_schedule():
    cfg = Config().replace(loss=dataclasses.replace(
        Config().loss, guided_attn_weight=10.0, guided_attn_anneal_at_diag=0.9,
        guided_attn_anneal_epochs=20))
    stub = SimpleNamespace(cfg=cfg, ga_anneal_start=None)
    assert Trainer._guided_weight(stub, 5) == 10.0
    stub.ga_anneal_start = 30
    assert Trainer._guided_weight(stub, 30) == 10.0
    assert abs(Trainer._guided_weight(stub, 40) - 5.0) < 1e-9
    assert Trainer._guided_weight(stub, 50) == 0.0
    assert Trainer._guided_weight(stub, 200) == 0.0
    cfg_off = Config().replace(loss=dataclasses.replace(Config().loss, guided_attn_weight=10.0))
    assert Trainer._guided_weight(SimpleNamespace(cfg=cfg_off, ga_anneal_start=None), 5) is None


def test_anneal_start_recovery_from_history():
    loss_cfg = dataclasses.replace(Config().loss, guided_attn_weight=10.0,
                                   guided_attn_anneal_at_diag=0.9, guided_attn_anneal_epochs=20)
    hist = [{"epoch": 33, "ga_w": 10.0, "ga_anneal_start": None},
            {"epoch": 34, "ga_w": 10.0, "ga_anneal_start": 35},
            {"epoch": 35, "ga_w": 10.0, "ga_anneal_start": 35}]
    assert Trainer._recover_anneal_start(hist, loss_cfg) == 35
    legacy = [{"epoch": 34, "ga_w": 10.0}, {"epoch": 36, "ga_w": 9.0}]
    assert Trainer._recover_anneal_start(legacy, loss_cfg) == 34
    assert Trainer._recover_anneal_start(
        [{"epoch": 1, "ga_w": 10.0, "ga_anneal_start": None}], loss_cfg) is None
    assert Trainer._recover_anneal_start([{"epoch": 1}], loss_cfg) is None


@pytest.mark.parametrize("override", ["runtime.mesh_model=2", "runtime.mesh_data=2",
                                      "runtime.shard_sequence=true"])
def test_unported_parallelism_raises(override, tmp_path):
    """A mesh the processes cannot fill raises before anything is built
    (parallelism itself runs: tests/test_torch_parallel.py)."""
    with pytest.raises(ValueError,
                       match="processes, it has 1|the 1 processes|needs runtime.mesh_model > 1"):
        Trainer(load_config(None, [override]), tmp_path, device="cpu")


@pytest.fixture(scope="module")
def resumed(corpus, tmp_path_factory):  # noqa: F811
    """Dropout and EMA on, scheduled sampling in epoch 1: 2 epochs in one
    run, and 1 epoch then (with ``checkpoints_best/`` emptied) a resumed
    epoch in another."""
    root, out, _ = corpus
    exp = tmp_path_factory.mktemp("resume")

    def cfg(epochs):
        return load_config(None, micro_overrides(
            root, out, exp, "training.teacher_forcing_warmup_epochs=0",
            "training.ema_decay=0.9", f"training.num_epochs={epochs}"))

    def fit(trainer):
        trainer.plots_on = False  # plots are tested above; they cost most of a CPU epoch
        return trainer, trainer.fit()

    whole, _ = fit(Trainer(cfg(2), exp / "whole", resume=False, device="cpu"))
    fit(Trainer(cfg(1), exp / "split", resume=False, device="cpu"))
    for step_dir in (exp / "split" / "checkpoints_best").iterdir():
        shutil.rmtree(step_dir)
    split = Trainer(cfg(2), exp / "split", resume=True, device="cpu")
    assert split.start_epoch == 1
    split, result = fit(split)
    return exp, whole, split, result


def test_resumed_run_equals_uninterrupted_run(resumed):
    exp, whole, split, result = resumed
    assert result["epochs"] == 1
    rows = [json.loads((exp / name / "history.json").read_text()) for name in ("whole", "split")]
    assert len(rows[0]) == len(rows[1]) == 2 and rows[1][1]["p_tf"] < 1.0
    for a, b in zip(*rows):
        assert {k: v for k, v in a.items() if k not in TIMING_KEYS} == {
            k: v for k, v in b.items() if k not in TIMING_KEYS}
    for name, t in whole.model.state_dict().items():
        assert torch.equal(t, split.model.state_dict()[name]), name
    assert whole.state.step == split.state.step == 4
    for what in ("mu", "nu"):
        for name, t in whole.state.opt_state[what].items():
            assert torch.equal(t, split.state.opt_state[what][name]), (what, name)
    for name, t in whole.state.ema_params.items():
        assert torch.equal(t, split.state.ema_params[name]), name
    assert not torch.equal(whole.state.ema_params["emb.weight"], whole.model.emb.weight)


def test_empty_best_dir_is_filled_on_resume(resumed):
    """The incumbent best is recovered from history only while
    ``checkpoints_best/`` holds its checkpoint; emptied, the first validated
    epoch of the resumed run fills it."""
    exp = resumed[0]
    assert CheckpointManager(exp / "split" / "checkpoints_best").all_steps() == [4]
