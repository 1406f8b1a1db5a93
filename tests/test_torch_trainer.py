"""PyTorch port vs JAX package: ``Trainer.fit`` and ``mcd_dtw``.

Both trainers run on the ``tests/test_data.py`` corpus with the micro config
of ``tests/test_trainer.py`` (d_model 64, 1 + 1 layers, batch 2 x 2, buckets
32 / [64, 128]), fp32, every dropout rate 0, ``teacher_forcing_warmup_epochs``
2 so that both epochs train with ``p_tf = 1`` (teacher forcing), and
``warmup_steps`` 10 so that an Adam update is large enough to matter.  The
port starts from the JAX trainer's initial weights and Adam state, carried
over in the test through ``convert.torch_state_from_jax`` /
``opt_state_from_optax``; both loaders read the same npz files in the same
order.

Tolerances, relative, per ``history.json`` value (measured on this CPU in
brackets):
- the train metrics ``total``, ``pred_mel``, ``post_mel``, ``stop`` and
  ``grad_norm``: 2e-5 in epoch 0, whose first step starts from equal weights
  (<= 3.5e-7), 1e-4 in epoch 1 (<= 4.6e-7);
- ``val_loss``, ``val_mel_l1`` and ``val_diagonality``: 2e-4 in epoch 0
  (<= 1.6e-5) and 5e-4 in epoch 1 (<= 5e-5): validation runs after Adam's
  updates, whose ill-conditioned elements carry the gradients' rounding
  differences at full step size (``test_torch_train_step.py`` explains).
The free-running ``val_free_*`` metrics are only required present and finite:
a free decode feeds its own outputs back and is chaotic.
"""

import json
import math

import jax
import numpy as np
import pytest

from tests.test_data import corpus  # noqa: F401  (fixture)
from transformertts_tpu.config import load_config as jax_load_config
from transformertts_tpu.train.metrics import mcd_dtw as jax_mcd_dtw
from transformertts_tpu.train.trainer import Trainer as JaxTrainer
from transformertts_tpu_torch.config import load_config
from transformertts_tpu_torch.convert import opt_state_from_optax, torch_state_from_jax
from transformertts_tpu_torch.train.metrics import mcd_dtw
from transformertts_tpu_torch.train.trainer import Trainer

DROPOUTS = ("encoder_prenet_dropout", "encoder_dropout", "decoder_prenet_dropout",
            "decoder_dropout", "postnet_dropout", "pe_dropout")
TRAIN_KEYS = ("total", "pred_mel", "post_mel", "stop", "grad_norm")
VAL_KEYS = ("val_loss", "val_mel_l1", "val_diagonality")
TOL = {0: {"train": 2e-5, "val": 2e-4}, 1: {"train": 1e-4, "val": 5e-4}}


def micro_overrides(root, out, exp, *extra) -> list:
    """``tests/test_trainer.py``'s micro config on the corpus at ``root``."""
    return [
        f"path.data={root}", f"path.preprocessed={out}", f"path.experiment={exp}",
        "model.d_model=64", "model.encoder_n_layers=1", "model.decoder_n_layers=1",
        "model.encoder_d_ffn=128", "model.decoder_d_ffn=128", "model.postnet_n_layers=2",
        "training.batch_size=2", "training.grad_acc_steps=2",
        "training.num_epochs=2", "training.log_interval=1",
        "runtime.compute_dtype=float32", "runtime.use_pallas_attention=false",
        "runtime.prng_impl=threefry2x32",
        "runtime.phoneme_buckets=[32]", "runtime.mel_buckets=[64,128]",
        "runtime.infer_max_len=16", *extra,
    ]


@pytest.fixture(scope="module")
def both(corpus, tmp_path_factory):  # noqa: F811
    root, out, _ = corpus
    exp = tmp_path_factory.mktemp("exp")
    overrides = micro_overrides(
        root, out, exp, "training.teacher_forcing_warmup_epochs=2", "training.warmup_steps=10",
        *[f"model.{name}=0.0" for name in DROPOUTS])
    jax_trainer = JaxTrainer(jax_load_config(None, overrides), exp / "jax", resume=False)
    init = jax.device_get(jax_trainer.state)
    trainer = Trainer(load_config(None, overrides), exp / "port", resume=False, device="cpu")
    trainer.plots_on = False  # plots are tested in test_torch_trainer_loop.py
    trainer.model.load_state_dict(torch_state_from_jax(
        {"params": init.params, "batch_stats": init.batch_stats}, trainer.cfg.model))
    adam = init.opt_state[2]
    trainer.state.opt_state = opt_state_from_optax(adam.mu, adam.nu, adam.count,
                                                  trainer.cfg.model)
    results = jax_trainer.fit(), trainer.fit()
    histories = [json.loads((exp / name / "history.json").read_text()) for name in ("jax", "port")]
    return exp, results, histories


def test_fit_history_matches_jax(both):
    _, (jres, pres), (jhist, phist) = both
    assert jres["epochs"] == pres["epochs"] == 2 and len(jhist) == len(phist) == 2
    for epoch, (ref, ours) in enumerate(zip(jhist, phist)):
        assert ours["epoch"] == ref["epoch"] == epoch and ours["p_tf"] == ref["p_tf"] == 1.0
        assert set(ref) <= set(ours)
        for keys, kind in ((TRAIN_KEYS, "train"), (VAL_KEYS, "val")):
            for key in keys:
                rel = abs(ours[key] - ref[key]) / abs(ref[key])
                assert rel <= TOL[epoch][kind], f"epoch {epoch} {key}: {ours[key]} vs {ref[key]}"
        for key in ("val_free_mel_l1", "val_free_mcd", "val_free_mcd_dtw", "val_free_len_ratio"):
            assert math.isfinite(ours[key]), key
        assert ours["skipped"] == ref["skipped"] == 0.0


def test_same_checkpoint_steps_on_disk(both):
    exp = both[0]
    steps = [sorted(int(p.name) for p in (exp / name / "checkpoints").iterdir()
                    if p.name.isdigit()) for name in ("jax", "port")]
    assert steps[0] == steps[1] == [2, 4]


@pytest.mark.parametrize("case", ["random", "identical", "shifted"])
def test_mcd_dtw_matches_jax(case):
    rng = np.random.default_rng(7)
    true = rng.standard_normal((41, 80)).astype(np.float32)
    pred = {"random": rng.standard_normal((37, 80)).astype(np.float32),
            "identical": true.copy(),
            "shifted": np.concatenate([true[:1], true[:1], true])[:44] + 0.01}[case]
    ours, ref = mcd_dtw(pred, true), jax_mcd_dtw(pred, true)
    assert abs(ours - ref) <= 1e-9 * max(1.0, abs(ref))
    if case == "identical":  # 0 up to the 1e-12 floor under the square root
        assert ours < 1e-4
