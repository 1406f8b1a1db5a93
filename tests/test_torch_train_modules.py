"""PyTorch port vs JAX package: the pieces the training step is made of.

Train-mode BatchNorm (output and both running statistics after two
updates), the losses, the scheduled-sampling block mask fed with the very
bits ``jax.random.bernoulli`` gave, both schedules and the two evaluation
metrics: the same numpy-seeded inputs through both packages.

Tolerance: fp32 on both sides and the same formulas, so 1e-5 of
max(1, max|jax|) (summation order only), 1e-6 for the schedules.
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import assert_close
from transformertts_tpu.train import loss as jloss
from transformertts_tpu.train import metrics as jmetrics
from transformertts_tpu.train import sampling as jsampling
from transformertts_tpu.train import schedules as jschedules
from transformertts_tpu_torch.models.modules import BatchNorm, DropoutRng, dropout
from transformertts_tpu_torch.train import loss, metrics, sampling, schedules

TOL = 1e-5


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t.long() if not t.is_floating_point() else t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batchnorm_train_mode_matches_flax(dtype):
    """Batch statistics over every (B, T) position, biased variance as
    E[x^2] - E[x]^2, and the same biased variance into the running
    statistics with 0.9 / 0.1: after TWO updates, as one micro-batch does."""
    rng = np.random.default_rng(0)
    d = 24
    xs = [(rng.standard_normal((3, 10, d)) * s + m).astype(np.float32)
          for s, m in ((1.5, 0.3), (0.7, -1.0))]
    scale = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(d)).astype(np.float32)
    mean0 = (0.1 * rng.standard_normal(d)).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, d).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5, dtype=jd,
                           param_dtype=jnp.float32)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    bn = BatchNorm(d, td, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(_t(scale)); bn.bias.copy_(_t(bias))
        bn.running_mean.copy_(_t(mean0)); bn.running_var.copy_(_t(var0))
    tol = TOL if dtype == "float32" else 2e-2
    for x in xs:
        ref, upd = flax_bn.apply(variables, jnp.asarray(x, jd), mutable=["batch_stats"])
        variables = {"params": variables["params"], "batch_stats": upd["batch_stats"]}
        out = bn(_t(x).to(td), train=True)
        assert out.dtype == td
        assert_close(out.detach(), np.asarray(ref, np.float32), tol, "train-mode output")
    assert_close(bn.running_mean, variables["batch_stats"]["mean"], TOL, "running mean")
    assert_close(bn.running_var, variables["batch_stats"]["var"], TOL, "running var (biased)")
    n = 3 * 10  # torch.nn.BatchNorm1d would have stored var * n / (n - 1)
    unbiased = 0.9 * (0.9 * var0 + 0.1 * xs[0].reshape(-1, d).var(0) * n / (n - 1)) \
        + 0.1 * xs[1].reshape(-1, d).var(0) * n / (n - 1)
    assert float(np.abs(bn.running_var.numpy() - unbiased).max()) > 1e-3
    # eval mode reads the statistics just stored
    ref = nn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5, dtype=jd,
                       param_dtype=jnp.float32).apply(variables, jnp.asarray(xs[0], jd))
    assert_close(bn(_t(xs[0]).to(td)).detach(), np.asarray(ref, np.float32), tol, "eval output")


def test_batchnorm_gradient_flows_through_the_batch_statistics():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 8)).astype(np.float32)
    w = rng.standard_normal((2, 6, 8)).astype(np.float32)
    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = flax_bn.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def f(x_):
        y, _ = flax_bn.apply(variables, x_, mutable=["batch_stats"])
        return jnp.sum(y * w)

    ref = jax.grad(f)(jnp.asarray(x))
    bn = BatchNorm(8, device="cpu")
    bn.reset_parameters()
    xt = _t(x).requires_grad_(True)
    (bn(xt, train=True) * _t(w)).sum().backward()
    assert_close(xt.grad, np.asarray(ref), 1e-4, "dx through batch statistics")


def _outputs(rng, b=3, t=20, c=80):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in (("pred_melspec", (b, t, c)), ("post_melspec", (b, t, c)),
                         ("pred_stop", (b, t)))}


@pytest.mark.parametrize("stop_gate_k", [1, 3])
def test_tts_loss_matches_jax(stop_gate_k):
    rng = np.random.default_rng(2)
    out = _outputs(rng)
    mel = rng.standard_normal((3, 20, 80)).astype(np.float32)
    lens = np.array([20, 13, 1], np.int32)
    ref = jloss.tts_loss({k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(mel),
                         jnp.asarray(lens), 8.0, 0.5, stop_gate_k)
    ours = loss.tts_loss({k: _t(v) for k, v in out.items()}, _t(mel), _t(lens), 8.0, 0.5,
                         stop_gate_k)
    assert set(ours) == set(ref)
    for k in ref:
        assert_close(ours[k], np.asarray(ref[k]), TOL, k)


def test_guided_attention_loss_and_diagonality_match_jax():
    rng = np.random.default_rng(3)
    align = rng.random((2, 3, 4, 16, 12)).astype(np.float32)
    align /= align.sum(-1, keepdims=True)
    mel_lens, p_lens = np.array([16, 9, 0], np.int32), np.array([12, 7, 5], np.int32)
    args = (jnp.asarray(align), jnp.asarray(mel_lens), jnp.asarray(p_lens))
    targs = (_t(align), _t(mel_lens), _t(p_lens))
    assert_close(loss.guided_attention_loss(*targs, 0.4),
                 np.asarray(jloss.guided_attention_loss(*args, 0.4)), TOL, "guided attention")
    assert_close(loss.alignment_diagonality(*targs),
                 np.asarray(jloss.alignment_diagonality(*args)), TOL, "diagonality")


@pytest.mark.parametrize("l_bar,t", [(8, 40), (5, 23), (1, 9)])
def test_block_mask_dilation_on_the_bits_jax_drew(l_bar, t):
    key = jax.random.PRNGKey(l_bar)
    p_tf = 0.8
    seeds = np.asarray(jax.random.bernoulli(key, 1.0 - p_tf, (4, t)))
    ref = np.asarray(jsampling.block_mask(key, 4, t, p_tf, l_bar))
    ours = sampling.dilate_seeds(torch.tensor(seeds), l_bar).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert ref.any() and not ref.all()


def test_apply_teacher_forcing():
    rng = np.random.default_rng(4)
    pred = rng.standard_normal((3, 24, 80)).astype(np.float32)
    mel = rng.standard_normal((3, 24, 80)).astype(np.float32)
    lens = np.array([24, 15, 3], np.int32)
    key = jax.random.PRNGKey(9)
    ref = np.asarray(jsampling.apply_teacher_forcing(
        key, jnp.asarray(pred), jnp.asarray(mel), jnp.asarray(lens), 0.6, 8))
    mask = torch.tensor(np.asarray(jsampling.block_mask(key, 3, 24, 0.6, 8)))
    ours = sampling.mix_teacher_forcing(mask, _t(pred), _t(mel), _t(lens))
    np.testing.assert_array_equal(ours.numpy(), ref)
    # p_tf = 1: pure ground truth, still zeroed past the valid length; p_tf = 0: predictions
    g = torch.Generator().manual_seed(0)
    gt = sampling.apply_teacher_forcing(g, _t(pred), _t(mel), _t(lens), 1.0)
    valid = (np.arange(24)[None, :] < lens[:, None])[:, :, None]
    np.testing.assert_array_equal(gt.numpy(), np.where(valid, mel, 0.0))
    all_pred = sampling.apply_teacher_forcing(g, _t(pred), _t(mel), _t(lens), 0.0)
    np.testing.assert_array_equal(all_pred.numpy(), np.where(valid, pred, 0.0))
    # the drawn rate, and reproducibility from the generator's seed
    a = sampling.block_mask(torch.Generator().manual_seed(5), 64, 512, 0.9, 1)
    b = sampling.block_mask(torch.Generator().manual_seed(5), 64, 512, 0.9, 1)
    assert torch.equal(a, b) and abs(float(a.float().mean()) - 0.1) < 0.01


def test_schedules_match_jax():
    ours, ref = schedules.noam_schedule(256, 4000), jschedules.noam_schedule(256, 4000)
    for step in (0, 1, 2, 100, 3999, 4000, 4001, 100_000):
        assert abs(ours(step) - float(ref(jnp.asarray(step)))) <= 1e-6 * float(ref(jnp.asarray(step)))
    assert ours(0) == ours(1)
    for mode in ("linear", "cosine", "constant"):
        for epoch in (0, 9, 10, 50, 299, 400):
            kw = dict(total_epochs=300, mode=mode, warmup_epochs=10, constant_value=0.7)
            assert schedules.teacher_forcing_ratio(epoch, **kw) == pytest.approx(
                jschedules.teacher_forcing_ratio(epoch, **kw), abs=1e-12)
    with pytest.raises(ValueError, match="Unsupported"):
        schedules.teacher_forcing_ratio(20, mode="nope")


def test_eval_metrics_match_jax():
    rng = np.random.default_rng(5)
    pred = rng.standard_normal((3, 30, 80)).astype(np.float32)
    true = rng.standard_normal((3, 30, 80)).astype(np.float32)
    stop = rng.standard_normal((3, 30)).astype(np.float32) * 3
    lens = np.array([30, 18, 0], np.int32)
    assert_close(metrics.mel_cepstral_distortion(_t(pred), _t(true), _t(lens)),
                 np.asarray(jmetrics.mel_cepstral_distortion(
                     jnp.asarray(pred), jnp.asarray(true), jnp.asarray(lens))), TOL, "mcd")
    ref = jmetrics.stop_token_metrics(jnp.asarray(stop), jnp.asarray(lens))
    ours = metrics.stop_token_metrics(_t(stop), _t(lens))
    assert set(ours) == set(ref)
    for k in ref:
        assert_close(ours[k], np.asarray(ref[k], np.float32), TOL, k)


def test_plain_dropout_is_flax_dropout_on_explicit_generators():
    x = torch.ones(64, 256)
    assert dropout(x, 0.5, False, None) is x and dropout(x, 0.0, True, None) is x
    with pytest.raises(ValueError, match="DropoutRng"):
        dropout(x, 0.5, True, None)
    a = dropout(x, 0.5, True, DropoutRng(3))
    b = dropout(x, 0.5, True, DropoutRng(3))
    assert torch.equal(a, b) and set(a.unique().tolist()) == {0.0, 2.0}
    assert abs(float((a > 0).float().mean()) - 0.5) < 0.02
    before = torch.get_rng_state()
    dropout(x, 0.5, True, DropoutRng(4))
    assert torch.equal(before, torch.get_rng_state())  # the global RNG is never touched
