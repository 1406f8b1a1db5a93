"""PyTorch port vs JAX package: the training step.

Tiny config, fp32, every dropout rate 0 and ``p_tf = 1.0``, so that both
packages compute the same function of the same numbers (the first,
gradient-free pass still runs and still updates BatchNorm).  The JAX model
is built as ``bench.py`` builds it (``runtime_model_kwargs``: flash
attention and fused LayerNorm in Pallas interpret mode, fused q|k|v); the
port takes the same switches and, on the CPU, runs the kernels' plain
versions.  Weights, gradients and Adam moments cross over through
``transformertts_tpu_torch.convert``.  ``warmup_steps`` is 10 so that an
update is ~1e-3 of a weight and comparing updates means something.

Tolerances (fp32; only summation order and fused-vs-unfused roundings
differ), per tensor as max|port - jax| <= tol * max(scale, max|jax|):
- losses and grad_norm: 1e-5 relative;
- gradients: 1e-3 of the tensor's largest entry, with a floor of 1e-5 of
  the global gradient norm (the backward chains ~30 layers of fp32
  roundings);
- Adam moments: 1e-3 of the tensor's largest entry after one step from a
  shared state (linear and quadratic in the gradients), 1e-2 / 2e-2 (mu / nu)
  after two steps from scratch, because the ill-conditioned elements below
  make the two packages' weights differ by up to a step after the first
  update; BatchNorm statistics 1e-4 relative;
- UPDATES (parameter after - before): Adam's first steps are
  lr * g / (|g| + 1e-9) per element, so an element whose gradient is small
  beside the tensor's largest carries the tensor-level gradient error at full
  size (and the key-projection biases, whose true gradient is identically
  zero because softmax ignores a shift of all of a query's scores, are pure
  rounding noise turned into full-size steps).  Elements whose sqrt(nu) is
  at least a tenth of the tensor's largest are held to 2e-2 of the step; all
  others only to the step size itself (|difference| <= 2 steps).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import _variables
from transformertts_tpu.config import tiny_config as jax_tiny_config
from transformertts_tpu.models import TransformerTTS as JaxTTS
from transformertts_tpu.models.factory import runtime_model_kwargs as jax_runtime_kwargs
from transformertts_tpu.train import train_step as jax_ts
from transformertts_tpu_torch.config import tiny_config
from transformertts_tpu_torch.convert import (
    opt_state_from_optax,
    torch_state_from_jax,
    torch_tree_from_jax,
)
from transformertts_tpu_torch.models import TransformerTTS
from transformertts_tpu_torch.models.factory import runtime_model_kwargs
from transformertts_tpu_torch.train import train_step as ts

K, B, TP, TM = 2, 2, 8, 16
NO_DROPOUT = dict(encoder_prenet_dropout=0.0, encoder_dropout=0.0, decoder_prenet_dropout=0.0,
                  decoder_dropout=0.0, postnet_dropout=0.0, pe_dropout=0.0)


def _configs(dropout_off=True, **training):
    out = []
    for cfg in (jax_tiny_config(), tiny_config()):
        model = dataclasses.replace(cfg.model, **(NO_DROPOUT if dropout_off else {}))
        cfg = cfg.replace(
            model=model,
            training=dataclasses.replace(cfg.training, warmup_steps=10, **training))
        out.append(cfg.validate())
    return out


def _batch(seed=0, k=K):
    rng = np.random.default_rng(seed)
    return {
        "phoneme": rng.integers(1, 60, (k, B, TP)).astype(np.int32),
        "melspec": rng.standard_normal((k, B, TM, 80)).astype(np.float32),
        "phoneme_lens": np.stack([np.array([TP, 5], np.int32)] * k),
        "melspec_lens": np.stack([np.array([TM, 11], np.int32)] * k),
    }


def _port_model(pcfg, variables):
    model = TransformerTTS(pcfg.model, **runtime_model_kwargs(pcfg, device="cpu"))
    model.load_state_dict(torch_state_from_jax(variables, pcfg.model), strict=True)
    return model


def _close(port, ref, tol, floor, what):
    port = np.asarray(port.detach() if torch.is_tensor(port) else port, np.float32)
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (what, port.shape, ref.shape)
    err = float(np.max(np.abs(port - ref)))
    bound = tol * max(floor, float(np.max(np.abs(ref))))
    assert err <= bound, f"{what}: max abs err {err:.3g} > {bound:.3g}"


def _close_tree(port: dict, ref_tree, cfg, tol, floor, what):
    ref = torch_tree_from_jax(jax.device_get(ref_tree), cfg.model)
    assert set(port) == set(ref)
    for name in ref:
        _close(port[name], ref[name].numpy(), tol, floor, f"{what} {name}")


def _close_updates(port: dict, ref_tree, nu_tree, cfg, what):
    """Updates against the JAX package's, element by element where Adam's
    division is well conditioned (see the module docstring)."""
    ref = torch_tree_from_jax(jax.device_get(ref_tree), cfg.model)
    nu = torch_tree_from_jax(jax.device_get(nu_tree), cfg.model)
    n_firm = 0
    for name in ref:
        step = float(ref[name].abs().max())
        firm = nu[name].sqrt() >= 0.1 * nu[name].sqrt().max()
        diff = (port[name] - ref[name]).abs()
        n_firm += int(firm.sum())
        assert float(diff.max()) <= 2.0 * step + 1e-7, f"{what} {name}: beyond the step size"
        if firm.any():
            err = float(diff[firm].max())
            assert err <= 2e-2 * step, f"{what} {name}: firm elements off by {err:.3g} of {step:.3g}"
    assert n_firm > 10_000  # the comparison is not vacuous


@pytest.fixture(scope="module")
def both():
    """Both packages at the same weights, with the JAX step compiled once."""
    jcfg, pcfg = _configs()
    variables = _variables(1, 0)
    jmodel = JaxTTS(jcfg.model, **jax_runtime_kwargs(jcfg))
    jstep = jax_ts.make_train_step(jmodel, jcfg, scheduled_sampling=True, donate=False)
    params = jax.tree.map(jnp.asarray, variables["params"])
    jstate = jax_ts.TrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=jax_ts.make_optimizer(jcfg).init(params))
    return jcfg, pcfg, variables, jmodel, jstep, jstate


def test_runtime_kwargs_are_the_jax_packages(both):
    jcfg, pcfg = both[:2]
    ours, theirs = runtime_model_kwargs(pcfg, device="cpu"), jax_runtime_kwargs(jcfg)
    assert {k: ours[k] for k in ("use_flash", "use_fused_ln", "fuse_qkv")} == {
        k: theirs[k] for k in ("use_flash", "use_fused_ln", "fuse_qkv")}
    assert ours["use_flash"] and ours["use_fused_ln"] and ours["fuse_qkv"]


def test_micro_batch_losses_and_every_gradient(both):
    jcfg, pcfg, variables, jmodel, _, jstate = both
    batch = _batch()
    micro = {k: v[0] for k, v in batch.items()}
    grads, losses, new_stats, target_in = jax.jit(
        lambda p, s: jax_ts._micro_loss(jmodel, jcfg, p, s, micro, 1.0, jax.random.PRNGKey(0), True)
    )(jstate.params, jstate.batch_stats)

    model = _port_model(pcfg, variables)
    p_losses, p_target = ts._micro_loss(
        model, pcfg, ts._to_device(batch, "cpu", 0), 1.0, [1, 2, 3], True)
    assert set(p_losses) == set(losses) == {"total", "pred_mel", "post_mel", "stop"}
    for name in losses:
        _close(p_losses[name], losses[name], 1e-5, 1.0, f"loss {name}")
    _close(p_target, target_in, 1e-6, 1.0, "mixed decoder inputs")
    norm = float(jax_ts.optax.global_norm(grads))
    _close_tree({n: p.grad for n, p in model.named_parameters()}, grads, pcfg, 1e-3, 1e-5 * norm,
                "grad")
    stats = torch_state_from_jax(
        {"params": variables["params"], "batch_stats": jax.device_get(new_stats)}, pcfg.model)
    for name, buf in ts._batch_stats(model).items():  # two updates: both forward passes
        _close(buf, stats[name].numpy(), 1e-4, 1e-6, f"batch stat {name}")


def test_two_steps_then_a_third_from_the_converted_state(both):
    jcfg, pcfg, variables, _, jstep, jstate = both
    model = _port_model(pcfg, variables)
    state = ts.create_train_state(model, pcfg)
    step = ts.make_train_step(model, pcfg)
    gen = torch.Generator().manual_seed(0)
    assert ts.count_params(model) == jax_ts.count_params(jstate.params)

    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for i in range(2):
        batch = _batch(seed=10 + i)
        jprev = jstate
        jstate, jmetrics = jstep(jstate, batch, 1.0, jax.random.PRNGKey(i))
        state, metrics = step(state, batch, 1.0, gen)
        for name in ("total", "pred_mel", "post_mel", "stop", "grad_norm"):
            _close(metrics[name], jmetrics[name], 1e-5 * (i + 1), 1.0, f"step {i} {name}")
        assert float(metrics["skipped"]) == float(jmetrics["skipped"]) == 0.0
        after = {n: p.detach().clone() for n, p in model.named_parameters()}
        jupdate = jax.tree.map(lambda a, b: a - b, jstate.params, jprev.params)
        _close_updates({n: after[n] - before[n] for n in after}, jupdate,
                       jstate.opt_state[2].nu, pcfg, f"step {i} update")
        assert max(float((after[n] - before[n]).abs().max()) for n in after) > 1e-4
        before = after
    adam = jstate.opt_state[2]
    assert state.step == int(jstate.step) == 2 and state.opt_state["count"] == int(adam.count)
    _close_tree(state.opt_state["mu"], adam.mu, pcfg, 1e-2, 1e-6, "mu")
    _close_tree(state.opt_state["nu"], adam.nu, pcfg, 2e-2, 1e-9, "nu")

    # a third step from the JAX package's state, carried over whole
    mid = jax.device_get(jstate)
    model3 = _port_model(pcfg, {"params": mid.params, "batch_stats": mid.batch_stats})
    state3 = ts.TrainState(step=2, model=model3, opt_state=opt_state_from_optax(
        mid.opt_state[2].mu, mid.opt_state[2].nu, mid.opt_state[2].count, pcfg.model))
    start = {n: p.detach().clone() for n, p in model3.named_parameters()}
    batch = _batch(seed=12)
    jnext, _ = jstep(jstate, batch, 1.0, jax.random.PRNGKey(2))
    ts.make_train_step(model3, pcfg)(state3, batch, 1.0, gen)
    jupdate = jax.tree.map(lambda a, b: a - b, jnext.params, jstate.params)
    _close_updates({n: p.detach() - start[n] for n, p in model3.named_parameters()}, jupdate,
                   jnext.opt_state[2].nu, pcfg, "third update")
    _close_tree(state3.opt_state["nu"], jnext.opt_state[2].nu, pcfg, 1e-3, 1e-9, "third nu")
    stats = torch_state_from_jax(
        {"params": jax.device_get(jnext.params),
         "batch_stats": jax.device_get(jnext.batch_stats)}, pcfg.model)
    for name, buf in ts._batch_stats(model3).items():
        _close(buf, stats[name].numpy(), 1e-4, 1e-6, f"batch stat {name}")


def test_non_finite_step_leaves_the_state_untouched(both):
    _, pcfg, variables = both[:3]
    model = _port_model(pcfg, variables)
    state = ts.create_train_state(model, pcfg)
    step = ts.make_train_step(model, pcfg)
    gen = torch.Generator().manual_seed(0)
    step(state, _batch(seed=1), 1.0, gen)  # moments and count no longer zero
    snap = {k: v.clone() for k, v in model.state_dict().items()}
    mu = {k: v.clone() for k, v in state.opt_state["mu"].items()}
    bad = _batch(seed=2)
    bad["melspec"][1, 0, 3, 5] = np.nan
    state, metrics = step(state, bad, 1.0, gen)
    assert float(metrics["skipped"]) == 1.0 and state.step == 2
    assert state.opt_state["count"] == 1
    assert all(torch.equal(v, snap[k]) for k, v in model.state_dict().items())
    assert all(torch.equal(v, mu[k]) for k, v in state.opt_state["mu"].items())
    state, metrics = step(state, _batch(seed=3), 1.0, gen)  # and training goes on
    assert float(metrics["skipped"]) == 0.0 and state.opt_state["count"] == 2


def test_ema_trails_the_updated_parameters():
    _, pcfg = _configs(ema_decay=0.5)
    model = _port_model(pcfg, _variables(1, 0))
    state = ts.create_train_state(model, pcfg)
    old = {k: v.clone() for k, v in state.ema_params.items()}
    state, _ = ts.make_train_step(model, pcfg)(state, _batch(), 1.0,
                                               torch.Generator().manual_seed(0))
    for name, p in model.named_parameters():
        torch.testing.assert_close(state.ema_params[name], 0.5 * old[name] + 0.5 * p.detach(),
                                   rtol=1e-6, atol=1e-7)
    assert state.eval_params is state.ema_params
    metrics = ts.make_eval_step(model, pcfg)(state, {k: v[0] for k, v in _batch().items()})
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_accumulation_is_the_mean_of_the_micro_batch_gradients(both):
    _, pcfg, variables = both[:3]
    batch = _batch(seed=4)
    singles = []
    for i in range(K):
        model = _port_model(pcfg, variables)
        ts._micro_loss(model, pcfg, ts._to_device(batch, "cpu", i), 1.0, [0, 0, 0], False)
        singles.append({n: p.grad.clone() for n, p in model.named_parameters()})

    seen = {}

    class Recorder(ts.AdamNoam):
        def apply_(self, params, grads, state, grad_norm):
            seen.update({k: v.clone() for k, v in grads.items()}, norm=grad_norm)

    model = _port_model(pcfg, variables)
    opt = Recorder(pcfg.model.d_model, 10, 1.0, 0.0)
    state = ts.create_train_state(model, pcfg, opt)
    _, metrics = ts.make_train_step(model, pcfg, opt, scheduled_sampling=False)(
        state, batch, 1.0, torch.Generator().manual_seed(0))
    norm = seen.pop("norm")
    for name, g in seen.items():
        torch.testing.assert_close(g, (singles[0][name] + singles[1][name]) / 2,
                                   rtol=1e-5, atol=1e-7)
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in seen.values())))
    assert abs(norm - total) <= 1e-5 * total and abs(float(metrics["grad_norm"]) - total) <= 1e-5 * total


def test_eval_step_matches_jax(both):
    jcfg, pcfg, variables, jmodel, _, jstate = both
    batch = {k: v[0] for k, v in _batch(seed=5).items()}
    ref = jax_ts.make_eval_step(jmodel, jcfg)(jstate, batch)
    model = _port_model(pcfg, variables)
    ours = ts.make_eval_step(model, pcfg)(ts.create_train_state(model, pcfg), batch)
    assert set(ours) == set(ref)
    for name in ref:
        _close(ours[name], ref[name], 1e-4, 1.0, f"eval {name}")


def test_dropout_on_runs_and_is_reproducible_from_its_generator_seed():
    _, pcfg = _configs(dropout_off=False)
    variables = _variables(1, 0)
    results = []
    for seed in (7, 7, 8):
        model = _port_model(pcfg, variables)
        state = ts.create_train_state(model, pcfg)
        _, metrics, mixed = ts.make_train_step(model, pcfg, return_mixed_inputs=True)(
            state, _batch(seed=6), 0.5, torch.Generator().manual_seed(seed))
        assert float(metrics["skipped"]) == 0.0 and np.isfinite(float(metrics["grad_norm"]))
        assert mixed.shape == (B, TM, 80)
        results.append((float(metrics["total"]), model.state_dict()))
    assert results[0][0] == results[1][0]
    assert all(torch.equal(v, results[1][1][k]) for k, v in results[0][1].items())
    assert results[0][0] != results[2][0]


def test_fused_ffn_flag_routes_through_op():
    """The flag builds a model whose feed-forward blocks go through
    ``ops.fused_ffn``, the factory passes it on, and with dropout off the step
    computes what the plain blocks do (the port against itself; against the
    JAX package: ``test_torch_fused_ffn.py``)."""
    _, pcfg = _configs()
    ffn_cfg = pcfg.replace(runtime=dataclasses.replace(pcfg.runtime, use_pallas_fused_ffn=True))
    assert runtime_model_kwargs(ffn_cfg, device="cpu")["use_fused_ffn"] is True
    assert runtime_model_kwargs(pcfg, device="cpu")["use_fused_ffn"] is False
    variables = _variables(1, 0)
    losses = []
    for cfg in (pcfg, ffn_cfg):
        model = _port_model(cfg, variables)
        assert model.encoder.layer_0.ffn.use_fused is cfg.runtime.use_pallas_fused_ffn
        state = ts.create_train_state(model, cfg)
        _, metrics = ts.make_train_step(model, cfg)(state, _batch(seed=6), 1.0,
                                                    torch.Generator().manual_seed(0))
        losses.append({k: float(v) for k, v in metrics.items()})
    for name in ("total", "grad_norm"):
        assert abs(losses[0][name] - losses[1][name]) <= 1e-5 * abs(losses[0][name])


# the id this test had while the flag still raised; it goes on being collected
test_fused_ffn_is_not_ported_yet = test_fused_ffn_flag_routes_through_op
