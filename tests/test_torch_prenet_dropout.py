"""Inference prenet dropout of the port (``runtime.infer_prenet_dropout``)
against the JAX package's ``infer/decode.py:_prenet_dropout_step``.

The masks differ by design: JAX draws them with ``jax.random.bernoulli``
(threefry or rbg), the port with the counter hash the decode-step kernel
computes (``ops.decode_step.prenet_keep``).  So the arithmetic is held
against JAX with JAX's own masks, fed to the port's plain prenet: fp32,
max|port - jax| <= 1e-5 * max(1, max|jax|) (two small products and a PE
add; the port multiplies by the fp32 ``1 / (1 - rate)`` where JAX divides).
The hash masks are checked for their keep rate and for not depending on
how the batch is cut into row chunks; the kernel loop (the kernel's plain
version on the CPU) against the plain loop at rate 0.5, W 0 and 2, within
``tests/test_torch_decode.py``'s 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import assert_close, configs, jax_model_and_variables, port_model
from transformertts_tpu.infer.decode import _prenet_dropout_step
from transformertts_tpu.models.modules import sinusoid_table
from transformertts_tpu_torch.infer import decode as decode_mod
from transformertts_tpu_torch.infer.decode import make_decode_fn, prenet_dropout_step, prenet_seed
from transformertts_tpu_torch.ops.decode_step import (
    decode_step_reference,
    pack_decode_weights,
    prenet_drop_args,
    prenet_keep,
)

TOL = 1e-4


def _model(**runtime):
    jcfg, pcfg = configs(**runtime)
    _, variables = jax_model_and_variables(jcfg)
    return jcfg, pcfg, variables, port_model(pcfg, variables)


@pytest.fixture
def prng_impl(request):
    before = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", request.param)
    yield request.param
    jax.config.update("jax_default_prng_impl", before)


@pytest.mark.parametrize("prng_impl", ["threefry2x32", "rbg"], indirect=True)
def test_prenet_with_jax_masks_matches_jax(prng_impl):
    jcfg, pcfg, variables, model = _model()
    rate, b, d = 0.5, 3, pcfg.model.d_model
    seed = prenet_seed(pcfg)
    key = jax.random.PRNGKey(jcfg.training.seed ^ 0x5EED)
    pe_table = jnp.asarray(sinusoid_table(jcfg.model.max_len, d))
    frame = np.random.default_rng(0).standard_normal((b, 1, 80)).astype(np.float32)
    for t in (0, 7):
        ref = _prenet_dropout_step(variables["params"], jnp.asarray(frame), t, rate, key,
                                   pe_table, jnp.float32)
        keep = np.stack([np.asarray(jax.random.bernoulli(
            jax.random.fold_in(key, 2 * t + i), 1.0 - rate, (b, 1, d))) for i in range(2)])
        with torch.no_grad():
            ours = prenet_dropout_step(model, torch.from_numpy(frame), t, rate, seed,
                                       keep=torch.from_numpy(keep))
        assert_close(ours, np.asarray(ref), 1e-5, f"t={t} ({prng_impl})")
        assert (np.asarray(ref) != np.asarray(_prenet_dropout_step(
            variables["params"], jnp.asarray(frame), t, 0.0, key, pe_table, jnp.float32))).any()


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_hash_masks_keep_rate_and_row_chunking(rate):
    """Over 64 steps x 2 layers x 4 rows x 128 columns (65,536 elements)
    the kept share is within 0.01 of 1 - rate (5 standard deviations at
    0.5); a batch of 10 rows cut into chunks of 8 and 2 (``row0``) drops
    what the whole batch drops; the masks differ between layers and steps."""
    seed, d = 42 ^ 0x5EED, 128
    masks = torch.stack([prenet_keep(t, i, 4, d, rate, seed) for t in range(64) for i in (0, 1)])
    assert abs(float(masks.float().mean()) - (1.0 - rate)) <= 0.01
    assert not torch.equal(masks[0], masks[1]) and not torch.equal(masks[0], masks[2])
    for t in (0, 63):
        whole = prenet_keep(t, 1, 10, d, rate, seed)
        parts = torch.cat([prenet_keep(t, 1, 8, d, rate, seed, row0=0),
                           prenet_keep(t, 1, 2, d, rate, seed, row0=8)])
        assert torch.equal(whole, parts)
    assert prenet_drop_args(0.0) == (0, 1.0) and prenet_drop_args(0.5) == (1 << 31, 2.0)
    with pytest.raises(ValueError):
        prenet_drop_args(1.0)


@pytest.mark.parametrize("window", [0, 2])
def test_kernel_loop_equals_plain_loop_with_prenet_dropout(window):
    """Rate 0.5 through both loops, B = 2 ragged, and through the kernel
    loop cut into one-row chunks: the same masks everywhere (global rows)."""
    _, pcfg, _, model = _model(decode_attn_window=window, infer_prenet_dropout=0.5)
    rng = np.random.default_rng(1)
    phoneme, lens = rng.integers(1, 60, (2, 16)), np.array([16, 11])
    outs = {}
    for name, kernel, rows in (("plain", False, 8), ("kernel", True, 8), ("chunks", True, 1)):
        cfg = pcfg.replace(runtime=dataclasses.replace(
            pcfg.runtime, decode_megakernel_max_batch=rows))
        outs[name] = make_decode_fn(model, cfg, max_len=12, stop_threshold=2.0,
                                    use_kernel=kernel, device="cpu")(phoneme, lens)
    for name in ("kernel", "chunks"):
        assert outs[name]["n_frames"] == outs["plain"]["n_frames"] == 12
        for k in ("pred_melspec", "post_melspec", "pred_stop"):
            assert_close(outs[name][k], outs["plain"][k], TOL, f"{name} {k}")
    cfg0 = pcfg.replace(runtime=dataclasses.replace(pcfg.runtime, infer_prenet_dropout=0.0))
    off = make_decode_fn(model, cfg0, max_len=12, stop_threshold=2.0, device="cpu")(
        phoneme, lens)
    assert float((off["pred_melspec"] - outs["plain"]["pred_melspec"]).abs().max()) > 1e-2


def test_rate_zero_is_todays_decode(monkeypatch):
    """At rate 0 the plain loop never takes the dropout prenet, and the
    kernel's plain version ignores seed and row0: bit for bit today's."""
    _, pcfg, _, model = _model()
    monkeypatch.setattr(decode_mod, "prenet_dropout_step", None)  # would raise if called
    rng = np.random.default_rng(2)
    phoneme, lens = rng.integers(1, 60, (2, 16)), np.array([16, 11])
    out = make_decode_fn(model, pcfg, max_len=6, stop_threshold=2.0, device="cpu")(phoneme, lens)
    assert out["n_frames"] == 6
    m = pcfg.model
    shape = (m.decoder_n_layers, m.decoder_n_head, 2, 8, m.d_model // m.decoder_n_head)
    gen = torch.Generator().manual_seed(0)
    caches = [torch.randn(shape, generator=gen) for _ in range(4)]
    args = (3, torch.randn((2, 80), generator=gen), torch.randn((1, m.d_model), generator=gen),
            torch.zeros((2, 8)), *caches, pack_decode_weights(model, torch.float32))
    for a, b in zip(decode_step_reference(*args), decode_step_reference(
            *args, prenet_dropout=0.0, seed=1234, row0=5)):
        assert torch.equal(a, b)
    dropped = decode_step_reference(*args, prenet_dropout=0.5, seed=1234, row0=5)
    assert not torch.equal(dropped[0], decode_step_reference(*args)[0])
