"""PyTorch port vs JAX package: flash attention, forward and dQ/dK/dV.

The same numpy-seeded inputs and the same int32 seed go through the JAX
``flash_attention._flash`` (Pallas, ``interpret=True``) and the port's
``flash_attention`` on the CPU (its plain version, which mirrors the
kernel's casts).  With dropout on, agreement means both drop the same
elements, so the dropout cases use more than one q-block: the JAX side is
given a q-block through ``TTS_FLASH_BLOCK_Q`` and the port the same
``block_q`` as an argument.

Tolerances, as max|port - jax| <= tol * max(1, max|jax|):
- fp32: 1e-5 forward, 1e-4 gradients (same arithmetic, other summation
  order);
- bf16: 2e-2 forward and gradients (both sides round the same quantities to
  bf16, but a different fp32 summation order moves single values across a
  rounding boundary, one bf16 ulp = 2^-8 relative, before they are summed
  again).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import assert_close
from transformertts_tpu_torch.models.masks import NEG_INF
from transformertts_tpu_torch.ops.flash_attention import flash_attention, pick_block

# the package re-exports the function under the module's name
jax_flash = importlib.import_module("transformertts_tpu.ops.pallas.flash_attention")
FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _case(b, h, tq, tk, d, dtype, lens, seed=0):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, t, h, d)).astype(np.float32) for t in (tq, tk, tk)]
    dout = rng.standard_normal((b, tq, h, d)).astype(np.float32)
    bias = np.where(np.arange(tk)[None, :] < np.asarray(lens)[:, None], 0.0, NEG_INF)
    return arrs, dout, bias.astype(np.float32)


def _run_both(arrs, dout, bias, dtype, causal, dropout, seed, block_q=None):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    d = arrs[0].shape[-1]
    # JAX kernel layout (B, H, T, D)
    jq, jk, jv = (jnp.asarray(a.transpose(0, 2, 1, 3), jd) for a in arrs)
    jseed = jnp.array([seed], jnp.int32)

    def f(q_, k_, v_):
        return jax_flash._flash(q_, k_, v_, jnp.asarray(bias), jseed, d ** -0.5, causal,
                                float(dropout), True)

    ref, vjp = jax.vjp(f, jq, jk, jv)
    ref_grads = vjp(jnp.asarray(dout.transpose(0, 2, 1, 3), jd))

    q, k, v = (torch.tensor(a).to(td).requires_grad_(True) for a in arrs)
    out = flash_attention(q, k, v, torch.tensor(bias), causal=causal, dropout=dropout,
                          seed=seed, block_q=block_q)
    out.backward(torch.tensor(dout).to(td))
    assert out.dtype == td and out.shape == q.shape
    tr = lambda a: np.asarray(a, np.float32).transpose(0, 2, 1, 3)  # noqa: E731
    return (out.detach(), (q.grad, k.grad, v.grad)), (tr(ref), [tr(g) for g in ref_grads])


def _compare(port, ref, dtype, what):
    assert_close(port[0], ref[0], FWD_TOL[dtype], f"{what} out")
    for name, g, r in zip(("dq", "dk", "dv"), port[1], ref[1]):
        assert_close(g, r, GRAD_TOL[dtype], f"{what} {name}")


@pytest.mark.parametrize("t,tk", [(128, 128), (768, 768), (768, 128), (2048, 512), (5, 37),
                                  (96, 40)])
def test_pick_block_matches_jax(t, tk, monkeypatch):
    monkeypatch.delenv("TTS_FLASH_BLOCK_Q", raising=False)
    assert pick_block(t, tk) == jax_flash._pick_block(t, tk)


# (causal, Tq, Tk, key lengths): "padded" leaves whole 64-key tiles padded in
# two batch rows (keys 70.. and 1..) while the first row is live throughout,
# the case in which the CUDA kernels skip key tiles
ATTN_CASES = [(True, 64, 64, None), (False, 64, 64, None), (False, 48, 24, None),
              (False, 40, 200, (200, 70, 1)), (True, 200, 200, (200, 70, 1))]
ATTN_IDS = ["True-64-64", "False-64-64", "False-48-24", "False-40-200-padded",
            "True-200-200-padded"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,tq,tk,lens", ATTN_CASES, ids=ATTN_IDS)
def test_matches_jax_without_dropout(dtype, causal, tq, tk, lens, monkeypatch):
    monkeypatch.delenv("TTS_FLASH_BLOCK_Q", raising=False)
    lens = lens or (tk, tk - 7)
    arrs, dout, bias = _case(len(lens), 2, tq, tk, 64, dtype, lens=lens)
    port, ref = _run_both(arrs, dout, bias, dtype, causal, 0.0, seed=0)
    _compare(port, ref, dtype, f"causal={causal} ({tq},{tk}) lens={lens}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,lens", [(True, None), (False, None), (False, (200, 70, 1))],
                         ids=["True", "False", "False-padded"])
def test_matches_jax_with_dropout_over_several_q_blocks(dtype, causal, lens, monkeypatch):
    """4 q-blocks of 16 rows: the salt (bh * 8192 + q-block) and the counter
    (local row * Tk + col) must both follow the TPU kernel's geometry; with
    ``lens`` over 200 keys, of which whole 64-key tiles are padded in two rows."""
    monkeypatch.setenv("TTS_FLASH_BLOCK_Q", "16")
    tq, tk = 64, (lens[0] if lens else 40) if not causal else 64
    assert jax_flash._pick_block(tq, tk) == 16
    lens = lens or (tk, tk - 9)
    arrs, dout, bias = _case(len(lens), 2, tq, tk, 64, dtype, lens=lens, seed=1)
    port, ref = _run_both(arrs, dout, bias, dtype, causal, 0.1, seed=987654321, block_q=16)
    _compare(port, ref, dtype, f"dropout causal={causal}")
    # with the wrong geometry the port drops other elements
    q, k, v = (torch.tensor(a) for a in arrs)
    wrong = flash_attention(q, k, v, torch.tensor(bias), causal=causal, dropout=0.1,
                            seed=987654321, block_q=32)
    assert float((wrong - port[0].float()).abs().max()) > 1e-3


def test_default_block_q_is_the_tpu_kernels(monkeypatch):
    """(2048, 512): the TPU kernel picks 2 q-blocks of 1024 on its own."""
    monkeypatch.delenv("TTS_FLASH_BLOCK_Q", raising=False)
    assert jax_flash._pick_block(2048, 512) == 1024
    arrs, dout, bias = _case(1, 1, 2048, 512, 8, "float32", lens=[500], seed=2)
    port, ref = _run_both(arrs, dout, bias, "float32", False, 0.1, seed=77)
    _compare(port, ref, "float32", "(2048, 512)")


def test_fully_padded_row_is_uniform_not_nan(monkeypatch):
    monkeypatch.delenv("TTS_FLASH_BLOCK_Q", raising=False)
    arrs, dout, bias = _case(2, 2, 16, 24, 64, "float32", lens=[24, 0], seed=3)
    port, ref = _run_both(arrs, dout, bias, "float32", False, 0.0, seed=0)
    _compare(port, ref, "float32", "fully padded")
    assert torch.isfinite(port[0]).all()
    mean_v = torch.tensor(arrs[2][1]).mean(dim=0)  # (H, D): uniform weights over all keys
    assert_close(port[0][1, 0], mean_v.numpy(), 1e-5, "uniform row")


@pytest.mark.parametrize("d", [24, 128])
def test_head_dims_whose_scale_is_not_a_power_of_two(d, monkeypatch):
    """The scale then stays on the fp32 scores instead of riding on Q."""
    monkeypatch.delenv("TTS_FLASH_BLOCK_Q", raising=False)
    for dtype in ("float32", "bfloat16"):
        arrs, dout, bias = _case(1, 2, 32, 32, d, dtype, lens=[29], seed=4)
        port, ref = _run_both(arrs, dout, bias, dtype, True, 0.0, seed=0)
        _compare(port, ref, dtype, f"d={d}")


def test_no_key_bias_and_no_kernel_launch_on_cpu():
    arrs, _, _ = _case(1, 1, 8, 8, 64, "float32", lens=[8], seed=5)
    q, k, v = (torch.tensor(a) for a in arrs)
    a = flash_attention(q, k, v)
    b = flash_attention(q, k, v, torch.zeros(1, 8))
    assert torch.equal(a, b)
    assert flash_attention.launches_fwd == 0 and flash_attention.launches_bwd == 0
