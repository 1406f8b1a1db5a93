"""PyTorch port vs JAX package: fused residual + dropout + LayerNorm.

The same numpy-seeded inputs and the same int32 seed go through the JAX
``fused_ln._fused`` (Pallas, ``interpret=True``) and the port's
``residual_dropout_layernorm`` on the CPU (its plain version), forward and
all four gradients.  With dropout on, agreement means both drop the same
elements: N is chosen so that the TPU kernel's row block (``_pick_rows``)
is smaller than N and the mask geometry is exercised.

Tolerances, as max|port - jax| <= tol * max(1, max|jax|):
- fp32: 1e-5 forward, 1e-4 gradients (same arithmetic; the reductions run
  in another order, and dgamma / dbeta sum over all N rows);
- bf16: 2e-2 (the fp32 results are rounded once to bf16, and a different
  summation order moves a value across a rounding boundary: one bf16 ulp,
  2^-8 relative, on values up to ~4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import assert_close
from transformertts_tpu.ops.pallas import fused_ln as jax_ln
from transformertts_tpu_torch.ops import fused_ln
from transformertts_tpu_torch.ops.fused_ln import pick_rows, residual_dropout_layernorm

FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _inputs(n, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    h = (0.5 * rng.standard_normal((n, d))).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal((n, d)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx = [jnp.asarray(a, jd) for a in (x, h)] + [jnp.asarray(gamma), jnp.asarray(beta)]
    tx = [torch.tensor(a).to(td) for a in (x, h)] + [torch.tensor(gamma), torch.tensor(beta)]
    return jx, tx, jnp.asarray(dy, jd), torch.tensor(dy).to(td)


@pytest.mark.parametrize("n,d", [(1024, 128), (96, 64), (1000, 256)])
def test_pick_rows_matches_jax(n, d):
    assert pick_rows(n, d) == jax_ln._pick_rows(n, d)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("n,d", [
    (1024, 128), (24, 96),
    # the backward kernel's grids: a ragged last run of rows, and the encoder's shape
    (1000, 256), (2048, 256),
])
def test_forward_and_gradients_match_jax(n, d, dropout, dtype):
    seed = 1234567
    (jx, jh, jg, jb), (x, h, g, b), jdy, dy = _inputs(n, d, dtype)
    if dropout:
        assert jax_ln._pick_rows(n, d) < n  # more than one mask block
    jseed = jnp.array([seed], jnp.int32)

    def f(x_, h_, g_, b_):
        return jax_ln._fused(x_, h_, g_, b_, jseed, dropout, 1e-5, True)

    ref, vjp = jax.vjp(f, jx, jh, jg, jb)
    ref_grads = vjp(jdy)

    for t in (x, h, g, b):
        t.requires_grad_(True)
    out = residual_dropout_layernorm(x, h, g, b, dropout=dropout, seed=seed)
    assert out.dtype == x.dtype
    assert_close(out.detach(), np.asarray(ref, np.float32), FWD_TOL[dtype], "y")
    out.backward(dy)
    for name, t, r in zip(("dx", "dh", "dgamma", "dbeta"), (x, h, g, b), ref_grads):
        assert t.grad.dtype == t.dtype
        assert_close(t.grad, np.asarray(r, np.float32), GRAD_TOL[dtype], name)
    assert residual_dropout_layernorm.launches_fwd == 0  # the CPU never launches


def test_dropout_drops_the_same_elements_as_jax():
    """Where h dominates, a dropped element shows directly in z: compare the
    pattern, not just the values."""
    n, d, seed, p = 1024, 128, 42, 0.5
    x = np.zeros((n, d), np.float32)
    h = np.ones((n, d), np.float32)
    one, zero = np.ones(d, np.float32), np.zeros(d, np.float32)
    ref = jax_ln._fused(jnp.asarray(x), jnp.asarray(h), jnp.asarray(one), jnp.asarray(zero),
                        jnp.array([seed], jnp.int32), p, 1e-5, True)
    out = residual_dropout_layernorm(torch.tensor(x), torch.tensor(h), torch.tensor(one),
                                     torch.tensor(zero), dropout=p, seed=seed)
    np.testing.assert_array_equal(out.numpy() > 0, np.asarray(ref) > 0)
    assert 0.4 < float((out > 0).float().mean()) < 0.6


def test_leading_axes_and_mask_rows_argument():
    (_, _, _, _), (x, h, g, b), _, _ = _inputs(64, 32, "float32", seed=3)
    flat = residual_dropout_layernorm(x, h, g, b, dropout=0.2, seed=9, mask_rows=16)
    shaped = residual_dropout_layernorm(x.reshape(4, 16, 32), h.reshape(4, 16, 32), g, b,
                                        dropout=0.2, seed=9, mask_rows=16)
    assert torch.equal(flat, shaped.reshape(64, 32))
    other = residual_dropout_layernorm(x, h, g, b, dropout=0.2, seed=9, mask_rows=64)
    assert not torch.equal(flat, other)  # the block height is part of the mask


@pytest.mark.parametrize("n", [1, 24, 1000, 2048, 12288, 10**6])
def test_backward_grid_and_scratch(n):
    """One launch: about 8 rows a block up to two blocks on each of 132 SMs,
    and scratch for a partial per block and per group of 16 blocks."""
    blocks = fused_ln.bwd_blocks(n)
    assert 1 <= blocks <= min(n, 264)
    assert blocks == min(-(-n // 8), 264)
    assert fused_ln.bwd_scratch_floats(n, 256) == (blocks + -(-blocks // 16)) * 2 * 256


def test_ticket_counters_are_zeros_kept_per_device_and_stream():
    a = fused_ln.ticket_counters(torch.device("cpu"), 7)
    assert a.dtype == torch.int32 and not a.any()
    assert len(a) >= 1 + -(-528 // 16)  # the groups of the kernel's largest grid, and one
    assert fused_ln.ticket_counters(torch.device("cpu"), 7) is a
    assert fused_ln.ticket_counters(torch.device("cpu"), 8) is not a
