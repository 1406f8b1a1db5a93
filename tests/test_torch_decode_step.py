"""The port's plain decode step vs the JAX decode-step kernels (interpret mode).

``decode_step_reference`` is what the CUDA kernel is held against on the
card; here it is held against the TPU kernels themselves, run as the JAX
package's tests run them on the CPU: ``decode_step(..., interpret=True)``
for B = 1 and ``decode_step_batched(..., interpret=True)`` for B = 3.
Both sides get the same numpy-seeded frame, PE row, ragged cross bias and
caches, and the same weights: the JAX packing (``pack_decode_weights``,
``expand_cross_bias``) from the flax params, the port's packing from the
port model the params were converted into.

Tolerances, as max|port - jax| <= tol * max(1, max|jax|): fp32 1e-5
(summation order only); bf16 2e-2 (one bf16 ulp is 2^-8 relative, and a
rounding that flips at a different place compounds over three layers).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import assert_close, configs, jax_model_and_variables, port_model
from transformertts_tpu.ops.pallas.decode_step import (
    decode_step as jax_decode_step,
    decode_step_batched as jax_decode_step_batched,
    expand_cross_bias,
    pack_decode_weights as jax_pack,
)
from transformertts_tpu_torch.models.masks import NEG_INF
from transformertts_tpu_torch.ops.decode_step import (
    _check_cuda_args,
    decode_step,
    decode_step_reference,
    pack_decode_weights,
)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
N_POS, TP, T = 12, 10, 5


def _case(b, dtype, seed=0):
    jcfg, pcfg = configs()
    _, variables = jax_model_and_variables(jcfg)
    model = port_model(pcfg, variables)
    m = pcfg.model
    L, H, dh = m.decoder_n_layers, m.decoder_n_head, m.d_model // m.decoder_n_head
    rng = np.random.default_rng(seed)
    f32 = np.float32
    frame = rng.standard_normal((b, m.n_mels)).astype(f32)
    pe_row = (0.5 * rng.standard_normal((1, m.d_model))).astype(f32)
    lens = np.array([TP, 7, 4][:b])
    bias = np.where(np.arange(TP)[None, :] < lens[:, None], 0.0, NEG_INF).astype(f32)
    caches = [rng.standard_normal((L, H, b, n, dh)).astype(f32) for n in (N_POS, N_POS, TP, TP)]
    return jcfg, variables, model, frame, pe_row, bias, caches


@pytest.mark.parametrize("dtype,with_attn_pos", [
    ("float32", False), ("float32", True), ("bfloat16", True),
])
@pytest.mark.parametrize("b", [1, 3])
def test_reference_matches_jax_kernel(b, dtype, with_attn_pos):
    jcfg, variables, model, frame, pe_row, bias, caches = _case(b, dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jpacked = jax_pack(variables["params"], jcfg, dtype=jdt)
    jc = [jnp.asarray(c, jdt) for c in caches]
    t = jnp.asarray(T, jnp.int32)
    if b == 1:  # the batch-1 kernel takes (L, H, T, dh) caches
        step = jax.jit(functools.partial(
            jax_decode_step, interpret=True, with_attn_pos=with_attn_pos))
        ref = step(t, frame, pe_row, bias, *[c[:, :, 0] for c in jc], jpacked)
        ref = [ref[0], ref[1][:, :, :1], ref[2][:, :, :1]] + list(ref[3:])
    else:
        step = jax.jit(functools.partial(
            jax_decode_step_batched, interpret=True, with_attn_pos=with_attn_pos))
        ref = step(t, frame, pe_row, expand_cross_bias(jnp.asarray(bias)), *jc, jpacked)
    packed = pack_decode_weights(model, tdt)
    tc = [torch.from_numpy(c).to(tdt) for c in caches]
    out = decode_step_reference(T, torch.from_numpy(frame), torch.from_numpy(pe_row),
                                torch.from_numpy(bias), *tc, packed, with_attn_pos)
    assert len(out) == len(ref) == (4 if with_attn_pos else 3)
    for name, o, r in zip(("y", "k_new", "v_new", "pos"), out, ref):
        assert_close(o, np.asarray(r, np.float32), TOL[dtype], name)


def test_wrapper_writes_cache_on_cpu():
    """On CPU tensors the wrapper runs the plain version, writes the new
    rows into the caches at t and counts no kernel launch."""
    _, _, model, frame, pe_row, bias, caches = _case(3, "float32")
    packed = pack_decode_weights(model, torch.float32)
    tc = [torch.from_numpy(c) for c in caches]
    before = [c.clone() for c in tc]
    launches = decode_step.launches
    args = (torch.from_numpy(frame), torch.from_numpy(pe_row), torch.from_numpy(bias))
    y, k_new, v_new = decode_step(T, *args, *tc, packed)
    y_ref, k_ref, v_ref = decode_step_reference(T, *args, *before, packed)
    assert decode_step.launches == launches
    assert torch.equal(y, y_ref) and torch.equal(k_new, k_ref) and torch.equal(v_new, v_ref)
    assert torch.equal(tc[0][:, :, :, T], k_new) and torch.equal(tc[1][:, :, :, T], v_new)
    keep = torch.arange(N_POS) != T
    assert torch.equal(tc[0][:, :, :, keep], before[0][:, :, :, keep])
    with pytest.raises(ValueError, match="outside the cache"):
        decode_step(N_POS, *args, *tc, packed)


def test_kernel_argument_checks():
    """What the CUDA wrapper refuses before it hands pointers to the kernel:
    a packed weight of the wrong shape or dtype, a non-contiguous cache,
    too large a batch — and, all else right, tensors that are not on CUDA."""
    _, _, model, frame, pe_row, bias, caches = _case(3, "float32")
    packed = pack_decode_weights(model, torch.float32)
    tc = [torch.from_numpy(c) for c in caches]
    args = (torch.from_numpy(frame), torch.from_numpy(pe_row), torch.from_numpy(bias))
    bad = dict(packed, W2=packed["W2"][:1])
    with pytest.raises(ValueError, match="W2 must be"):
        _check_cuda_args(*args, *tc, bad)
    bad = dict(packed, ln_g=packed["ln_g"].to(torch.bfloat16))
    with pytest.raises(ValueError, match="ln_g must be"):
        _check_cuda_args(*args, *tc, bad)
    with pytest.raises(ValueError, match="self_k must be"):
        _check_cuda_args(*args, tc[0].transpose(3, 4).contiguous().transpose(3, 4), *tc[1:], packed)
    big = [c.repeat(1, 1, 3, 1, 1) for c in tc]  # B = 9
    with pytest.raises(ValueError, match="1 <= B <= 8"):
        _check_cuda_args(args[0].repeat(3, 1), args[1], args[2].repeat(3, 1), *big, packed)
    with pytest.raises(ValueError, match="is on cpu"):
        _check_cuda_args(*args, *tc, packed)
