"""The port's speculative chunk-verify decode vs the JAX package's.

- One verify pass: ``decode_verify_reference`` (the verify kernel's plain
  version) on the same drafted frames, cache prefix and weights, at t = 0
  and t = 5, K = 2 and 4.  Tolerance as max|port - jax| <= tol * max(1,
  max|jax|).  fp32, 1e-5: against one JAX chunk pass built from the bound
  JAX model (``prenet_step`` over K positions, ``project_self_kv`` into the
  cache, ``cached_step`` with the per-row causal bias,
  ``decode_frame_heads``); the same math, the kernel's form folding the
  chunk's own positions in closed form where JAX reads them back from the
  cache, so only the summation order differs.  bf16, 2e-2: against the JAX
  package's decode-step kernel (interpret mode) called once per row, whose
  roundings the verify kernel follows (flax's bf16 modules round elsewhere:
  row 0, a plain step, is 2.45e-2 from the bf16 chunk pass at one of these
  seeds); the kernel's form keeps the chunk's own k, v and exponentials in
  fp32 where the steps round them to bf16: one bf16 ulp, 2^-8 relative, on
  a few terms.
- The whole decode at B = 1: the port's ``make_decode_fn`` through both
  loops (the plain chunk loop and the kernel loop, whose verify wrapper
  runs its plain version on CPU tensors) against JAX ``make_decode_fn``
  (its XLA ``_speculative_decode``), r = 1 and 2, drafts "linear" and
  "hold", tau = 0 (every draft rejected) and 1e9 (every draft accepted):
  equal ``n_verify_passes`` and ``n_frames``, frames within 1e-4 fp32 as
  ``tests/test_torch_decode.py`` (frames are fed back, so per-pass
  summation-order differences grow over the passes); the stop path at
  threshold 0.45.
- B = 2 falls through to the decode without speculation; the options that
  do not combine with it and a cache past the PE table raise.
- The verify kernel's plan (pure Python): it fits a block at ``Config()``
  widths for K <= 8 and at ``configs/paper.yaml`` widths for K <= 4, and
  raises at ``paper.yaml`` with K = 8.
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import assert_close, configs, jax_model_and_variables, port_model
from transformertts_tpu.infer.decode import make_decode_fn as jax_make_decode_fn
from transformertts_tpu.models.masks import NEG_INF as JAX_NEG_INF
from transformertts_tpu.models.masks import padding_bias as jax_padding_bias
from transformertts_tpu.ops.pallas.decode_step import decode_step as jax_decode_step
from transformertts_tpu.ops.pallas.decode_step import pack_decode_weights as jax_pack
from transformertts_tpu_torch.config import Config, load_config
from transformertts_tpu_torch.infer.decode import make_decode_fn
from transformertts_tpu_torch.models.modules import sinusoid_table
from transformertts_tpu_torch.ops.decode_step import (
    CLUSTER,
    VERIFY_BUFFERS,
    decode_verify_reference,
    pack_decode_weights,
    pack_verify_weights,
    verify_chunks,
    verify_launch_config,
    verify_plan,
)

PASS_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOL = 1e-4
GROUPS = 12  # decoder positions when the stop never fires
TP = 16


def _inputs(b):
    rng = np.random.default_rng(b)
    phoneme = rng.integers(1, 60, (b, TP)).astype(np.int32)
    lens = np.array([TP, 11][:b], np.int32)
    return phoneme, lens


def _spec(r=1, k=4, tau=0.15, draft="linear", **runtime):
    return configs(r, decode_speculative_k=k, decode_speculative_tau=tau,
                   decode_speculative_draft=draft, **runtime)


# ------------------------------------------------------------ one verify pass

def _jax_pass(jmodel, variables, t, k, drafts, self_k, self_v):
    """One JAX chunk pass at position t over the K drafted inputs, the
    caches (L, 1, cap, H, dh) holding the prefix: (mel (K, r n_mels), stop
    (K, r), per layer (k_new, v_new) (K, H, dh), per layer the cross K/V
    (1, Tp, H, dh))."""
    bound = jmodel.bind(variables)
    phoneme, lens = _inputs(1)
    memory = bound.encode(jnp.asarray(phoneme), None, train=False)
    cross_kv = bound.build_cross_cache(memory)
    cross_bias = jax_padding_bias(jnp.asarray(lens), TP)
    cap = self_k.shape[2]
    bias = jnp.where(jnp.arange(cap)[None, :] <= t + jnp.arange(k)[:, None], 0.0,
                     JAX_NEG_INF)[None, None]
    x = bound.prenet_step(jnp.asarray(drafts)[None], t)
    self_k, self_v = jnp.asarray(self_k), jnp.asarray(self_v)
    fresh = []
    for li, layer in enumerate(bound.decoder.layers):
        k_new, v_new = layer.project_self_kv(x)
        fresh.append((k_new, v_new))
        self_k = jax.lax.dynamic_update_slice(self_k, k_new[None].astype(self_k.dtype),
                                              (li, 0, t, 0, 0))
        self_v = jax.lax.dynamic_update_slice(self_v, v_new[None].astype(self_v.dtype),
                                              (li, 0, t, 0, 0))
        ck, cv = cross_kv[li]
        x = layer.cached_step(x, self_k[li], self_v[li], ck, cv, bias, cross_bias)
    mel, stop = bound.decode_frame_heads(x)
    r = jmodel.cfg.reduction_factor
    f32 = lambda a: a.astype(jnp.float32)  # noqa: E731
    return (f32(mel).reshape(k, -1), f32(stop).reshape(k, r),
            [tuple(f32(a[0]) for a in kv) for kv in fresh],
            [tuple(f32(a) for a in kv) for kv in cross_kv])


@functools.lru_cache(maxsize=None)
def _jax_chunk_fn(dtype, k):
    """The JAX chunk pass, jitted once per (dtype, K) with t traced."""
    jcfg, _ = configs()
    jmodel, _ = jax_model_and_variables(jcfg, getattr(jnp, dtype))
    return jax.jit(lambda variables, t, drafts, sk, sv: _jax_pass(
        jmodel, variables, t, k, drafts, sk, sv))


def _jax_rows_by_step(t, drafts, pe_rows, cross_bias, prefix, cross, dtype):
    """The K rows as K calls of the JAX package's decode-step kernel
    (``ops/pallas/decode_step.py:decode_step``, interpret mode): row j at
    position t + j with the cache rows t .. t + j - 1 the calls before wrote
    -- the numerics the verify kernel follows.  (y (K, d_out), k_new, v_new
    (L, H, K, dh))."""
    jcfg, _ = configs()
    _, variables = jax_model_and_variables(jcfg)
    jdt = getattr(jnp, dtype)
    packed = jax_pack(variables["params"], jcfg, dtype=jdt)
    step = _pallas_step()
    sk, sv = (jnp.asarray(np.ascontiguousarray(a[:, 0].transpose(0, 2, 1, 3)), jdt)
              for a in prefix)  # (L, 1, T, H, dh) -> (L, H, T, dh)
    ck, cv = (jnp.asarray(np.stack(a).transpose(0, 3, 1, 2, 4)[:, :, 0], jdt) for a in zip(*cross))
    ys, kns, vns = [], [], []
    for j in range(drafts.shape[0]):
        y, kn, vn = step(jnp.asarray(t + j, jnp.int32), drafts[j:j + 1], pe_rows[j:j + 1],
                         cross_bias, sk, sv, ck, cv, packed)
        sk, sv = sk.at[:, :, t + j].set(kn[:, :, 0]), sv.at[:, :, t + j].set(vn[:, :, 0])
        ys.append(np.asarray(y, np.float32))
        kns.append(np.asarray(kn[:, :, 0], np.float32))
        vns.append(np.asarray(vn[:, :, 0], np.float32))
    return np.concatenate(ys), np.stack(kns, 2), np.stack(vns, 2)


@functools.lru_cache(maxsize=None)
def _pallas_step():
    return jax.jit(functools.partial(jax_decode_step, interpret=True))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("t", [0, 5])
def test_verify_pass_matches_jax(t, k, dtype):
    """fp32 against the JAX chunk pass, bf16 against the JAX decode-step
    kernel row by row (the module docstring says why)."""
    jcfg, pcfg = configs()
    model = port_model(pcfg, jax_model_and_variables(jcfg)[1], getattr(torch, dtype))
    m = pcfg.model
    n_layers, n_heads, dh = m.decoder_n_layers, m.decoder_n_head, m.d_model // m.decoder_n_head
    cap = GROUPS + k
    rng = np.random.default_rng(100 * t + k)
    drafts = rng.standard_normal((k, m.n_mels)).astype(np.float32)
    prefix = np.zeros((2, n_layers, 1, cap, n_heads, dh), np.float32)
    prefix[:, :, :, :t] = rng.standard_normal((2, n_layers, 1, t, n_heads, dh))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    mel, stop, fresh, cross = _jax_chunk_fn(dtype, k)(
        jax_model_and_variables(jcfg)[1], jnp.asarray(t, jnp.int32), drafts,
        prefix[0].astype(jdt), prefix[1].astype(jdt))

    def kernel_layout(a):  # (L, 1, T, H, dh) -> (L, H, 1, T, dh)
        return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2, 4).to(tdt)

    cross_k = kernel_layout(np.stack([c[0] for c in cross]))
    cross_v = kernel_layout(np.stack([c[1] for c in cross]))
    _, lens = _inputs(1)
    bias = np.where(np.arange(TP)[None] < lens[:, None], 0.0, JAX_NEG_INF).astype(np.float32)
    pe_rows = (float(model.pe.alpha.detach()) * sinusoid_table(t + k, m.d_model)[t:t + k]).astype(np.float32)
    y, k_new, v_new = decode_verify_reference(
        t, torch.from_numpy(drafts), torch.from_numpy(pe_rows), torch.from_numpy(bias),
        kernel_layout(prefix[0]), kernel_layout(prefix[1]), cross_k, cross_v,
        pack_decode_weights(model, tdt))
    if dtype == "bfloat16":
        y_ref, k_ref, v_ref = _jax_rows_by_step(t, drafts, pe_rows, bias, prefix,
                                                [np.asarray(c, np.float32) for c in cross], dtype)
        assert_close(y, y_ref, PASS_TOL[dtype], "y")
        assert_close(k_new, k_ref, PASS_TOL[dtype], "k_new")
        assert_close(v_new, v_ref, PASS_TOL[dtype], "v_new")
        return
    nm = m.n_mels * m.reduction_factor
    assert_close(y[:, :nm], mel, PASS_TOL[dtype], "mel")
    assert_close(y[:, nm:], stop, PASS_TOL[dtype], "stop")
    for li, (jk, jv) in enumerate(fresh):
        assert_close(k_new[li].transpose(0, 1), jk, PASS_TOL[dtype], f"k_new[{li}]")
        assert_close(v_new[li].transpose(0, 1), jv, PASS_TOL[dtype], f"v_new[{li}]")


# --------------------------------------------------------- the whole decode

@functools.lru_cache(maxsize=None)
def _jax_decode(r, tau, draft, threshold, b=1):
    jcfg, _ = _spec(r, tau=tau, draft=draft)
    model, variables = jax_model_and_variables(jcfg)
    fn = jax_make_decode_fn(model, jcfg, max_len=GROUPS * r, stop_threshold=threshold,
                            use_megakernel=False)
    return jax.device_get(fn(variables, *_inputs(b)))


def _check(r, tau, draft, threshold, use_kernel):
    ref = _jax_decode(r, tau, draft, threshold)
    jcfg, pcfg = _spec(r, tau=tau, draft=draft)
    model = port_model(pcfg, jax_model_and_variables(jcfg)[1])
    fn = make_decode_fn(model, pcfg, max_len=GROUPS * r, stop_threshold=threshold,
                        use_kernel=use_kernel, device="cpu")
    out = fn(*_inputs(1))
    assert out["n_verify_passes"] == int(ref["n_verify_passes"])
    assert out["n_steps"] == out["n_verify_passes"]
    assert out["n_frames"] == int(ref["n_frames"])
    np.testing.assert_array_equal(out["n_frames_per_row"].numpy(), ref["n_frames_per_row"])
    for key in ("pred_melspec", "post_melspec", "pred_stop"):
        assert_close(out[key], ref[key], TOL, key)
    return out, ref


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("tau", [0.0, 1e9])
@pytest.mark.parametrize("draft", ["linear", "hold"])
@pytest.mark.parametrize("r", [1, 2])
def test_speculative_decode_matches_jax(r, draft, tau, use_kernel):
    out, _ = _check(r, tau, draft, 2.0, use_kernel)
    assert out["n_frames"] == GROUPS * r
    # tau = 0 accepts nothing but the true input: one group a pass; tau = 1e9 all K
    assert out["n_verify_passes"] == (GROUPS if tau == 0.0 else -(-GROUPS // 4))


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
def test_speculative_stop_path_matches_jax(use_kernel):
    """Random-init stop logits hover near 0 (sigmoid ~0.5): threshold 0.45
    stops within the first passes, cutting the accepted run at the vote."""
    out, ref = _check(1, 1e9, "linear", 0.45, use_kernel)
    assert out["n_frames"] < GROUPS  # the test is vacuous otherwise
    assert not out["pred_melspec"][:, out["n_frames"]:].any()


def test_speculative_batch_falls_through():
    """B > 1 decodes as without speculation, and reports no verify passes."""
    jcfg, pcfg = _spec()
    model = port_model(pcfg, jax_model_and_variables(jcfg)[1])
    _, plain = configs()
    out = make_decode_fn(model, pcfg, max_len=GROUPS, stop_threshold=2.0,
                         device="cpu")(*_inputs(2))
    base = make_decode_fn(model, plain, max_len=GROUPS, stop_threshold=2.0,
                          device="cpu")(*_inputs(2))
    assert "n_verify_passes" not in out
    assert out["n_steps"] == base["n_steps"] == GROUPS
    for key in ("pred_melspec", "post_melspec", "pred_stop"):
        assert torch.equal(out[key], base[key]), key


def test_speculative_refusals():
    """Prenet dropout and the attention window do not combine with
    speculation (whatever B is); at B = 1 the chunk's PE rows must lie in
    the table."""
    jcfg, pcfg = configs()
    model = port_model(pcfg, jax_model_and_variables(jcfg)[1])
    for extra in ({"infer_prenet_dropout": 0.5}, {"decode_attn_window": 2}):
        _, cfg = _spec(**extra)
        with pytest.raises(ValueError, match="incompatible"):
            make_decode_fn(model, cfg, max_len=GROUPS, device="cpu")
    _, cfg = _spec()
    long = cfg.model.max_len  # n_pos + K - 1 past the table
    fn = make_decode_fn(model, cfg, max_len=long, stop_threshold=2.0, device="cpu")
    with pytest.raises(ValueError, match="model.max_len"):
        fn(*_inputs(1))


# ------------------------------------------------------------------ the plan

WIDTHS = {
    "config": Config().model,
    "paper": load_config(Path(__file__).resolve().parents[1] / "configs" / "paper.yaml").model,
}


def _verify_plan(widths, k, itemsize, n_pos=400, tp=64):
    m = WIDTHS[widths]
    r = m.reduction_factor
    return verify_plan(m.decoder_n_layers, m.d_model, m.decoder_d_ffn, m.n_mels,
                       m.n_mels * r + r, k, r, m.decoder_n_head, n_pos + k, tp, itemsize)


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "fp32"])
@pytest.mark.parametrize("widths,k_max", [("config", 8), ("paper", 4)])
def test_verify_plan_fits(widths, k_max, itemsize):
    for n_pos, tp in ((400, 64), (1500, 192)):
        for k in range(2, k_max + 1):
            _, pieces, layout = _verify_plan(widths, k, itemsize, n_pos, tp)
            assert layout["smem_bytes"] <= 232_448 and layout["ring_bytes"] > 0
            assert pieces.shape[1] == 16  # one cluster of 16 blocks


def test_verify_plan_refuses():
    with pytest.raises(ValueError, match="too much"):
        _verify_plan("paper", 8, 2)
    for k in (1, 9):
        with pytest.raises(ValueError, match="2 <= K"):
            _verify_plan("config", k, 2)


@pytest.mark.parametrize("k", [2, 8])
def test_verify_launch_config(k):
    """The verify kernel's ``Config`` (what ``DecodeVerify`` hands the C
    entry point, built as the step's is): one cluster of 16, B = 1 (the
    caches' one row, which every row of the pass reads), R = K, the cache's
    n_pos + K positions, the cross-attention items (head, chunk) of one row,
    the plan's sizes and tensors, the verify copy of the weights and the
    offsets of the pass's own buffers."""
    jcfg, pcfg = configs()
    packed = pack_decode_weights(port_model(pcfg, jax_model_and_variables(jcfg)[1]))
    m = pcfg.model
    n_pos, tp, r = 40, TP, m.reduction_factor
    plan = verify_plan(m.decoder_n_layers, m.d_model, m.decoder_d_ffn, m.n_mels,
                       m.n_mels * r + r, k, r, m.decoder_n_head, n_pos + k, tp, 4)
    weights = pack_verify_weights(packed)
    (stages, pieces, bias), cfg, voff = verify_launch_config(plan, packed, weights, k,
                                                             m.decoder_n_head, n_pos + k, tp)
    assert (cfg.cluster, cfg.B, cfg.R, cfg.n_pos, cfg.tp) == (CLUSTER, 1, k, n_pos + k, tp)
    assert (cfg.L, cfg.H, cfg.dh) == (m.decoder_n_layers, m.decoder_n_head,
                                      m.d_model // m.decoder_n_head)
    assert (cfg.cross_chunk, cfg.cross_nc) == verify_chunks(tp, m.decoder_n_head)
    assert (cfg.nc_max, cfg.max_keys) == (plan[2]["nc_max"], plan[2]["max_keys"])
    assert list(voff) == [plan[2][b] for b in VERIFY_BUFFERS]
    assert cfg.w[0] == weights["pw1"].data_ptr() and cfg.n_mels == m.n_mels
    assert (cfg.smem_bytes, cfg.n_bias) == (plan[2]["smem_bytes"], plan[2]["n_bias"])
    assert cfg.n_pieces == plan[1].shape[0]
    assert (cfg.stages, cfg.pieces, cfg.bias) == (stages.data_ptr(), pieces.data_ptr(),
                                                  bias.data_ptr())
    assert stages.shape == (CLUSTER, plan[0].shape[0], 4)
    assert [tuple(cfg.first_piece[g]) for g in range(CLUSTER)] == [
        tuple(int(v) for v in plan[1][0, g, :2]) for g in range(CLUSTER)]
