"""One whole decoder step as ONE hand-written persistent kernel for Hopper.

Replaces both TPU decode-step kernels of the JAX package:

- ``transformertts_tpu/ops/pallas/decode_step.py:decode_step`` (``_kernel``,
  batch 1), and
- ``decode_step_batched`` (``_kernel_batched``, B <= 8).

One code path serves 1 <= B <= 8 (the rows a cluster decodes are a
template parameter of the CUDA source, ``ops/csrc/decode_step.cu``).  The
step is

    prenet -> + alpha*PE[t] -> L x [cached self-attention, the current
    position folded in closed form -> + residual, LN1 -> cross-attention
    with an additive key bias -> + residual, LN2 -> FFN -> + residual,
    LN3] -> fused mel|stop head

with bf16 (or fp32) operands and fp32 accumulation, q scaled in fp32 then
cast, fp32 softmax and LayerNorm (``E[x^2] - mu^2`` clamped at 0), and x
cast to the compute type after each sublayer while the residual stays
fp32 — the numerics of ``_kernel``.

What bounds it on an H100: bytes, in principle.  Every step reads all
decoder weights (about 2.87 M parameters, 5.7 MB in bf16 at d_model 256,
3 layers, d_ffn 1024; 44 MB at ``configs/paper.yaml`` widths) plus, per
batch row, the caches: 1.7-2 us at 3.35 TB/s at ``Config()`` widths.  The
arithmetic (2 FLOPs per weight per row) is far below the tensor-core
roofline, so the products stay on the CUDA cores.  In practice latency
bounds it: the step is a chain of about 10 L dependent stages.

The design (the CUDA source's header has the details): one launch per
step; a cluster of 16 blocks, one per SM, decodes ``rows`` batch rows
(``rows_per_cluster``: as few as the card can hold clusters for at once);
the stages are separated by the cluster barrier and hand their outputs to
every block's shared memory directly; each block streams the weight
pieces of the columns it owns (``decode_plan``) into a shared-memory ring
with bulk asynchronous copies ahead of the chain; attention is split into
(row, head, key chunk) items over the cluster's blocks (``attn_chunks``)
and combined in chunk order, rounding each probability against the
global max as the reference does.  Everything the kernel is handed besides
pointers (plan, chunks, shared-memory layout) is computed here, where the
CPU tests reach it, memoised per shape.  ``prepare_step`` makes what a
step needs that depends only on the weights and the shapes (``StepPrep``:
the plan and its tables on the device), which a caller keeps per shape
(``infer.decode.DecodeWeights``); ``DecodeStep`` prepares a step once per
decode from it (the checks, the buffers), so that each step costs the host
one C call; ``decode_step`` keeps the function's signature and prepares
through a small cache.

What the TPU shaped and this port drops: the batched TPU kernel flattened
the caches to (L, H, B*T, dh) and scored every row against every row's
cache under a block-diagonal bias (``expand_cross_bias``); here each row
attends to its own (L, H, B, T, dh) segment and the kernel takes the
(B, Tp) cross bias directly.  The TPU's per-head weight splits on leading
dims become plain (out, in) row-major matrices, q|k|v fused into one.

The kernel writes the new K/V rows straight into the self-attention
caches at position ``t``, in place, and also returns them.  The wrapper
does the same on the CPU path, so both devices leave the caches alike.

Inference prenet dropout (``runtime.infer_prenet_dropout``, the JAX
package's ``infer/decode.py:_prenet_dropout_step``, which only its XLA loop
has): with ``prenet_dropout`` > 0 the kernel drops elements of both prenet
layers after their ReLU (and, in the second, before ``+ alpha * PE[t]``)
and scales the kept ones by ``1 / (1 - rate)``.  The keep bits come from
the counter hash of ``ops/dropout_mask.py`` (``prenet_keep``): salt
``2 t + layer``, counter ``row * d_model + column`` with ``row`` the row's
index in the whole batch (``row0`` + its index in the call), so a decode
split into row chunks drops what an unsplit one drops.  A step that drops
runs the kernel's instantiation with dropout, a library of its own
(``ops/csrc/decode_step_dropout.cu``) loaded at the first such step; a step
at rate 0 runs the kernel the option left unchanged.

The verify pass of speculative decoding (the JAX package's
``infer/decode.py:_speculative_decode``, XLA only there) is the same kernel
in a verify form (``ops/csrc/decode_step_verify.cu``, a library of its
own): the K rows of one cluster are the positions t .. t + K - 1 of ONE
utterance, fed the drafted frames ``draft_frames``; row j attends to the
cache prefix [0, t) and to the chunk's own positions t .. t + j, and writes
its K/V at t + j.  The pass ends in the kernel with the acceptance
(``accept_reference``): it writes the accepted frames and stop logits into
the decode's buffers and one integer, 2 m + vote.  ``DecodeVerify``
prepares a pass once per decode; ``decode_verify_reference`` and
``verify_pass_reference`` are its plain version.
"""

from __future__ import annotations

import ctypes
import functools
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from transformertts_tpu_torch.models.masks import NEG_INF
from transformertts_tpu_torch.ops.dropout_mask import keep_from_index, threshold_of

# order of the weight pointers handed to the C entry point
_PACK_ORDER = (
    "pw1", "pb1", "pw2", "pb2",
    "sWqkv", "sbqkv", "sWo", "sbo",
    "cWq", "cbq", "cWo", "cbo",
    "W1", "B1", "W2", "B2", "ln_g", "ln_b",
    "head_w", "head_b",
)
MAX_BATCH = 8  # the CUDA source instantiates B = 1..8


@torch.no_grad()
def pack_decode_weights(model, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Decoder weights of a ``TransformerTTS`` in the kernel's layout.

    The content of the JAX ``pack_decode_weights``: matrices as (out, in)
    row-major in ``dtype`` (a warp per output column reads its row in
    16-byte vectors), biases in ``dtype``, the self-attention q|k|v
    projections fused into one (3D, D) matrix, the mel and stop heads fused
    into one (n_mels*r + r, D) matrix, LayerNorm parameters in fp32 as
    (L, 3, D).
    """
    layers = model.decoder.layers

    def w(lin):  # torch Linear layout (out, in)
        return lin.weight.to(dtype).contiguous()

    def b(lin):
        return lin.bias.to(dtype).contiguous()

    def stack(fn):
        return torch.stack([fn(lyr) for lyr in layers]).contiguous()

    pn = model.dec_prenet
    heads = (model.mel_linear.Dense_0, model.stop_linear.Dense_0)
    return {
        "pw1": w(pn.LinearNorm_0.Dense_0), "pb1": b(pn.LinearNorm_0.Dense_0),
        "pw2": w(pn.LinearNorm_1.Dense_0), "pb2": b(pn.LinearNorm_1.Dense_0),
        "sWqkv": stack(lambda l: torch.cat(
            [w(l.self_attn.q_proj), w(l.self_attn.k_proj), w(l.self_attn.v_proj)])),
        "sbqkv": stack(lambda l: torch.cat(
            [b(l.self_attn.q_proj), b(l.self_attn.k_proj), b(l.self_attn.v_proj)])),
        "sWo": stack(lambda l: w(l.self_attn.out_proj)),
        "sbo": stack(lambda l: b(l.self_attn.out_proj)),
        "cWq": stack(lambda l: w(l.cross_attn.q_proj)),
        "cbq": stack(lambda l: b(l.cross_attn.q_proj)),
        "cWo": stack(lambda l: w(l.cross_attn.out_proj)),
        "cbo": stack(lambda l: b(l.cross_attn.out_proj)),
        "W1": stack(lambda l: w(l.ffn.Dense_0)), "B1": stack(lambda l: b(l.ffn.Dense_0)),
        "W2": stack(lambda l: w(l.ffn.Dense_1)), "B2": stack(lambda l: b(l.ffn.Dense_1)),
        "ln_g": stack(lambda l: torch.stack(
            [l.norm1.weight, l.norm2.weight, l.norm3.weight]).float()),
        "ln_b": stack(lambda l: torch.stack(
            [l.norm1.bias, l.norm2.bias, l.norm3.bias]).float()),
        "head_w": torch.cat([w(h) for h in heads]).contiguous(),
        "head_b": torch.cat([b(h) for h in heads]).contiguous(),
    }


def prenet_drop_args(rate: float) -> tuple[int, float]:
    """(uint32 keep threshold, fp32 scale of the kept elements) of prenet
    dropout at ``rate``; (0, 1.0) drops nothing."""
    rate = float(rate)
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"prenet dropout must be in [0, 1), got {rate}")
    threshold = threshold_of(rate)
    return threshold, float(np.float32(1.0 / (1.0 - rate))) if threshold else 1.0


def prenet_keep(t: int, layer: int, rows: int, d: int, rate: float, seed: int, row0: int = 0,
                device=None) -> torch.Tensor:
    """(rows, d) keep bits of prenet layer ``layer`` at decoder position
    ``t`` for batch rows ``row0 .. row0 + rows - 1``: salt ``2 t + layer``,
    counter ``row * d + column`` (the kernel's mask)."""
    r = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(d, dtype=torch.int64, device=device)[None, :]
    return keep_from_index(r * d + c, 2 * t + layer, seed, rate)


def _layer_norm(x32, g, b, eps=1e-5):
    mu = x32.mean(-1, keepdim=True)
    var = (x32 * x32).mean(-1, keepdim=True) - mu * mu
    return (x32 - mu) * torch.rsqrt(torch.clamp(var, min=0.0) + eps) * g + b


@torch.no_grad()
def decode_step_reference(
    t: int,
    frame: torch.Tensor,  # (B, n_mels) fp32 — previous output frame (go at t=0)
    pe_row: torch.Tensor,  # (1, D) fp32 — alpha * PE[t]
    cross_bias: torch.Tensor,  # (B, Tp) fp32 additive key bias
    self_k: torch.Tensor,  # (L, H, B, n_pos, dh) — positions < t are valid
    self_v: torch.Tensor,
    cross_k: torch.Tensor,  # (L, H, B, Tp, dh)
    cross_v: torch.Tensor,
    packed: dict,
    with_attn_pos: bool = False,
    prenet_dropout: float = 0.0,
    seed: int = 0,
    row0: int = 0,
):
    """Plain PyTorch version of the kernel, op for op as the TPU ``_kernel``.

    Pure: returns (y (B, n_mels*r + r) fp32, k_new (L, H, B, dh),
    v_new (L, H, B, dh)) and, with ``with_attn_pos``, the last layer's
    head-averaged expected cross-attention position (B, 1) fp32.  Products
    of ``dtype`` operands are summed in fp32, as
    ``preferred_element_type=float32`` does.  ``prenet_dropout`` > 0 drops
    prenet elements by ``prenet_keep(t, layer, B, D, prenet_dropout, seed,
    row0)``, as the kernel does.
    """
    n_layers, n_heads, b, n_pos, dh = self_k.shape
    d = n_heads * dh
    dtype = packed["pw1"].dtype
    scale = dh ** -0.5
    p = packed

    def dot(a, w):  # w (out, in)
        return a.to(dtype).float() @ w.float().t()

    threshold, keep_scale = prenet_drop_args(prenet_dropout)

    def drop(x, layer):
        if not threshold:
            return x
        keep = prenet_keep(t, layer, b, d, prenet_dropout, seed, row0, x.device)
        return torch.where(keep, x * keep_scale, torch.zeros_like(x))

    x = frame.to(dtype)
    x = drop(torch.relu(dot(x, p["pw1"]) + p["pb1"].float()), 0)
    x = drop(torch.relu(dot(x, p["pw2"]) + p["pb2"].float()), 1)
    x = (x + pe_row.float()).to(dtype)  # (B, D)

    k_new = torch.empty((n_layers, n_heads, b, dh), dtype=self_k.dtype, device=x.device)
    v_new = torch.empty_like(k_new)
    pos_mask = torch.arange(n_pos, device=x.device) < t
    col = torch.arange(cross_k.shape[3], device=x.device, dtype=torch.float32)
    pos = None

    for li in range(n_layers):
        # ---------------- self-attention over the cached prefix + current
        resid = x.float()
        qkv = dot(x, p["sWqkv"][li]) + p["sbqkv"][li].float()  # (B, 3D)
        q = (qkv[:, :d] * scale).reshape(b, n_heads, dh)
        kn = qkv[:, d:2 * d].reshape(b, n_heads, dh)
        vn = qkv[:, 2 * d:].reshape(b, n_heads, dh)
        k_new[li] = kn.transpose(0, 1).to(self_k.dtype)
        v_new[li] = vn.transpose(0, 1).to(self_v.dtype)
        qb = q.to(dtype).float()
        s = torch.einsum("bhd,hbpd->bhp", qb, self_k[li].float())
        s = torch.where(pos_mask, s, torch.full_like(s, NEG_INF))
        s_cur = (q * kn).sum(-1, keepdim=True)  # (B, H, 1) fp32
        m = torch.maximum(s.max(-1, keepdim=True).values, s_cur)
        e = torch.exp(s - m)
        e_cur = torch.exp(s_cur - m)
        denom = e.sum(-1, keepdim=True) + e_cur
        ctx = torch.einsum("bhp,hbpd->bhd", e.to(dtype).float(), self_v[li].float())
        ctx = (ctx + e_cur * vn) / denom
        o = dot(ctx.reshape(b, d), p["sWo"][li]) + p["sbo"][li].float()
        x32 = _layer_norm(resid + o, p["ln_g"][li, 0], p["ln_b"][li, 0])
        x = x32.to(dtype)

        # ---------------- cross-attention over the encoder memory
        resid = x32
        q = ((dot(x, p["cWq"][li]) + p["cbq"][li].float()) * scale).reshape(b, n_heads, dh)
        s = torch.einsum("bhd,hbpd->bhp", q.to(dtype).float(), cross_k[li].float())
        s = s + cross_bias.float()[:, None, :]
        e = torch.exp(s - s.max(-1, keepdim=True).values)
        denom_c = e.sum(-1, keepdim=True)
        ctx = torch.einsum("bhp,hbpd->bhd", e.to(dtype).float(), cross_v[li].float()) / denom_c
        o = dot(ctx.reshape(b, d), p["cWo"][li]) + p["cbo"][li].float()
        if with_attn_pos and li == n_layers - 1:
            pos = ((e / denom_c) * col).sum(-1).sum(-1, keepdim=True) / n_heads
        x32 = _layer_norm(resid + o, p["ln_g"][li, 1], p["ln_b"][li, 1])
        x = x32.to(dtype)

        # ---------------- FFN
        h1 = torch.relu(dot(x, p["W1"][li]) + p["B1"][li].float())
        h2 = dot(h1, p["W2"][li]) + p["B2"][li].float()
        x32 = _layer_norm(x32 + h2, p["ln_g"][li, 2], p["ln_b"][li, 2])
        x = x32.to(dtype)

    y = dot(x, p["head_w"]) + p["head_b"].float()
    return (y, k_new, v_new) + ((pos,) if with_attn_pos else ())


def draft_frames(frames: torch.Tensor, t: int, r: int, k: int, linear: bool = True) -> torch.Tensor:
    """(K, n_mels) fp32 inputs of a verify pass at position t from the frame
    buffer ``frames`` (T, n_mels) (the go frame at 0): row j is f0 + j
    (f0 - prev), f0 = ``frames[t r]`` the true input and prev =
    ``frames[max(t r - r, 0)]`` the one before it ("linear"), or f0 itself
    ("hold": every row f0), as the JAX loop drafts."""
    f0 = frames[t * r]
    prev = frames[max(t * r - r, 0)] if linear else f0
    j = torch.arange(k, dtype=torch.float32, device=frames.device)[:, None]
    return f0 + j * (f0 - prev)


@torch.no_grad()
def decode_verify_reference(
    t: int,
    frames: torch.Tensor,  # (K, n_mels) fp32 — drafted inputs, row 0 the true frame
    pe_rows: torch.Tensor,  # (K, D) fp32 — alpha * PE[t .. t + K - 1]
    cross_bias: torch.Tensor,  # (1, Tp) fp32 additive key bias
    self_k: torch.Tensor,  # (L, H, 1, n_pos, dh) — positions < t are valid
    self_v: torch.Tensor,
    cross_k: torch.Tensor,  # (L, H, 1, Tp, dh)
    cross_v: torch.Tensor,
    packed: dict,
):
    """Plain PyTorch version of the verify kernel, op for op: the K
    positions t .. t + K - 1 of one utterance, each as
    ``decode_step_reference`` computes a step, except that row j attends to
    the cached prefix [0, t) and, in closed form with the fp32 q, k and v,
    to the chunk's own positions t .. t + j.

    Pure: returns (y (K, n_mels*r + r) fp32, k_new (L, H, K, dh), v_new
    (L, H, K, dh)); row j's K/V belong at position t + j of the caches."""
    n_layers, n_heads, _, _, dh = self_k.shape
    k = frames.shape[0]
    d = n_heads * dh
    dtype = packed["pw1"].dtype
    scale = dh ** -0.5
    p = packed

    def dot(a, w):  # w (out, in)
        return a.to(dtype).float() @ w.float().t()

    x = frames.to(dtype)
    x = torch.relu(dot(x, p["pw1"]) + p["pb1"].float())
    x = torch.relu(dot(x, p["pw2"]) + p["pb2"].float())
    x = (x + pe_rows.float()).to(dtype)  # (K, D)

    k_new = torch.empty((n_layers, n_heads, k, dh), dtype=self_k.dtype, device=x.device)
    v_new = torch.empty_like(k_new)
    own = torch.tril(torch.ones((k, k), dtype=torch.bool, device=x.device))[:, None, :]  # i <= j

    for li in range(n_layers):
        # ---------------- self-attention over the cached prefix + the chunk
        resid = x.float()
        qkv = dot(x, p["sWqkv"][li]) + p["sbqkv"][li].float()  # (K, 3D)
        q = (qkv[:, :d] * scale).reshape(k, n_heads, dh)
        kn = qkv[:, d:2 * d].reshape(k, n_heads, dh)
        vn = qkv[:, 2 * d:].reshape(k, n_heads, dh)
        k_new[li] = kn.transpose(0, 1).to(self_k.dtype)
        v_new[li] = vn.transpose(0, 1).to(self_v.dtype)
        keys, vals = self_k[li, :, 0, :t].float(), self_v[li, :, 0, :t].float()  # (H, t, dh)
        s = torch.einsum("khd,hpd->khp", q.to(dtype).float(), keys)
        s_cur = torch.einsum("jhd,ihd->jhi", q, kn)  # (K, H, K): row j's q . row i's k, fp32
        s_cur = torch.where(own, s_cur, torch.full_like(s_cur, NEG_INF))
        m = s_cur.max(-1, keepdim=True).values
        if t > 0:
            m = torch.maximum(s.max(-1, keepdim=True).values, m)
        e = torch.exp(s - m)
        e_cur = torch.where(own, torch.exp(s_cur - m), torch.zeros_like(s_cur))
        denom = e.sum(-1, keepdim=True) + e_cur.sum(-1, keepdim=True)
        ctx = torch.einsum("khp,hpd->khd", e.to(dtype).float(), vals)
        ctx = (ctx + torch.einsum("jhi,ihd->jhd", e_cur, vn)) / denom
        o = dot(ctx.reshape(k, d), p["sWo"][li]) + p["sbo"][li].float()
        x32 = _layer_norm(resid + o, p["ln_g"][li, 0], p["ln_b"][li, 0])
        x = x32.to(dtype)

        # ---------------- cross-attention over the utterance's encoder memory
        resid = x32
        q = ((dot(x, p["cWq"][li]) + p["cbq"][li].float()) * scale).reshape(k, n_heads, dh)
        s = torch.einsum("khd,hpd->khp", q.to(dtype).float(), cross_k[li, :, 0].float())
        s = s + cross_bias.float()[:, None, :]
        e = torch.exp(s - s.max(-1, keepdim=True).values)
        ctx = torch.einsum("khp,hpd->khd", e.to(dtype).float(),
                           cross_v[li, :, 0].float()) / e.sum(-1, keepdim=True)
        o = dot(ctx.reshape(k, d), p["cWo"][li]) + p["cbo"][li].float()
        x32 = _layer_norm(resid + o, p["ln_g"][li, 1], p["ln_b"][li, 1])
        x = x32.to(dtype)

        # ---------------- FFN
        h1 = torch.relu(dot(x, p["W1"][li]) + p["B1"][li].float())
        h2 = dot(h1, p["W2"][li]) + p["B2"][li].float()
        x32 = _layer_norm(x32 + h2, p["ln_g"][li, 2], p["ln_b"][li, 2])
        x = x32.to(dtype)

    y = dot(x, p["head_w"]) + p["head_b"].float()
    return y, k_new, v_new


def accept_reference(mel: torch.Tensor, stop: torch.Tensor, drafts: torch.Tensor, r: int,
                     tau: float, stop_threshold: float, limit: int) -> torch.Tensor:
    """The acceptance of a verify pass (JAX ``_speculative_decode``), on the
    device, as one integer 2 m + vote (a 0-dim int64 tensor).

    ``mel`` (K, r n_mels) and ``stop`` (K, r) fp32 are the K groups' outputs,
    ``drafts`` (K, n_mels) their inputs.  Row j >= 1 is accepted while its
    draft is within ``tau`` (max-abs over mel bins, fp32) of group j - 1's
    last frame and group j - 1 did not vote to stop (``sigmoid(stop) >=
    stop_threshold`` in any of its r frames); m (>= 1) counts the accepted
    groups, at most ``limit``; the vote is the last accepted group's before
    that cut."""
    n_mels = drafts.shape[1]
    last = mel[:-1, (r - 1) * n_mels:]  # the last frame of groups 0 .. K - 2
    ok = (drafts[1:] - last).abs().amax(1) <= float(np.float32(tau))
    vote = (torch.sigmoid(stop) >= float(np.float32(stop_threshold))).any(1)  # (K,)
    m = 1 + torch.cumprod((ok & ~vote[:-1]).long(), 0).sum()
    voted = vote[m - 1].long()
    return 2 * torch.clamp(m, max=limit) + voted


def verify_pass_reference(t, self_k, self_v, cross_k, cross_v, packed, cross_bias, pe_table,
                          frames, stops, *, k: int, r: int, n_pos: int, tau: float,
                          stop_threshold: float, linear: bool = True):
    """The whole verify pass in plain PyTorch, as the kernel does it:
    ``draft_frames``, ``decode_verify_reference``, the K/V rows written at t
    .. t + K - 1, ``accept_reference`` (read back), and the m r accepted
    frames and stop logits written into ``frames`` (T, n_mels) from row t r
    + 1 and ``stops`` (T - 1,) from t r.  Arguments as ``DecodeVerify``'s;
    returns (code (1,) int32 = 2 m + vote, y, k_new, v_new)."""
    n_mels = frames.shape[1]
    drafts = draft_frames(frames, t, r, k, linear)
    y, k_new, v_new = decode_verify_reference(t, drafts, pe_table[t:t + k], cross_bias, self_k,
                                              self_v, cross_k, cross_v, packed)
    self_k[:, :, 0, t:t + k] = k_new
    self_v[:, :, 0, t:t + k] = v_new
    mel, stop = y[:, :n_mels * r], y[:, n_mels * r:]
    code = int(accept_reference(mel, stop, drafts, r, tau, stop_threshold, n_pos - t))
    m = code // 2
    frames[t * r + 1: t * r + 1 + m * r] = mel.reshape(k * r, n_mels)[:m * r]
    stops[t * r: t * r + m * r] = stop.reshape(-1)[:m * r]
    return torch.tensor([code], dtype=torch.int32, device=frames.device), y, k_new, v_new


def _packed_shapes(n_layers: int, d: int, d_ffn: int, n_mels: int, d_out: int) -> dict:
    """Shape of every packed weight (``pack_decode_weights``'s layout)."""
    L = n_layers
    return {
        "pw1": (d, n_mels), "pb1": (d,), "pw2": (d, d), "pb2": (d,),
        "sWqkv": (L, 3 * d, d), "sbqkv": (L, 3 * d), "sWo": (L, d, d), "sbo": (L, d),
        "cWq": (L, d, d), "cbq": (L, d), "cWo": (L, d, d), "cbo": (L, d),
        "W1": (L, d_ffn, d), "B1": (L, d_ffn), "W2": (L, d, d_ffn), "B2": (L, d),
        "ln_g": (L, 3, d), "ln_b": (L, 3, d), "head_w": (d_out, d), "head_b": (d_out,),
    }


def _check_cuda_args(frame, pe_row, cross_bias, self_k, self_v, cross_k, cross_v, packed):
    """Raise unless every tensor is what the kernel reads: dtype, shape,
    contiguity, widths its 16-byte vectors tile, and the caches' device.
    The C entry point checks the rest (shared memory per block, the plan)."""
    _check_fixed_args(self_k, self_v, cross_k, cross_v, packed)
    _check_step_args(frame, pe_row, cross_bias, self_k, cross_k.shape[3], packed)


def _check_fixed_args(self_k, self_v, cross_k, cross_v, packed):
    """The part of ``_check_cuda_args`` a prepared step checks once: the
    caches and the packed weights."""
    dtype = packed["pw1"].dtype
    n_layers, n_heads, b, n_pos, dh = self_k.shape
    tp = cross_k.shape[3]
    d = n_heads * dh
    d_ffn, n_mels, d_out = packed["W1"].shape[1], packed["pw1"].shape[1], packed["head_w"].shape[0]
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_step kernel takes float32 or bfloat16 weights, got {dtype}")
    widths = (d, d_ffn, n_mels, dh)
    groups = dh // 4
    if not (1 <= b <= MAX_BATCH and all(k % 8 == 0 for k in widths)
            and groups & (groups - 1) == 0 and groups <= 32):
        raise ValueError(f"decode_step kernel takes 1 <= B <= {MAX_BATCH}, widths that are "
                         f"multiples of 8 and dh/4 a power of two <= 32; got B={b}, "
                         f"(d, d_ffn, n_mels, dh)={widths}")
    expect = {
        "self_k": (self_k, dtype, tuple(self_k.shape)),
        "self_v": (self_v, dtype, tuple(self_k.shape)),
        "cross_k": (cross_k, dtype, (n_layers, n_heads, b, tp, dh)),
        "cross_v": (cross_v, dtype, (n_layers, n_heads, b, tp, dh)),
    }
    for k, shape in _packed_shapes(n_layers, d, d_ffn, n_mels, d_out).items():
        expect[k] = (packed[k], torch.float32 if k.startswith("ln_") else dtype, shape)
    _check_tensors(expect, self_k.device)


def _check_step_args(frame, pe_row, cross_bias, self_k, tp, packed):
    """What changes from step to step: the fed-back frame (its rows may lie
    apart, as a slice of the decode's frame buffer), alpha*PE[t] and the
    cross bias."""
    b, n_mels, d = self_k.shape[2], packed["pw1"].shape[1], packed["pw1"].shape[0]
    if frame.dtype != torch.float32 or tuple(frame.shape) != (b, n_mels) or frame.stride(1) != 1:
        raise ValueError(f"decode_step: frame must be float32 of shape {(b, n_mels)} with "
                         f"unit column stride, got {frame.dtype} {tuple(frame.shape)} "
                         f"strides {frame.stride()}")
    _check_tensors({"pe_row": (pe_row, torch.float32, (1, d)),
                    "cross_bias": (cross_bias, torch.float32, (b, tp))}, self_k.device)
    if frame.device != self_k.device:
        raise ValueError(f"decode_step: frame is on {frame.device}, caches on {self_k.device}")


def _check_tensors(expect: dict, device) -> None:
    for name, (x, dt, shape) in expect.items():
        if x.dtype != dt or not x.is_contiguous() or tuple(x.shape) != shape:
            raise ValueError(f"decode_step: {name} must be a contiguous {dt} of shape {shape}, "
                             f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    for name, (x, _, _) in expect.items():
        if x.device.type != "cuda" or x.device != device:
            raise ValueError(f"decode_step: {name} is on {x.device}, caches on {device}")


# ---------------------------------------------------------------- the plan
#
# What the C side is handed besides pointers: the output columns each block
# of a cluster owns in every matrix-vector stage, cut into weight pieces,
# where each piece lies in the block's shared-memory ring and when it is
# copied, the attention chunks, the rows a cluster decodes, and the
# shared-memory layout.  All of it is computed here, so the CPU tests reach
# it; the kernel only checks what it is given.

CLUSTER = 16  # blocks of a cluster, as a rule (Config::cluster in the CUDA source)
# cluster sizes tried in turn for one row a cluster (``card_plan``)
CLUSTER_SIZES = (16, 12, 8)
MAX_CLUSTER = 16  # kMaxCluster
THREADS = 512  # threads of a block (kThreads)
WARPS = THREADS // 32
SMEM_LIMIT = 232_448  # dynamic shared memory a block may opt in to on Hopper (227 KB)
PIECE_BYTES = 32 * 1024  # a weight piece, at most (unless one column is larger)
VERIFY_PIECE_BYTES = 36 * 1024  # a verify weight piece: a 64-column stage of Config() whole
# kMaxPieces: a bound on the plan, not a buffer (the piece table and its
# mbarriers take 24 bytes a piece of the block's shared memory, in the layout);
# fp32 at d_model 1,024 and d_ffn 4,096 takes 682 a block in clusters of 16,
# 1,364 in clusters of 8
MAX_PIECES = 2048
# keys of an attention chunk, at least: a bf16 block reads 256 cache rows in
# one batch of loads (kUnroll x 64 rows), so shorter chunks only add partials
# (and one chunk a (row, head) saves the attention's second barrier)
MIN_CHUNK = 256
# the kernel's shared-memory buffers, in the order of its Buffer enum
SMEM_BUFFERS = ("stages", "pieces", "mbar", "red", "bias", "ln", "ra", "rb", "o", "q", "kv",
                "act", "xs", "pm", "pl", "ppos", "pacc", "mloc", "posh", "part", "scores", "ring")


def gemv_stages(n_layers: int, d: int, d_ffn: int, n_mels: int, d_out: int) -> list:
    """(name, N columns, K depth) of every matrix-vector stage of a step, in
    the kernel's order (``stage_w`` in the CUDA source)."""
    stages = [("prenet1", d, n_mels), ("prenet2", d, d)]
    for li in range(n_layers):
        stages += [(f"qkv{li}", 3 * d, d), (f"self_out{li}", d, d), (f"cross_q{li}", d, d),
                   (f"cross_out{li}", d, d), (f"ffn1_{li}", d_ffn, d), (f"ffn2_{li}", d, d_ffn)]
    stages.append(("head", d_out, d))
    return stages


def split_columns(n: int, n_blocks: int, first: int = 0) -> list:
    """[col0, col1) of each block for n columns: n // n_blocks each, one more
    for n % n_blocks blocks starting at block ``first`` (so that the extra
    columns of successive stages land on different blocks)."""
    q, r = divmod(n, n_blocks)
    sizes = [q + ((g - first) % n_blocks < r) for g in range(n_blocks)]
    out, at = [], 0
    for size in sizes:
        out.append((at, at + size))
        at += size
    return out


def ring_placement(piece_bytes: list, ring_bytes: int) -> list:
    """(ring offset, issue after) of one block's weight pieces, placed one
    after another in a ring of ``ring_bytes`` (a piece that would run past
    the end starts again at 0).  A piece is copied at kernel start (issue
    after -1) or once the piece that last used any of its bytes has been
    used; "issue after" never decreases along the pieces."""
    out, placed, at = [], [], 0  # placed: (piece, start, end)
    for i, nb in enumerate(piece_bytes):
        if nb > ring_bytes:
            raise ValueError(f"a weight piece of {nb} bytes exceeds the {ring_bytes}-byte ring")
        if at + nb > ring_bytes:
            at = 0
        after = max((i2 for i2, a, e in placed if a < at + nb and at < e), default=-1)
        if out and after < out[-1][1]:
            after = out[-1][1]
        placed.append((i, at, at + nb))
        out.append((at, after))
        at += nb
    return out


def attn_chunks(n_keys: int, rows: int, n_heads: int, n_blocks: int = CLUSTER,
                min_chunk: int = MIN_CHUNK) -> tuple:
    """(keys per chunk, chunks) that cut the keys of every (row, head) of a
    cluster's ``rows`` rows: as many chunks as leave every block at most one
    (row, head, chunk) item, none shorter than ``min_chunk`` keys unless the
    keys are fewer.  Chunk c covers [c * len, min((c + 1) * len, n_keys)).
    (0, 0) for no keys."""
    if n_keys <= 0:
        return 0, 0
    nc = max(1, min(n_blocks // (rows * n_heads), -(-n_keys // min_chunk)))
    length = -(-n_keys // nc)
    return length, -(-n_keys // length)


def chunks_max(rows: int, n_heads: int, n_blocks: int = CLUSTER) -> int:
    """The most chunks per (row, head) ``attn_chunks`` gives."""
    return max(1, n_blocks // (rows * n_heads))


PLANS_MAX = 64  # decode plans and card plans kept, each (least recently used dropped)


def decode_plan(n_layers: int, d: int, d_ffn: int, n_mels: int, d_out: int, rows: int,
                n_heads: int, n_pos: int, tp: int, itemsize: int, cluster: int = CLUSTER):
    """The kernel's plan for clusters of ``rows`` batch rows: an int32 array
    (3 + 6 L, cluster, 4) of (first piece, end piece, bias offset, 0) per
    stage and block, an int32 array (pieces, cluster, 4) of (first column,
    end column, ring offset, issue after) per weight piece and block (a
    block with fewer pieces pads with pieces never issued), and the
    shared-memory layout: the byte offset of every buffer of
    ``SMEM_BUFFERS``, ``ring_bytes`` and ``smem_bytes``.  Raises when a
    block's buffers or a piece do not fit.

    Memoised on its integers (``PLANS_MAX`` plans), with the cache and
    encoder lengths as ``max(n_pos, tp)``, the one way the plan reads them:
    every prompt of a decode's length takes one plan.  The arrays are
    shared and read-only; the layout is the caller's copy."""
    stage_rows, piece_rows, layout = _plan_of(n_layers, d, d_ffn, n_mels, d_out, rows, n_heads,
                                              max(n_pos, tp), itemsize, cluster)
    return stage_rows, piece_rows, dict(layout)


@functools.lru_cache(maxsize=PLANS_MAX)
def _plan_of(n_layers, d, d_ffn, n_mels, d_out, rows, n_heads, max_keys, itemsize, cluster):
    """``decode_plan``, computed (the arrays made read-only)."""
    stages = gemv_stages(n_layers, d, d_ffn, n_mels, d_out)
    cols, pieces, bias, need = _block_pieces(
        stages, cluster, lambda k: k * itemsize, lambda k: max(1, PIECE_BYTES // (k * itemsize)))
    layout = decode_smem_layout(rows, n_layers, n_heads, d // n_heads, d_ffn, n_mels, max_keys,
                                itemsize, len(stages), max(map(len, pieces)), bias, need, cluster)
    plan = _plan_rows(stages, cols, pieces, layout)
    for a in plan[:2]:
        a.flags.writeable = False
    return plan


def _block_pieces(stages: list, cluster: int, row_bytes, piece_cols) -> tuple:
    """Each block's columns of every stage (``split_columns``, the extra
    columns of successive stages on different blocks) and its weight pieces
    (stage, col0, col1, bytes) of ``piece_cols(k)`` columns of
    ``row_bytes(k)`` bytes (k the stage's depth); the bias floats a block
    holds (a multiple of 4) and the most ring bytes a block's pieces take."""
    cols, first = [], 0
    for _, n, _ in stages:
        cols.append(split_columns(n, cluster, first))
        first = (first + n % cluster) % cluster
    pieces = []
    for g in range(cluster):
        mine = []
        for s, (_, _, k) in enumerate(stages):
            c0, c1 = cols[s][g]
            step = piece_cols(k)
            mine += [(s, a, min(a + step, c1), (min(a + step, c1) - a) * row_bytes(k))
                     for a in range(c0, c1, step)]
        pieces.append(mine)
    n_pieces = max(len(p) for p in pieces)
    if n_pieces > MAX_PIECES:
        raise ValueError(f"decode_step: {n_pieces} weight pieces a block, over {MAX_PIECES}")
    need = max(sum(p[3] for p in mine) for mine in pieces)
    bias = -(-max(sum(c1 - c0 for c0, c1 in (cols[s][g] for s in range(len(stages))))
                  for g in range(cluster)) // 4) * 4  # a bulk copy moves 16-byte multiples
    return cols, pieces, bias, need


def _plan_rows(stages: list, cols: list, pieces: list, layout: dict) -> tuple:
    """(stage rows, piece rows, layout) of ``decode_plan`` from
    ``_block_pieces``' columns and pieces, placed in the ring of
    ``layout`` (a block with fewer pieces pads with pieces never issued)."""
    cluster, n_pieces = len(pieces), max(map(len, pieces))
    stage_rows = np.zeros((len(stages), cluster, 4), np.int32)
    piece_rows = np.zeros((n_pieces, cluster, 4), np.int32)
    piece_rows[:, :, 3] = 1 << 30  # padding: never issued
    for g, mine in enumerate(pieces):
        place = ring_placement([p[3] for p in mine], layout["ring_bytes"])
        bias_at = 0
        for s in range(len(stages)):
            idx = [i for i, p in enumerate(mine) if p[0] == s]
            lo = idx[0] if idx else (stage_rows[s - 1, g, 1] if s else 0)
            stage_rows[s, g] = (lo, idx[-1] + 1 if idx else lo, bias_at, 0)
            bias_at += cols[s][g][1] - cols[s][g][0]
        for i, (p, (off, after)) in enumerate(zip(mine, place)):
            piece_rows[i, g] = (p[1], p[2], off, after)
    return stage_rows, piece_rows, layout


def stage_biases(packed: dict, n_layers: int) -> list:
    """The bias of every matrix-vector stage, in ``gemv_stages`` order."""
    out = [packed["pb1"], packed["pb2"]]
    for li in range(n_layers):
        out += [packed[k][li] for k in ("sbqkv", "sbo", "cbq", "cbo", "B1", "B2")]
    return out + [packed["head_b"]]


def bias_table(biases: list, stage_rows, piece_rows, n_bias: int) -> torch.Tensor:
    """(cluster, n_bias) fp32: each block's biases of its columns, stage
    after stage at the stage rows' bias offsets (what the kernel copies
    into its kBufBias).  The biases reach the host in one copy."""
    cluster = stage_rows.shape[1]
    flat = torch.cat([b.detach().reshape(-1) for b in biases]).float().cpu().numpy()
    start = np.cumsum([0] + [b.numel() for b in biases])
    table = np.zeros((cluster, n_bias), np.float32)
    for g in range(cluster):
        for s in range(len(biases)):
            first, end, at, _ = (int(v) for v in stage_rows[s, g])
            if end > first:
                c0, c1 = int(piece_rows[first, g, 0]), int(piece_rows[end - 1, g, 1])
                table[g, at:at + c1 - c0] = flat[start[s] + c0:start[s] + c1]
    return torch.from_numpy(table)


def decode_smem_layout(rows: int, n_layers: int, n_heads: int, dh: int, d_ffn: int, n_mels: int,
                       max_keys: int, itemsize: int, n_stages: int, n_pieces: int,
                       bias_floats: int, ring_need: int, cluster: int = CLUSTER) -> dict:
    """Byte offsets of the kernel's shared-memory buffers (``SMEM_BUFFERS``;
    the CUDA source's Buffer enum says what each holds), 16-byte aligned,
    for clusters of ``rows`` rows and attention over at most ``max_keys``
    keys (the larger of the cache and encoder lengths); the ring takes what
    is left of ``SMEM_LIMIT``, at most ``ring_need``."""
    d = n_heads * dh
    rh, ncm = rows * n_heads, chunks_max(rows, n_heads, cluster)
    items = -(-rh * ncm // cluster)  # (row, head, chunk) items a block, at most
    floats = {
        "red": 2 * rows * WARPS, "bias": bias_floats, "ln": 2 * 6 * d,
        "ra": rows * d, "rb": rows * d, "o": rows * d, "q": rows * d,
        "kv": 2 * rows * d, "act": rows * max(d, d_ffn), "xs": rows * max(d, n_mels),
        "pm": rh * ncm, "pl": rh * ncm, "ppos": rh * ncm, "pacc": rh * ncm * dh,
        "mloc": items, "posh": rh, "part": THREADS * (16 // itemsize) + THREADS + dh,
        "scores": items * max_keys,
    }
    sizes = {"stages": 16 * n_stages, "pieces": 16 * n_pieces, "mbar": 8 * (n_pieces + n_layers + 1),
             **{k: 4 * v for k, v in floats.items()}}
    out, at = {}, 0
    for name in SMEM_BUFFERS[:-1]:
        out[name] = at
        at += -(-sizes[name] // 16) * 16
    out["ring"] = at
    out["n_bias"] = bias_floats
    out["ring_bytes"] = min((SMEM_LIMIT - at) // 16 * 16, -(-ring_need // 16) * 16)
    out["smem_bytes"] = at + max(out["ring_bytes"], 0)
    if out["ring_bytes"] < PIECE_BYTES and out["ring_bytes"] < ring_need:
        raise ValueError(f"decode_step: the kernel's buffers take {at} bytes of shared memory, "
                         f"too much of the {SMEM_LIMIT} a block may have")
    return out


def rows_per_cluster(b: int, max_clusters) -> int:
    """Rows R a cluster decodes: the smallest divisor of b whose b / R
    clusters the card holds at once (``max_clusters(R)``, 0 where R does not
    fit a block); the smallest that fits when none is held at once."""
    fits = [r for r in range(1, b + 1) if b % r == 0 and max_clusters(r) > 0]
    if not fits:
        raise ValueError(f"decode_step: no rows per cluster fits B={b}")
    return next((r for r in fits if b // r <= max_clusters(r)), fits[0])


def card_plan(n_layers: int, d: int, d_ffn: int, n_mels: int, d_out: int, b: int, n_heads: int,
              n_pos: int, tp: int, dtype: torch.dtype) -> tuple:
    """(blocks a cluster, rows per cluster, ``decode_plan``) for B = b on
    the current card: one row a cluster with the first size of
    ``CLUSTER_SIZES`` whose b clusters the card holds at once; else clusters
    of ``CLUSTER`` blocks and the rows from ``rows_per_cluster``.  Memoised
    as ``decode_plan``, and on the dtype and the current device's index."""
    cluster, rows, (stage_rows, piece_rows, layout) = _card_plan_of(
        n_layers, d, d_ffn, n_mels, d_out, b, n_heads, max(n_pos, tp), dtype, _device_index())
    return cluster, rows, (stage_rows, piece_rows, dict(layout))


def _device_index() -> int:
    return torch.cuda.current_device() if torch.cuda.is_available() else -1


@functools.lru_cache(maxsize=PLANS_MAX)
def _card_plan_of(n_layers, d, d_ffn, n_mels, d_out, b, n_heads, max_keys, dtype, device):
    """``card_plan``, computed (``device``: the card the library asks)."""
    lib = _lib()
    is_bf16 = int(dtype == torch.bfloat16)
    itemsize = torch.empty((), dtype=dtype).element_size()

    def plan(rows, cluster):
        return decode_plan(n_layers, d, d_ffn, n_mels, d_out, rows, n_heads, max_keys, max_keys,
                           itemsize, cluster)

    def max_clusters(rows, cluster=CLUSTER):  # 0 where the plan does not fit
        try:
            smem = plan(rows, cluster)[2]["smem_bytes"]
        except ValueError:
            return 0
        return lib.tts_decode_step_max_clusters(is_bf16, rows, smem, cluster)

    for cluster in CLUSTER_SIZES:
        if max_clusters(1, cluster) >= b:
            return cluster, 1, plan(1, cluster)
    rows = rows_per_cluster(b, max_clusters)
    return CLUSTER, rows, plan(rows, CLUSTER)


@functools.lru_cache(maxsize=PLANS_MAX)
def self_chunks(n_pos: int, rows: int, n_heads: int, cluster: int) -> tuple:
    """``attn_chunks`` of the self-attention keys at every position t <
    ``n_pos`` (t keys at t), memoised."""
    return tuple(attn_chunks(t, rows, n_heads, cluster) for t in range(n_pos))


class StepPrep(NamedTuple):
    """What a ``DecodeStep`` needs that depends only on the packed weights
    and the shapes (B, n_pos, max(n_pos, Tp)) on the current card
    (``prepare_step``): the cluster plan, its tables on the weights' device
    (stage rows, piece rows, the bias table), the weights' pointers in
    ``_PACK_ORDER`` and the self-attention chunks of every position."""

    shape: tuple  # (B, n_pos, max(n_pos, Tp))
    cluster: int
    rows: int
    plan: tuple
    tensors: tuple
    pointers: tuple
    chunks: tuple


def prepare_step(packed: dict, b: int, n_pos: int, tp: int, n_heads: int) -> StepPrep:
    """The ``StepPrep`` of B = b rows over caches of ``n_pos`` positions and
    ``tp`` encoder positions with the weights ``packed``; it serves every
    ``tp`` up to ``max(n_pos, tp)``."""
    n_layers, d, d_ffn = packed["sWo"].shape[0], packed["pw1"].shape[0], packed["W1"].shape[1]
    n_mels, d_out = packed["pw1"].shape[1], packed["head_w"].shape[0]
    cluster, rows, plan = card_plan(n_layers, d, d_ffn, n_mels, d_out, b, n_heads, n_pos, tp,
                                    packed["pw1"].dtype)
    return StepPrep((b, n_pos, max(n_pos, tp)), cluster, rows, plan,
                    _plan_tensors(plan, packed), tuple(packed[k].data_ptr() for k in _PACK_ORDER),
                    self_chunks(n_pos, rows, n_heads, cluster))


# ------------------------------------------------------------- the launch

class _StepConfig(ctypes.Structure):
    """The CUDA source's ``Config``, field for field."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "cluster", "B", "R", "L", "H", "dh", "F", "n_mels", "d_out", "n_pos", "tp",
        "cross_chunk", "cross_nc", "nc_max", "max_keys", "n_pieces", "n_bias", "smem_bytes")] + [
        ("off", ctypes.c_int * len(SMEM_BUFFERS)),
        ("first_piece", (ctypes.c_int * 2) * MAX_CLUSTER), ("scale", ctypes.c_float),
        ("w", ctypes.c_void_p * len(_PACK_ORDER)),
        ("stages", ctypes.c_void_p), ("pieces", ctypes.c_void_p), ("bias", ctypes.c_void_p)]


def _plan_tensors(plan, packed: dict) -> tuple:
    """The stage rows, piece rows (each rank's rows contiguous, for one
    bulk copy each) and bias table of ``plan`` on the weights' device."""
    stage_rows, piece_rows, layout = plan
    dev = packed["pw1"].device
    stages = torch.from_numpy(stage_rows.transpose(1, 0, 2).copy()).to(dev)
    pieces = torch.from_numpy(piece_rows.transpose(1, 0, 2).copy()).to(dev)
    bias = bias_table(stage_biases(packed, packed["sWo"].shape[0]), stage_rows, piece_rows,
                      layout["n_bias"]).to(dev)
    return stages, pieces, bias


def _launch_config(plan, packed: dict, cluster: int, b: int, rows: int, n_heads: int, n_pos: int,
                   tp: int, weights: dict | None = None, tensors: tuple | None = None,
                   pointers: tuple | None = None) -> tuple:
    """The kernel's ``Config`` for ``plan`` (``decode_plan``'s result) with
    clusters of ``cluster`` blocks decoding ``rows`` rows each, ``b`` batch
    rows of caches of ``n_pos`` and ``tp`` positions, pointing to
    ``weights`` (default ``packed``, whose shapes give the widths; or the
    ``pointers`` of ``packed`` in ``_PACK_ORDER``), and the plan's tensors
    on the weights' device that it points to (``tensors``, else made from
    ``plan``; keep them alive)."""
    stage_rows, piece_rows, layout = plan
    n_layers, d = packed["sWo"].shape[0], packed["pw1"].shape[0]
    dh = d // n_heads
    stages, pieces, bias = _plan_tensors(plan, packed) if tensors is None else tensors
    if pointers is None:
        pointers = [(packed if weights is None else weights)[k].data_ptr() for k in _PACK_ORDER]
    cross_chunk, cross_nc = attn_chunks(tp, rows, n_heads, cluster)
    cfg = _StepConfig(
        cluster=cluster, B=b, R=rows, L=n_layers, H=n_heads, dh=dh, F=packed["W1"].shape[1],
        n_mels=packed["pw1"].shape[1], d_out=packed["head_w"].shape[0], n_pos=n_pos, tp=tp,
        cross_chunk=cross_chunk, cross_nc=cross_nc, nc_max=chunks_max(rows, n_heads, cluster),
        max_keys=max(n_pos, tp), n_pieces=piece_rows.shape[0], n_bias=layout["n_bias"],
        smem_bytes=layout["smem_bytes"],
        off=(ctypes.c_int * len(SMEM_BUFFERS))(*[layout[k] for k in SMEM_BUFFERS]),
        first_piece=((ctypes.c_int * 2) * MAX_CLUSTER)(
            *[(ctypes.c_int * 2)(*piece_rows[0, g, :2]) for g in range(cluster)]),
        scale=dh ** -0.5,
        w=(ctypes.c_void_p * len(_PACK_ORDER))(*pointers),
        stages=stages.data_ptr(), pieces=pieces.data_ptr(), bias=bias.data_ptr())
    return (stages, pieces, bias), cfg


def _lib(name: str = "decode_step"):
    """The kernel's library: ``decode_step`` (no prenet dropout) or
    ``decode_step_dropout`` (the same source instantiated with it)."""
    from transformertts_tpu_torch import _build

    lib = _build.load(name)
    if not getattr(lib, "_argtypes_set", False):
        i, p = ctypes.c_int, ctypes.c_void_p
        u = ctypes.c_uint32
        lib.tts_decode_step.argtypes = [p, i, i, i, i, u, ctypes.c_float, u, i, p, i] + [p] * 12
        lib.tts_decode_step.restype = i
        lib.tts_decode_step_max_clusters.argtypes = [i, i, i, i]
        lib.tts_decode_step_config_bytes.restype = ctypes.c_long
        if lib.tts_decode_step_config_bytes() != ctypes.sizeof(_StepConfig):
            raise RuntimeError("decode_step: _StepConfig does not mirror the CUDA Config")
        lib._argtypes_set = True
    return lib


def _current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


class DecodeStep:
    """One decoder step on the GPU, prepared for fixed caches and weights.

    Built once per decode (per chunk of rows): it checks the caches and the
    packed weights, takes what depends only on the weights and the shapes
    (``prep``: the rows a cluster decodes, the plan and its tables on the
    device; made here by ``prepare_step`` when not given), allocates the
    outputs and fills the kernel's ``Config``.
    Each call is then one C call and one kernel launch on the stream that
    is current at the call:

        step = DecodeStep(self_k, self_v, cross_k, cross_v, packed, with_attn_pos[, prep])
        y, k_new, v_new[, pos] = step(t, frame, pe_row, cross_bias)

    The results are the step's own buffers, overwritten by its next call.
    The new K/V rows are also written into ``self_k`` / ``self_v`` at ``t``.
    ``launches`` counts this step's kernel launches (each also adds to
    ``decode_step.launches``).
    """

    def __init__(self, self_k, self_v, cross_k, cross_v, packed, with_attn_pos: bool = False,
                 prep: StepPrep | None = None):
        _check_fixed_args(self_k, self_v, cross_k, cross_v, packed)
        lib = _lib()
        n_layers, n_heads, b, n_pos, dh = self_k.shape
        tp, dev = cross_k.shape[3], self_k.device
        d_ffn, d_out = packed["W1"].shape[1], packed["head_w"].shape[0]
        if prep is None:
            prep = prepare_step(packed, b, n_pos, tp, n_heads)
        elif prep.shape != (b, n_pos, max(n_pos, tp)):
            raise ValueError(f"decode_step: a step prepared for (B, n_pos, max keys) {prep.shape} "
                             f"cannot take {(b, n_pos, max(n_pos, tp))}")
        cluster, rows, plan = prep.cluster, prep.rows, prep.plan
        self._plan, self._cfg = _launch_config(plan, packed, cluster, b, rows, n_heads, n_pos, tp,
                                               tensors=prep.tensors, pointers=prep.pointers)
        self.y = torch.empty((b, d_out), dtype=torch.float32, device=dev)
        self.k_new = torch.empty((n_layers, n_heads, b, dh), dtype=self_k.dtype, device=dev)
        self.v_new = torch.empty_like(self.k_new)
        self.pos = torch.empty((b, 1), dtype=torch.float32, device=dev) if with_attn_pos else None
        self._self_chunks = prep.chunks
        self.layout, self.rows, self.cluster = plan[2], rows, cluster
        self.blocks = b // rows * cluster
        self._keep = (self_k, self_v, cross_k, cross_v, packed)  # the pointers stay valid
        self._is_bf16 = int(packed["pw1"].dtype == torch.bfloat16)
        self._fixed = (self_k.data_ptr(), self_v.data_ptr(), cross_k.data_ptr(),
                       cross_v.data_ptr())
        self._call = lib.tts_decode_step
        self._call_drop = None  # the dropout library's, loaded at the first call that drops
        self._b, self._n_pos, self._tp = b, n_pos, tp
        self._shape = (n_layers, n_heads, dh, d_ffn)
        self.launches = 0

    def __call__(self, t: int, frame, pe_row, cross_bias, out=None, timeline=None,
                 prenet_dropout: float = 0.0, seed: int = 0, row0: int = 0):
        """The step at position ``t``.  ``out``: (y, k_new, v_new, pos or
        None) to write into instead of the step's own buffers.
        ``timeline``: an int64 tensor from ``timeline_buffer`` that the
        kernel fills with global-timer stamps (``stage_times`` reads it).
        ``prenet_dropout``, ``seed``, ``row0``: as ``decode_step_reference``."""
        if not 0 <= t < self._n_pos:
            raise ValueError(f"t={t} outside the cache of {self._n_pos} positions")
        _check_step_args(frame, pe_row, cross_bias, self._keep[0], self._tp, self._keep[4])
        threshold, keep_scale = prenet_drop_args(prenet_dropout)
        if threshold and self._call_drop is None:
            self._call_drop = _lib("decode_step_dropout").tts_decode_step
        y, k_new, v_new, pos = out if out is not None else (self.y, self.k_new, self.v_new,
                                                            self.pos)
        chunk, nc = self._self_chunks[t]
        rc = (self._call_drop if threshold else self._call)(
            ctypes.byref(self._cfg), self._is_bf16, t, chunk, nc,
            threshold, keep_scale, int(seed) & 0xFFFFFFFF, int(row0),
            frame.data_ptr(), frame.stride(0), pe_row.data_ptr(), cross_bias.data_ptr(),
            *self._fixed, y.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            pos.data_ptr() if pos is not None else None,
            timeline.data_ptr() if timeline is not None else None,
            _current_stream(self.y.device))
        if rc != 0:
            n_layers, n_heads, dh, d_ffn = self._shape
            raise RuntimeError(
                f"decode_step kernel refused or failed to launch (CUDA error {rc}) for "
                f"B={self._b}, L={n_layers}, H={n_heads}, dh={dh}, d_ffn={d_ffn}, "
                f"n_pos={self._n_pos}, Tp={self._tp}, t={t}")
        decode_step.launches += 1
        self.launches += 1
        if self._b > 1:
            decode_step.launches_batched += 1
        return (y, k_new, v_new) + ((pos,) if pos is not None else ())

    def stages(self, t: int) -> list:
        """``step_stages`` of a call at position t."""
        return step_stages(self._shape[0], self._self_chunks[t][1], self._cfg.cross_nc)

    def timeline_buffer(self) -> torch.Tensor:
        """Room for one call's stamps: per block the kernel's start, the
        arrival at and release from each cluster barrier, and its end."""
        return torch.zeros((self.blocks, 6 + 20 * self._shape[0]), dtype=torch.int64,
                           device=self.y.device)


# ---------------------------------------------------------- the verify pass
#
# The verify kernel (ops/csrc/decode_step_verify.cu) runs the step's chain
# for the K positions of a pass in one cluster of CLUSTER blocks, with its
# own matrix-vector stages (bf16 on the tensor cores: 16-column tiles of a
# block's weight piece against the K rows), attention items (head, chunk)
# that score all K queries, and its own buffers.  What it is handed besides
# pointers is computed here.

VERIFY_PAD = 8  # bf16 elements each weight row of the verify copy has more (16 bytes)
TILE = 16  # output columns of one tensor-core product (kTile)
TILE_COLS_MAX = 256  # columns of a bf16 verify piece, at most: a warp a tile
# keys of a verify attention chunk, at least (``verify_chunks``): fewer than
# a step's MIN_CHUNK, so that a pass's K queries over a prefix of a few
# hundred keys are scored by all the cluster's blocks, not by one a head
VERIFY_MIN_CHUNK = 64
VERIFY_BUFFERS = ("fresh", "stage", "flags")  # the pass's own buffers (VerifyBuffer)
MAX_SEGS = 16  # key segments of attention's value products, at most (kMaxSegs)
_MATRICES = ("pw1", "pw2", "sWqkv", "sWo", "cWq", "cWo", "W1", "W2", "head_w")


def verify_row_pad(itemsize: int) -> int:
    """Elements a weight row of the verify copy has more than its depth:
    ``VERIFY_PAD`` in bf16 (row_pad in the CUDA source), none in fp32."""
    return VERIFY_PAD if itemsize == 2 else 0


@torch.no_grad()
def pack_verify_weights(packed: dict) -> dict:
    """The verify kernel's copy of ``pack_decode_weights``' dict: in bf16
    each weight matrix (out, in) becomes (out, in + ``VERIFY_PAD``), zeros
    after each row, so that a row is an odd number of 16-byte chunks and the
    8 rows of a tensor-core load from the shared-memory ring fall in
    distinct banks; biases and LayerNorm parameters are the same tensors.
    fp32 needs no copy: the dict itself.  Made once per weights version
    (``infer.decode.DecodeWeights``), never per request."""
    pad = verify_row_pad(packed["pw1"].element_size())
    if not pad:
        return packed
    out = dict(packed)
    for k in _MATRICES:
        out[k] = torch.nn.functional.pad(packed[k], (0, pad)).contiguous()
    return out


def verify_piece_cols(k: int, itemsize: int) -> int:
    """Columns of a verify weight piece of depth k: as many rows (of
    ``k + verify_row_pad``) as ``VERIFY_PIECE_BYTES`` holds; in bf16 whole
    tiles of ``TILE`` columns (at most ``TILE_COLS_MAX``), or one tile where
    a tile takes up to 2 ``PIECE_BYTES``."""
    row = (k + verify_row_pad(itemsize)) * itemsize
    step = max(1, VERIFY_PIECE_BYTES // row)
    if itemsize == 2:
        if step >= TILE:
            return min(step - step % TILE, TILE_COLS_MAX)
        if TILE * row <= 2 * PIECE_BYTES:
            return TILE
    return step


def tile_split(n_cols: int, k: int) -> tuple:
    """(tiles, depth slices a tile) of a bf16 verify piece of ``n_cols``
    columns of depth k, as the kernel takes them: warp w < tiles x slices
    computes tile w // slices over the depth's 16-wide steps [s nk / slices,
    (s + 1) nk / slices) of slice s = w % slices (nk = k / 16), and the
    slices' partial sums are added in slice order."""
    tiles = -(-n_cols // TILE)
    return tiles, min(max(1, WARPS // tiles), k // TILE)


def verify_chunks(n_keys: int, n_heads: int, cluster: int = CLUSTER) -> tuple:
    """(keys per chunk, chunks) of a verify pass's attention over n_keys
    keys: its items (head, chunk) score every row's query, so the keys are
    cut as a step's of one row (``attn_chunks`` with one row)."""
    return attn_chunks(n_keys, 1, n_heads, cluster, VERIFY_MIN_CHUNK)


def verify_value_segments(k: int, dh: int) -> int:
    """Key segments of a verify attention item's value products: threads
    (segment, row, four columns) fill a block's ``THREADS``."""
    return min(max(1, THREADS // (k * dh // 4)), MAX_SEGS)


def verify_plan(n_layers: int, d: int, d_ffn: int, n_mels: int, d_out: int, k: int, r: int,
                n_heads: int, cap: int, tp: int, itemsize: int) -> tuple:
    """``decode_plan`` of the verify kernel: one cluster of ``CLUSTER``
    blocks whose rows are the K positions of a pass, over a cache of ``cap``
    positions; pieces of ``verify_piece_cols`` columns of rows padded by
    ``verify_row_pad``, and ``verify_smem_layout``.  Raises for a K, a head
    or (bf16) widths the kernel does not take, and with the layout's
    message when the plan does not fit a block."""
    if not 2 <= k <= MAX_BATCH or d_out != r * (n_mels + 1) or d_out > max(d, d_ffn):
        raise ValueError(f"decode_verify kernel takes 2 <= K <= {MAX_BATCH} and a head of "
                         f"r (n_mels + 1) <= max(d_model, d_ffn) columns; got K={k}, "
                         f"d_out={d_out}, r={r}")
    if itemsize == 2 and any(w % TILE for w in (d, d_ffn, n_mels)):
        raise ValueError(f"decode_verify kernel takes bf16 widths that are multiples of {TILE}; "
                         f"got (d, d_ffn, n_mels)={(d, d_ffn, n_mels)}")
    pad = verify_row_pad(itemsize)
    stages = gemv_stages(n_layers, d, d_ffn, n_mels, d_out)
    cols, pieces, bias, need = _block_pieces(
        stages, CLUSTER, lambda kk: (kk + pad) * itemsize,
        lambda kk: verify_piece_cols(kk, itemsize))
    layout = verify_smem_layout(
        k, n_layers, n_heads, d // n_heads, d_ffn, n_mels, cap, tp, itemsize, len(stages),
        max(map(len, pieces)), bias, need, max(c1 - c0 for st in cols for c0, c1 in st),
        max(p[3] for mine in pieces for p in mine))
    return _plan_rows(stages, cols, pieces, layout)


def verify_smem_layout(k: int, n_layers: int, n_heads: int, dh: int, d_ffn: int, n_mels: int,
                       cap: int, tp: int, itemsize: int, n_stages: int, n_pieces: int,
                       bias_floats: int, ring_need: int, block_cols: int, max_piece: int,
                       cluster: int = CLUSTER) -> dict:
    """Byte offsets of the verify kernel's shared-memory buffers, 16-byte
    aligned: the step's (``SMEM_BUFFERS``, sized for K rows and its own
    attention items: ``nc_max`` chunks a head at most, ``max_keys`` keys a
    chunk; ``act`` in bf16 with rows ``verify_row_pad`` longer, the inputs
    of prenet 2 and FFN 2; ``part`` is the larger of attention's rounded
    queries and partial sums (``verify_value_segments`` key segments of (K,
    dh)) and, in bf16, another stage's inputs in bf16 and two sets of 16
    partial tiles of K rows),
    then its own (``VERIFY_BUFFERS``); the ring takes what is left of
    ``SMEM_LIMIT``, at most ``ring_need``.  Raises when the ring cannot hold
    the largest piece and less than all of them."""
    d = n_heads * dh
    chunks = [verify_chunks(n, n_heads, cluster) for n in range(1, max(cap, tp) + 1)]
    ncm, max_keys = max(nc for _, nc in chunks), max(ln for ln, _ in chunks)
    items = -(-n_heads * ncm // cluster)  # (head, chunk) items a block, at most
    part = 4 * max(k * dh, verify_value_segments(k, dh) * k * dh)
    act = 4 * k * max(d, d_ffn)
    if itemsize == 2:  # the inputs of prenet 2 and FFN 2 in bf16 in act, the others in part
        pad = verify_row_pad(itemsize)
        part = max(part, 2 * k * (max(n_mels, d) + pad) + 4 * 2 * WARPS * TILE * k)
        act = 2 * k * (max(d, d_ffn) + pad)
    floats = {
        "red": (WARPS + 1) * 2 * (1 << (k - 1).bit_length()), "bias": bias_floats,
        "ln": 2 * 6 * d,
        "ra": k * d, "rb": k * d, "o": k * d, "q": k * d,
        "kv": 2 * k * d, "xs": k * max(d, n_mels),
        "pm": k * n_heads * ncm, "pl": k * n_heads * ncm, "ppos": 0,
        "pacc": k * n_heads * ncm * dh, "mloc": items * k, "posh": 0,
        "scores": items * k * max_keys,
        "fresh": n_heads * k * k, "stage": k * (block_cols + 8), "flags": 2 * k * cluster,
    }
    sizes = {"stages": 16 * n_stages, "pieces": 16 * n_pieces, "mbar": 8 * (n_pieces + n_layers + 1),
             "part": part, "act": act, **{name: 4 * v for name, v in floats.items()}}
    out, at = {}, 0
    for name in SMEM_BUFFERS[:-1] + VERIFY_BUFFERS:
        out[name] = at
        at += -(-sizes[name] // 16) * 16
    out["ring"] = at
    out["n_bias"], out["nc_max"], out["max_keys"] = bias_floats, ncm, max_keys
    out["ring_bytes"] = min((SMEM_LIMIT - at) // 16 * 16, -(-ring_need // 16) * 16)
    out["smem_bytes"] = at + max(out["ring_bytes"], 0)
    if out["ring_bytes"] < max_piece and out["ring_bytes"] < ring_need:
        raise ValueError(f"decode_verify: the kernel's buffers take {at} bytes of shared memory, "
                         f"too much of the {SMEM_LIMIT} a block may have")
    return out


def verify_launch_config(plan, packed: dict, weights: dict, k: int, n_heads: int, cap: int,
                         tp: int) -> tuple:
    """The verify kernel's ``Config`` for ``plan`` (``verify_plan``'s),
    ``packed`` (the widths and biases) and ``weights``
    (``pack_verify_weights(packed)``, its pointers), the plan's tensors it
    points to, and the byte offsets of ``VERIFY_BUFFERS`` (keep all alive):
    one cluster, B = 1 (the caches' one row, which every row of the pass
    reads), R = K, the cross-attention chunks of ``verify_chunks``, and the
    layout's ``nc_max`` and ``max_keys``."""
    tensors, cfg = _launch_config(plan, packed, CLUSTER, 1, k, n_heads, cap, tp, weights)
    layout = plan[2]
    cfg.cross_chunk, cfg.cross_nc = verify_chunks(tp, n_heads)
    cfg.nc_max, cfg.max_keys = layout["nc_max"], layout["max_keys"]
    voff = (ctypes.c_int * len(VERIFY_BUFFERS))(*[layout[b] for b in VERIFY_BUFFERS])
    return tensors, cfg, voff


def _verify_lib():
    """The verify kernel's library (``ops/csrc/decode_step_verify.cu``)."""
    from transformertts_tpu_torch import _build

    lib = _build.load("decode_step_verify")
    if not getattr(lib, "_argtypes_set", False):
        i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
        lib.tts_decode_verify.argtypes = [p, i, i, i, i] + [p] * 14 + [f, f, i, i, p, p, p]
        lib.tts_decode_verify.restype = i
        lib.tts_decode_step_config_bytes.restype = ctypes.c_long
        if lib.tts_decode_step_config_bytes() != ctypes.sizeof(_StepConfig):
            raise RuntimeError("decode_verify: _StepConfig does not mirror the CUDA Config")
        lib._argtypes_set = True
    return lib


class DecodeVerify:
    """The verify pass of speculative decoding for one utterance, prepared
    once per decode for fixed caches, weights and buffers.

        verify = DecodeVerify(self_k, self_v, cross_k, cross_v, packed, cross_bias,
                              pe_table, frames, stops, k=K, r=r, n_pos=n_pos, tau=tau,
                              stop_threshold=threshold, linear=True,
                              verify_weights=pack_verify_weights(packed))
        code = verify(t)  # (1,) int32 on the device: 2 m + vote

    ``self_k`` / ``self_v`` (L, H, 1, n_pos + K, dh) and ``cross_k`` /
    ``cross_v`` (L, H, 1, Tp, dh) in the kernel's layout, ``cross_bias``
    (1, Tp) fp32, ``pe_table`` (>= n_pos + K - 1, D) fp32 alpha * PE,
    ``frames`` (n_pos r + 1, n_mels) fp32 with the go frame at 0 and
    ``stops`` (n_pos r,) fp32: the decode's buffers of this utterance, which
    the pass writes (the accepted m groups' frames and stop logits) as it
    writes the caches (rows t .. t + K - 1).  ``y``, ``k_new``, ``v_new``
    hold the last pass's outputs (as ``decode_verify_reference``'s).
    ``verify_weights``: ``pack_verify_weights(packed)``, which the kernel
    reads; a caller that decodes more than once keeps it per weights version
    (made here when not given).

    On CUDA tensors each call is one C call and one launch of the verify
    kernel, or it raises: it never falls back.  2 <= K <= 8, bf16 widths
    multiples of 16, and the kernel's plan must fit a block
    (``verify_plan``: at ``configs/paper.yaml`` widths K <= 4).  On CPU
    tensors the call runs ``verify_pass_reference``.  ``launches`` counts
    this pass's launches, ``DecodeVerify.launches_total`` every
    instance's."""

    launches_total = 0

    def __init__(self, self_k, self_v, cross_k, cross_v, packed, cross_bias, pe_table, frames,
                 stops, *, k: int, r: int, n_pos: int, tau: float, stop_threshold: float,
                 linear: bool = True, verify_weights: dict | None = None):
        n_layers, n_heads, _, cap, dh = self_k.shape
        tp, dev = cross_k.shape[3], self_k.device
        d, d_ffn = n_heads * dh, packed["W1"].shape[1]
        n_mels, d_out = packed["pw1"].shape[1], packed["head_w"].shape[0]
        if cap < n_pos + k - 1 or pe_table.shape[0] < n_pos + k - 1:
            raise ValueError(f"decode_verify: a cache of {cap} positions and a PE table of "
                             f"{pe_table.shape[0]} rows cannot take K={k} from t={n_pos - 1}")
        if frames.shape[0] < n_pos * r + 1 or stops.shape[0] < n_pos * r:
            raise ValueError(f"decode_verify: buffers of {frames.shape[0]} frames and "
                             f"{stops.shape[0]} stops are short of n_pos={n_pos} groups of {r}")
        self.k, self.r, self.n_pos, self.linear = k, r, n_pos, linear
        self.tau, self.stop_threshold = float(np.float32(tau)), float(np.float32(stop_threshold))
        self._args = (self_k, self_v, cross_k, cross_v, packed, cross_bias, pe_table, frames, stops)
        self.launches = 0
        self.y = self.k_new = self.v_new = None
        if dev.type == "cpu":
            return
        _check_fixed_args(self_k, self_v, cross_k, cross_v, packed)
        itemsize = packed["pw1"].element_size()
        weights = pack_verify_weights(packed) if verify_weights is None else verify_weights
        pad = verify_row_pad(itemsize)
        shapes = _packed_shapes(n_layers, d, d_ffn, n_mels, d_out)
        _check_tensors({name: (weights[name], packed[name].dtype,
                               shapes[name][:-1] + (shapes[name][-1] + pad,))
                        for name in _MATRICES}, dev)
        _check_tensors({"cross_bias": (cross_bias, torch.float32, (1, tp)),
                        "pe_table": (pe_table, torch.float32, (pe_table.shape[0], d)),
                        "frames": (frames, torch.float32, (frames.shape[0], n_mels)),
                        "stops": (stops, torch.float32, (stops.shape[0],))}, dev)
        plan = verify_plan(n_layers, d, d_ffn, n_mels, d_out, k, r, n_heads, cap, tp, itemsize)
        lib = _verify_lib()
        self._plan, self._cfg, self._voff = verify_launch_config(plan, packed, weights, k,
                                                                 n_heads, cap, tp)
        self._weights = weights  # the pointers stay valid
        self.y = torch.empty((k, d_out), dtype=torch.float32, device=dev)
        self.k_new = torch.empty((n_layers, n_heads, k, dh), dtype=self_k.dtype, device=dev)
        self.v_new = torch.empty_like(self.k_new)
        self.code = torch.zeros((1,), dtype=torch.int32, device=dev)
        self._self_chunks = [verify_chunks(t, n_heads) for t in range(n_pos)]
        self.layout = plan[2]
        self._is_bf16 = int(packed["pw1"].dtype == torch.bfloat16)
        self._row = n_mels * 4  # bytes of a frame
        self._d4 = d * 4  # bytes of a PE row
        self._ptr = (frames.data_ptr(), stops.data_ptr(), pe_table.data_ptr())
        self._fixed = (cross_bias.data_ptr(), self_k.data_ptr(), self_v.data_ptr(),
                       cross_k.data_ptr(), cross_v.data_ptr(), self.y.data_ptr(),
                       self.k_new.data_ptr(), self.v_new.data_ptr())
        self._call = lib.tts_decode_verify
        self._shape = (n_layers, n_heads, dh, d_ffn, tp)

    def __call__(self, t: int, timeline=None) -> torch.Tensor:
        """The pass at position t: (1,) int32 2 m + vote, on the device.
        ``timeline``: a tensor from ``timeline_buffer`` that the kernel fills
        with global-timer stamps (``stage_times`` reads it)."""
        if not 0 <= t < self.n_pos:
            raise ValueError(f"t={t} outside the decode's {self.n_pos} positions")
        k, r = self.k, self.r
        if self._args[0].device.type == "cpu":
            out = verify_pass_reference(
                t, *self._args, k=k, r=r, n_pos=self.n_pos, tau=self.tau,
                stop_threshold=self.stop_threshold, linear=self.linear)
            self.y, self.k_new, self.v_new = out[1:]
            return out[0]
        frames, stops, pe = self._ptr
        f0 = frames + t * r * self._row
        prev = f0 - r * self._row if self.linear and t > 0 else f0
        chunk, nc = self._self_chunks[t]
        cb, sk, sv, ck, cv, y, kn, vn = self._fixed
        rc = self._call(
            ctypes.byref(self._cfg), self._is_bf16, t, chunk, nc, f0, prev, pe + t * self._d4,
            cb, sk, sv, ck, cv, y, kn, vn, f0 + self._row, stops + t * r * 4,
            self.code.data_ptr(), self.tau, self.stop_threshold, self.n_pos - t, r, self._voff,
            timeline.data_ptr() if timeline is not None else None,
            _current_stream(self.y.device))
        if rc != 0:
            n_layers, n_heads, dh, d_ffn, tp = self._shape
            raise RuntimeError(
                f"decode_verify kernel refused or failed to launch (CUDA error {rc}) for "
                f"K={k}, L={n_layers}, H={n_heads}, dh={dh}, d_ffn={d_ffn}, "
                f"n_pos={self.n_pos}, Tp={tp}, t={t}")
        DecodeVerify.launches_total += 1
        self.launches += 1
        return self.code

    def stages(self, t: int) -> list:
        """``step_stages`` of a pass at position t, then the acceptance."""
        return step_stages(self._shape[0], self._self_chunks[t][1], self._cfg.cross_nc) + [
            "accept"]

    def timeline_buffer(self) -> torch.Tensor:
        """Room for one pass's stamps (a step's and two for the acceptance's
        barrier, per block)."""
        return torch.zeros((CLUSTER, 8 + 20 * self._shape[0]), dtype=torch.int64,
                           device=self.y.device)


def step_stages(n_layers: int, self_nc: int, cross_nc: int) -> list:
    """Names of the kernel's stages, in order (a cluster barrier between
    each two), for ``self_nc`` / ``cross_nc`` key chunks a (row, head): an
    attention of one chunk is one stage, of several two (scores and their
    max, then the values against the global max)."""
    def attn(kind, nc, li):
        if nc == 0:
            return []
        return [f"{kind}_attn{li}"] if nc == 1 else [f"{kind}_scores{li}", f"{kind}_values{li}"]

    names = ["prenet1", "prenet2"]
    for li in range(n_layers):
        names += [f"qkv{li}", *attn("self", self_nc, li), f"self_out{li}", f"cross_q{li}",
                  *attn("cross", cross_nc, li), f"cross_out{li}", f"ffn1_{li}", f"ffn2_{li}"]
    return names + ["head"]


def stage_times(timeline: torch.Tensor, n_barriers: int) -> list:
    """(work us, wait us) of each stage from one call's ``timeline``: the
    work is the slowest block's time from the previous release (or the
    kernel's start) to its arrival; the wait the time from that last
    arrival to the latest release.  The last stage has no wait."""
    stamps = timeline.cpu().to(torch.float64) / 1e3
    start = stamps[:, 0]
    out = []
    for i in range(n_barriers + 1):
        arrive = stamps[:, 1 + 2 * i]
        work = float((arrive - start).max())
        if i == n_barriers:
            out.append((work, 0.0))
            break
        release = stamps[:, 2 + 2 * i]
        out.append((work, float(release.max() - arrive.max())))
        start = release
    return out


_prepared: "OrderedDict[tuple, DecodeStep]" = OrderedDict()  # decode_step's recent steps
_PREPARED_MAX = 8


def _prepared_step(self_k, self_v, cross_k, cross_v, packed, with_attn_pos) -> DecodeStep:
    """A ``DecodeStep`` for these tensors on the current stream, reused
    while the same tensors (pointers, shapes, dtypes) come back."""
    key = (_current_stream(self_k.device), with_attn_pos,
           *[(x.data_ptr(), x.shape, x.dtype, x.is_contiguous())
             for x in (self_k, self_v, cross_k, cross_v)],
           *[packed[k].data_ptr() for k in _PACK_ORDER])
    step = _prepared.get(key)
    if step is None:
        step = DecodeStep(self_k, self_v, cross_k, cross_v, packed, with_attn_pos)
        _prepared[key] = step
        if len(_prepared) > _PREPARED_MAX:
            _prepared.popitem(last=False)
    else:
        _prepared.move_to_end(key)
    return step


@torch.no_grad()
def decode_step(
    t: int,
    frame: torch.Tensor,
    pe_row: torch.Tensor,
    cross_bias: torch.Tensor,
    self_k: torch.Tensor,
    self_v: torch.Tensor,
    cross_k: torch.Tensor,
    cross_v: torch.Tensor,
    packed: dict,
    with_attn_pos: bool = False,
    prenet_dropout: float = 0.0,
    seed: int = 0,
    row0: int = 0,
):
    """One decoder step; arguments and results as ``decode_step_reference``.

    Writes the new K/V rows into ``self_k``/``self_v`` at position ``t``
    in place.  On CUDA tensors it launches the kernel once (or raises),
    through a ``DecodeStep`` kept for these tensors, into fresh outputs; on
    CPU tensors it runs the plain version.
    """
    n_layers, n_heads, b, n_pos, dh = self_k.shape
    if not 0 <= t < n_pos:
        raise ValueError(f"t={t} outside the cache of {n_pos} positions")
    if self_k.device.type == "cpu":
        out = decode_step_reference(
            t, frame, pe_row, cross_bias, self_k, self_v, cross_k, cross_v,
            packed, with_attn_pos, prenet_dropout, seed, row0,
        )
        self_k[:, :, :, t] = out[1]
        self_v[:, :, :, t] = out[2]
        return out
    step = _prepared_step(self_k, self_v, cross_k, cross_v, packed, with_attn_pos)
    dev = self_k.device
    y = torch.empty((b, packed["head_w"].shape[0]), dtype=torch.float32, device=dev)
    k_new = torch.empty((n_layers, n_heads, b, dh), dtype=self_k.dtype, device=dev)
    v_new = torch.empty_like(k_new)
    pos = torch.empty((b, 1), dtype=torch.float32, device=dev) if with_attn_pos else None
    return step(t, frame, pe_row, cross_bias, out=(y, k_new, v_new, pos),
                prenet_dropout=prenet_dropout, seed=seed, row0=row0)


decode_step.launches = 0  # kernel launches (B = 1 and B > 1)
decode_step.launches_batched = 0  # of which with B > 1 (the batched TPU kernel's role)
