"""One whole decoder step as a hand-written CUDA kernel chain for Hopper.

Replaces both TPU decode-step kernels of the JAX package:

- ``transformertts_tpu/ops/pallas/decode_step.py:decode_step`` (``_kernel``,
  batch 1), and
- ``decode_step_batched`` (``_kernel_batched``, B <= 8).

One code path serves 1 <= B <= 8 (the batch is a template parameter of
the CUDA source, ``ops/csrc/decode_step.cu``).  The step is

    prenet -> + alpha*PE[t] -> L x [cached self-attention, the current
    position folded in closed form -> + residual, LN1 -> cross-attention
    with an additive key bias -> + residual, LN2 -> FFN -> + residual,
    LN3] -> fused mel|stop head

with bf16 (or fp32) operands and fp32 accumulation, q scaled in fp32 then
cast, fp32 softmax and LayerNorm (``E[x^2] - mu^2`` clamped at 0), and x
cast to the compute type after each sublayer while the residual stays
fp32 — the numerics of ``_kernel``.

What bounds it on an H100: bytes.  Every step reads all decoder weights
(about 2.87 M parameters, 5.7 MB in bf16 at d_model 256, 3 layers, d_ffn
1024) plus, per batch row, the self-attention cache prefix (3,072 bytes
per position in bf16) and the cross-attention cache (3,072 bytes per
encoder position).  At 3.35 TB/s that is 1.7 us for the weights; the
arithmetic (2 FLOPs per weight per row) is far below the tensor-core
roofline.  The weights do not fit in one SM's 227 KB of shared memory, so
the step is a short chain of kernels launched from ONE C entry point (one
Python call per step): multi-block GEMVs with one warp per output column
reading the column's weight row in 16-byte vectors, an attention kernel
with one block per (row, head) that reads only its own row's cache, and
LayerNorm fused into the prologue of the GEMV that consumes it.  A single persistent kernel with grid-wide sync is the later, faster
form (ROADMAP).

What the TPU shaped and this port drops: the batched TPU kernel flattened
the caches to (L, H, B*T, dh) and scored every row against every row's
cache under a block-diagonal bias (``expand_cross_bias``); here each row
attends to its own (L, H, B, T, dh) segment and the kernel takes the
(B, Tp) cross bias directly.  The TPU's per-head weight splits on leading
dims become plain (out, in) row-major matrices, q|k|v fused into one.

The kernel writes the new K/V rows straight into the self-attention
caches at position ``t``, in place, and also returns them.  The wrapper
does the same on the CPU path, so both devices leave the caches alike.
"""

from __future__ import annotations

import ctypes

import torch

from transformertts_tpu_torch.models.masks import NEG_INF

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
):
    """Plain PyTorch version of the kernel, op for op as the TPU ``_kernel``.

    Pure: returns (y (B, n_mels*r + r) fp32, k_new (L, H, B, dh),
    v_new (L, H, B, dh)) and, with ``with_attn_pos``, the last layer's
    head-averaged expected cross-attention position (B, 1) fp32.  Products
    of ``dtype`` operands are summed in fp32, as
    ``preferred_element_type=float32`` does.
    """
    n_layers, n_heads, b, n_pos, dh = self_k.shape
    d = n_heads * dh
    dtype = packed["pw1"].dtype
    scale = dh ** -0.5
    p = packed

    def dot(a, w):  # w (out, in)
        return a.to(dtype).float() @ w.float().t()

    x = frame.to(dtype)
    x = torch.relu(dot(x, p["pw1"]) + p["pb1"].float())
    x = torch.relu(dot(x, p["pw2"]) + p["pb2"].float())
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
    The C entry point checks the rest (shared memory per block)."""
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
        "frame": (frame, torch.float32, (b, n_mels)),
        "pe_row": (pe_row, torch.float32, (1, d)),
        "cross_bias": (cross_bias, torch.float32, (b, tp)),
        "self_k": (self_k, dtype, tuple(self_k.shape)),
        "self_v": (self_v, dtype, tuple(self_k.shape)),
        "cross_k": (cross_k, dtype, (n_layers, n_heads, b, tp, dh)),
        "cross_v": (cross_v, dtype, (n_layers, n_heads, b, tp, dh)),
    }
    for k, shape in _packed_shapes(n_layers, d, d_ffn, n_mels, d_out).items():
        expect[k] = (packed[k], torch.float32 if k.startswith("ln_") else dtype, shape)
    for name, (x, dt, shape) in expect.items():
        if x.dtype != dt or not x.is_contiguous() or tuple(x.shape) != shape:
            raise ValueError(f"decode_step: {name} must be a contiguous {dt} of shape {shape}, "
                             f"got {x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    for name, (x, _, _) in expect.items():
        if x.device.type != "cuda" or x.device != self_k.device:
            raise ValueError(f"decode_step: {name} is on {x.device}, caches on {self_k.device}")


def _lib():
    from transformertts_tpu_torch import _build

    lib = _build.load("decode_step")
    if not getattr(lib, "_argtypes_set", False):
        i, p = ctypes.c_int, ctypes.c_void_p
        lib.tts_decode_step.argtypes = [i] * 11 + [p] * 14
        lib.tts_decode_step.restype = ctypes.c_int
        lib.tts_decode_step_scratch_floats.argtypes = [i, i, i, i]
        lib.tts_decode_step_scratch_floats.restype = ctypes.c_long
        lib._argtypes_set = True
    return lib


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
):
    """One decoder step; arguments and results as ``decode_step_reference``.

    Writes the new K/V rows into ``self_k``/``self_v`` at position ``t``
    in place.  On CUDA tensors it launches the kernel (or raises); on CPU
    tensors it runs the plain version.
    """
    n_layers, n_heads, b, n_pos, dh = self_k.shape
    if not 0 <= t < n_pos:
        raise ValueError(f"t={t} outside the cache of {n_pos} positions")
    if self_k.device.type == "cpu":
        out = decode_step_reference(
            t, frame, pe_row, cross_bias, self_k, self_v, cross_k, cross_v,
            packed, with_attn_pos,
        )
        self_k[:, :, :, t] = out[1]
        self_v[:, :, :, t] = out[2]
        return out
    _check_cuda_args(frame, pe_row, cross_bias, self_k, self_v, cross_k, cross_v, packed)
    lib = _lib()
    dev = self_k.device
    d_out = packed["head_w"].shape[0]
    d_ffn = packed["W1"].shape[1]
    y = torch.empty((b, d_out), dtype=torch.float32, device=dev)
    k_new = torch.empty((n_layers, n_heads, b, dh), dtype=self_k.dtype, device=dev)
    v_new = torch.empty_like(k_new)
    pos = torch.empty((b, 1), dtype=torch.float32, device=dev) if with_attn_pos else None
    scratch = torch.empty(
        lib.tts_decode_step_scratch_floats(b, n_heads, dh, d_ffn),
        dtype=torch.float32, device=dev,
    )
    weights = (ctypes.c_void_p * len(_PACK_ORDER))(*[packed[k].data_ptr() for k in _PACK_ORDER])
    rc = lib.tts_decode_step(
        int(packed["pw1"].dtype == torch.bfloat16), b, n_layers, n_heads, dh, d_ffn,
        packed["pw1"].shape[1], d_out, n_pos, cross_k.shape[3], t,
        frame.data_ptr(), pe_row.data_ptr(), cross_bias.data_ptr(),
        self_k.data_ptr(), self_v.data_ptr(), cross_k.data_ptr(), cross_v.data_ptr(),
        ctypes.cast(weights, ctypes.c_void_p),
        y.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
        pos.data_ptr() if pos is not None else None,
        scratch.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"decode_step kernel refused or failed to launch (CUDA error {rc}) for B={b}, "
            f"L={n_layers}, H={n_heads}, dh={dh}, d_ffn={d_ffn}, n_pos={n_pos}, "
            f"Tp={cross_k.shape[3]}"
        )
    decode_step.launches += 1
    if b > 1:
        decode_step.launches_batched += 1
    return (y, k_new, v_new) + ((pos,) if with_attn_pos else ())


decode_step.launches = 0  # kernel launches (B = 1 and B > 1)
decode_step.launches_batched = 0  # of which with B > 1 (the batched TPU kernel's role)
