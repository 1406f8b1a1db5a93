"""Fused multi-head attention, forward and backward with in-kernel dropout,
as hand-written CUDA kernels for Hopper.

Replaces the TPU kernels of ``transformertts_tpu/ops/pallas/flash_attention.py``:
``_fwd`` (``_fwd_kernel``) and ``_bwd`` (``_bwd_kernel``), entry
``flash_attention``.  The CUDA source is ``csrc/flash_attention.cu``.

    O = Dropout(softmax(Q K^T / sqrt(D) + key_bias (+ causal))) V

on q (B, Tq, H, D), k and v (B, Tk, H, D), key_bias (B, Tk) of 0 / -1e9; the
(Tq, Tk) score matrix never reaches device memory.  Where the TPU kernel
rounds, so do the kernel and the plain version here: 1/sqrt(D) rides on Q in
the storage dtype when it is a power of two, else on the fp32 scores; scores
and softmax in fp32; causal replaces the score by -1e9; the row sum ``l`` is
taken before dropout; ``e = exp(s - m)`` is cast to V's dtype unnormalised;
``1 / (l (1 - p))`` multiplies the fp32 output.  A row whose keys are all
padded comes out uniform, not NaN.

What bounds it on an H100 at the training path's shapes: bytes (Q, K, V
and O once), the products being light at the tensor cores' rate; what
stands in the way is the exp, masks and dropout hash of every score.  bf16
runs on the tensor cores (wgmma from swizzled bf16 tiles in shared memory,
K/V tiles by cp.async into a two-stage ring, key tiles that are masked or
all padded skipped; see the source); fp32 on the CUDA cores, whose fp32
arithmetic keeps the plain version's digits.  The forward keeps a running
maximum over key tiles (online softmax) and saves ``m`` and ``l``, which
the TPU backward recomputed; ``e`` is thus rounded against the running
maximum, one rounding of the storage dtype away from the plain version per
term, and not at all in fp32.  The backward is two kernels, each owning its
outputs (dQ per query tile, dK and dV per key tile): no atomics, the same
bits every run.

What the TPU shaped and this port keeps only as a number: the dropout mask
is keyed on (batch * head, q-block, local row, key) of the TPU kernel's
q-blocks (``pick_block``).  The CUDA kernel tiles as it likes and takes the
q-block height as an argument that shapes nothing but the mask.  Under data
and tensor parallelism (``parallel/``) a call sees some of the batch rows
and some of the heads; ``mask_bh = (b0, heads, h0)`` keys its mask on the
global index ``(b0 + b) * heads + h0 + h``, so that every rank drops what
the one-device call drops.

On CUDA tensors ``flash_attention`` launches the kernels or raises (head
dims other than 32 and 64, dtypes other than fp32 / bf16); the plain version
runs for CPU tensors, or on any device when the caller passes ``plain=True``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from transformertts_tpu_torch.ops.dropout_mask import keep_from_index, threshold_of


def pick_block(t: int, tk: int) -> int:
    """q-block height of the TPU kernel (``flash_attention.py:_pick_block``):
    the geometry the dropout mask is keyed on."""
    for cand in (1024, 768, 512, 384, 256, 128, 64, 32, 16, 8):
        if t % cand == 0 and cand * tk <= 620_000:
            return cand
    for cand in range(min(t, max(620_000 // max(tk, 1), 1)), 0, -1):
        if t % cand == 0:
            return cand
    return t


def _scale_is_exact(scale: float) -> bool:
    """True when ``scale`` is a power of two (multiplying by it is exact)."""
    return math.frexp(scale)[0] == 0.5


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of storage-dtype operands accumulated in fp32."""
    return a.float() @ b.float()


def _scores(q, k, bias, scale, causal):
    """fp32 (B, H, Tq, Tk) scores from (B, H, T, D) operands."""
    # imported here: the models package imports this module
    from transformertts_tpu_torch.models.masks import NEG_INF

    fold = _scale_is_exact(scale)
    qs = q * torch.tensor(scale, dtype=q.dtype, device=q.device) if fold else q
    s = _dot(qs, k.transpose(-1, -2))
    if not fold:
        s = s * scale
    s = s + bias.float()[:, None, None, :]
    if causal:
        tq, tk = s.shape[-2:]
        row = torch.arange(tq, device=s.device)[:, None]
        col = torch.arange(tk, device=s.device)[None, :]
        s = torch.where(col <= row, s, torch.full_like(s, NEG_INF))
    return s


def _keep(shape, seed, dropout, block_q, device, mask_bh=None):
    """The (B, H, Tq, Tk) keep mask of one call, in the TPU kernel's geometry;
    ``mask_bh = (b0, heads, h0)`` places the call's rows and heads in the
    global batch and head count (default: the call is the whole)."""
    b, h, tq, tk = shape
    b0, heads, h0 = mask_bh or (0, h, 0)
    rows = torch.arange(b0, b0 + b, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(h0, h0 + h, dtype=torch.int64, device=device)[None, :]
    bh = (rows * heads + cols).reshape(b, h, 1, 1)
    row = torch.arange(tq, dtype=torch.int64, device=device)[:, None]
    col = torch.arange(tk, dtype=torch.int64, device=device)[None, :]
    return keep_from_index((row % block_q) * tk + col, bh * 8192 + row // block_q, seed, dropout)


def flash_attention_reference(q, k, v, bias, seed, scale, causal, dropout, block_q,
                              mask_bh=None):
    """Plain version of the forward kernel on (B, H, T, D) operands: the
    output in q's dtype and the softmax statistics m, l (B, H, Tq) fp32."""
    s = _scores(q, k, bias, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(dim=-1, keepdim=True)
    if dropout > 0.0:
        keep = _keep(s.shape, seed, dropout, block_q, s.device, mask_bh)
        e = torch.where(keep, e, torch.zeros_like(e))
        norm = 1.0 / (l * (1.0 - dropout))
    else:
        norm = 1.0 / l
    out = _dot(e.to(v.dtype), v) * norm
    return out.to(q.dtype), m[..., 0], l[..., 0]


def flash_attention_backward_reference(q, k, v, bias, seed, out, dout, m, l, scale, causal,
                                       dropout, block_q, mask_bh=None):
    """Plain version of the backward kernels on (B, H, T, D) operands."""
    s = _scores(q, k, bias, scale, causal)
    e = torch.exp(s - m[..., None])
    r = 1.0 / l[..., None]
    dp_tilde = _dot(dout, v.transpose(-1, -2))
    if dropout > 0.0:
        keep = _keep(s.shape, seed, dropout, block_q, s.device, mask_bh)
        inv = 1.0 / (1.0 - dropout)
        e_dropped = torch.where(keep, e, torch.zeros_like(e))
        do_scaled = (dout.float() * (r * inv)).to(dout.dtype)
        dp = torch.where(keep, dp_tilde * inv, torch.zeros_like(e))
    else:
        e_dropped = e
        do_scaled = (dout.float() * r).to(dout.dtype)
        dp = dp_tilde
    dv = _dot(e_dropped.to(dout.dtype).transpose(-1, -2), do_scaled)
    delta = (dout.float() * out.float()).sum(dim=-1, keepdim=True)
    ds0 = (e * (dp - delta)).to(q.dtype)
    rs = r * scale
    dq = _dot(ds0, k) * rs
    q_scaled = (q.float() * rs).to(q.dtype)
    dk = _dot(ds0.transpose(-1, -2), q_scaled)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _lib():
    from transformertts_tpu_torch import _build

    lib = _build.load("flash_attention")
    if not getattr(lib, "_argtypes_set", False):
        i, u, f, p = ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_void_p
        tail = [f, i, i, i, f, f, u, u, i, i, i, i, p]
        lib.tts_flash_fwd.argtypes = [i] * 6 + [p] * 8 + tail
        lib.tts_flash_bwd.argtypes = [i] * 6 + [p] * 13 + tail
        lib.tts_flash_shared_bytes.argtypes = [i, i, i, i, p]
        lib.tts_flash_fwd.restype = lib.tts_flash_bwd.restype = i
        lib.tts_flash_shared_bytes.restype = i
        lib._argtypes_set = True
    return lib


def _check_cuda_args(q, k, v, bias):
    """Raise unless the kernels can read these.  q, k, v may be strided
    views (a fused q|k|v projection split in place) as long as the head
    dimension is dense and every stride a multiple of 16 bytes."""
    b, tq, h, d = q.shape
    tk = k.shape[1]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention kernel takes float32 or bfloat16, got {q.dtype}")
    if d not in (32, 64):
        raise ValueError(f"flash attention kernel takes head dims 32 and 64, got {d}")
    if b * h > 65535:
        raise ValueError(f"flash attention kernel takes batch * heads <= 65535, got {b * h}")
    vec = 16 // q.element_size()
    for name, t, shape in (("q", q, (b, tq, h, d)), ("k", k, (b, tk, h, d)),
                           ("v", v, (b, tk, h, d))):
        if (t.dtype != q.dtype or tuple(t.shape) != shape or t.device != q.device
                or t.stride(3) != 1 or any(s % vec for s in t.stride()[:3])
                or t.data_ptr() % 16):
            raise ValueError(
                f"flash attention: {name} must be a {q.dtype} of shape {shape} on {q.device} "
                f"with a dense last axis and 16-byte aligned rows, got {t.dtype} "
                f"{tuple(t.shape)} strides {t.stride()} on {t.device}")
    if (bias.dtype != torch.float32 or tuple(bias.shape) != (b, tk) or bias.device != q.device
            or not bias.is_contiguous()):
        raise ValueError(f"flash attention: key_bias must be a contiguous float32 ({b}, {tk})")


def _kernel_args(q, k, v, bias, seed, scale, causal, dropout, block_q, mask_bh):
    b, tq, h, d = q.shape
    strides = (ctypes.c_longlong * 9)(*[t.stride(i) for t in (q, k, v) for i in (0, 1, 2)])
    head = (int(q.dtype == torch.bfloat16), b, h, tq, k.shape[1], d,
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            ctypes.cast(strides, ctypes.c_void_p), bias.data_ptr())
    on = dropout > 0.0
    tail = (scale, int(_scale_is_exact(scale)), int(causal), int(on),
            1.0 - dropout if on else 1.0, 1.0 / (1.0 - dropout) if on else 1.0,
            threshold_of(dropout), seed, block_q, *(mask_bh or (0, h, 0)),
            torch.cuda.current_stream(q.device).cuda_stream)
    return head, tail


def flash_forward(q, k, v, bias, seed, scale, causal, dropout, block_q, mask_bh=None):
    """The forward kernel on CUDA tensors in the public (B, T, H, D) layout:
    (out, m, l), or raises."""
    _check_cuda_args(q, k, v, bias)
    b, tq, h, d = q.shape
    out = torch.empty((b, tq, h, d), dtype=q.dtype, device=q.device)
    m = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    head, tail = _kernel_args(q, k, v, bias, seed, scale, causal, dropout, block_q, mask_bh)
    rc = _lib().tts_flash_fwd(*head, out.data_ptr(), m.data_ptr(), l.data_ptr(), *tail)
    if rc != 0:
        raise RuntimeError(
            f"flash attention forward kernel failed to launch (CUDA error {rc}) for "
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype}")
    flash_attention.launches_fwd += 1
    return out, m, l


def flash_backward(q, k, v, bias, seed, out, dout, m, l, scale, causal, dropout, block_q,
                   mask_bh=None):
    """The backward kernels (delta, dQ, dK/dV behind one entry point) on
    CUDA tensors in the public layout: (dq, dk, dv), or raises."""
    _check_cuda_args(q, k, v, bias)
    for name, t in (("out", out), ("dout", dout)):
        if t.dtype != q.dtype or t.shape != q.shape or not t.is_contiguous():
            raise ValueError(f"flash attention backward: {name} must be a contiguous "
                             f"{q.dtype} of shape {tuple(q.shape)}")
    dq, dk, dv = (torch.empty(x.shape, dtype=x.dtype, device=x.device) for x in (q, k, v))
    delta = torch.empty_like(m)
    head, tail = _kernel_args(q, k, v, bias, seed, scale, causal, dropout, block_q, mask_bh)
    rc = _lib().tts_flash_bwd(
        *head, out.data_ptr(), dout.data_ptr(), m.data_ptr(), l.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *tail)
    if rc != 0:
        raise RuntimeError(
            f"flash attention backward kernels failed to launch (CUDA error {rc}) "
            f"for q {tuple(q.shape)}, k {tuple(k.shape)}, {q.dtype}")
    flash_attention.launches_bwd += 1
    return dq, dk, dv


class _Flash(torch.autograd.Function):
    """q, k, v in the public (B, T, H, D) layout."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, scale, causal, dropout, block_q, mask_bh, plain):
        ctx.args = (seed, scale, causal, dropout, block_q, mask_bh, plain)
        if plain or q.device.type == "cpu":
            out, m, l = flash_attention_reference(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), bias, seed, scale,
                causal, dropout, block_q, mask_bh)
            out = out.transpose(1, 2).contiguous()
        else:
            out, m, l = flash_forward(q, k, v, bias, seed, scale, causal, dropout, block_q,
                                      mask_bh)
        ctx.save_for_backward(q, k, v, bias, out, m, l)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, out, m, l = ctx.saved_tensors
        seed, scale, causal, dropout, block_q, mask_bh, plain = ctx.args
        if plain or q.device.type == "cpu":
            t = lambda x: x.transpose(1, 2)  # noqa: E731
            dq, dk, dv = flash_attention_backward_reference(
                t(q), t(k), t(v), bias, seed, t(out), t(dout), m, l, scale, causal, dropout,
                block_q, mask_bh)
            dq, dk, dv = t(dq), t(dk), t(dv)
        else:
            dq, dk, dv = flash_backward(q, k, v, bias, seed, out, dout.contiguous(), m, l,
                                        scale, causal, dropout, block_q, mask_bh)
        return dq, dk, dv, None, None, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, Tq, H, D)
    k: torch.Tensor,  # (B, Tk, H, D)
    v: torch.Tensor,  # (B, Tk, H, D)
    key_bias: torch.Tensor | None = None,  # (B, Tk) additive, 0 / -1e9
    causal: bool = False,
    dropout: float = 0.0,
    seed: int = 0,
    block_q: int | None = None,
    plain: bool = False,
    mask_bh: tuple[int, int, int] | None = None,
) -> torch.Tensor:
    """Fused attention; differentiable in q, k, v; returns (B, Tq, H, D).

    ``seed`` is the int32 seed of this call's dropout mask
    (``seed_from_generator``); ``block_q`` the mask's q-block height, by
    default the TPU kernel's (``pick_block``); ``mask_bh = (b0, heads, h0)``
    the call's first batch row, the global head count and its first head
    (default ``(0, H, 0)``).  ``plain=True`` asks for the plain version
    whatever the device."""
    b, tq, _, d = q.shape
    tk = k.shape[1]
    if key_bias is None:
        key_bias = torch.zeros((b, tk), dtype=torch.float32, device=q.device)
    if block_q is None:
        block_q = pick_block(tq, tk)
    if mask_bh is not None:
        mask_bh = tuple(int(i) for i in mask_bh)
    return _Flash.apply(q, k, v, key_bias.float().contiguous(), int(seed), d ** -0.5,
                        bool(causal), float(dropout), int(block_q), mask_bh, bool(plain))


flash_attention.launches_fwd = 0  # forward kernel launches
flash_attention.launches_bwd = 0  # backward launches (delta, dQ and dK/dV kernels together)
