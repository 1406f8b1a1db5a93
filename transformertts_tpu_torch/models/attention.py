"""Multi-head attention, torch-MHA semantics (``transformertts_tpu/models/attention.py``).

Two compute paths, as in the JAX module:

- the plain path: fp32 scores and softmax whatever the compute dtype,
  optional per-head weight capture (the alignments), attention-weight
  dropout from an explicit generator in training;
- the flash path (``ops/flash_attention.py``, ``use_flash=True``): the
  fused kernel, forward and backward with in-kernel dropout, taken whenever
  no weights are asked for and the masking comes as ``key_bias`` / ``causal``
  rather than as a raw 4-D ``bias``.  On CUDA tensors that is the CUDA
  kernel; ``plain_ops=True`` asks for its plain PyTorch version instead.

The projections are exposed on their own so the KV-cached decoder can build
its caches once.

Under tensor parallelism (``parallel/mesh.py``) the module holds
``n_heads / n_model`` heads: the input is entered once (f, or a gather on
time under sequence parallelism), the out-projection's partial product
leaves through one all-reduce (or a reduce-scatter on time), and its bias
is added after it.  A cross-attention's ``kv_in`` comes entered already
(``Decoder.forward`` enters the memory once for all its layers).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from transformertts_tpu_torch.models.initializers import torch_linear_, xavier_uniform_
from transformertts_tpu_torch.models.masks import causal_bias
from transformertts_tpu_torch.models.modules import DropoutRng, Linear, dropout
from transformertts_tpu_torch.ops.flash_attention import flash_attention
from transformertts_tpu_torch.parallel.mesh import SINGLE


def split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, t, h, dh = x.shape
    return x.reshape(b, t, h * dh)


def dot_product_attention(
    q: torch.Tensor,  # (B, Tq, H, Dh)
    k: torch.Tensor,  # (B, Tk, H, Dh)
    v: torch.Tensor,  # (B, Tk, H, Dh)
    bias: Optional[torch.Tensor],  # broadcastable to (B, H, Tq, Tk)
    return_weights: bool = False,
    dropout_rate: float = 0.0,
    train: bool = False,
    rng: Optional[DropoutRng] = None,
    layout=SINGLE,
):
    """softmax(q k^T / sqrt(dh) + bias) v with the products of the operands
    accumulated in fp32 (``preferred_element_type=float32`` in JAX).  The
    returned weights are those before dropout; on a sharded ``layout`` the
    batch rows and heads are this rank's part."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    weights = torch.softmax(scores, dim=-1)
    dropped = dropout(weights, dropout_rate, train, rng, layout, ("data", "model"))
    out = torch.einsum(
        "bhqk,bkhd->bqhd", dropped.to(v.dtype).float(), v.float()
    ).to(v.dtype)
    return out, (weights if return_weights else None)


class MultiHeadAttention(nn.Module):
    """torch nn.MultiheadAttention equivalent (batch_first, same-dim QKV):
    xavier-uniform in-projections, torch-Linear out-projection, zero biases.

    ``fuse_qkv`` runs the in-projections as ONE matmul over the concatenated
    weights (q|k|v for self-attention, k|v for cross-attention); parameters
    and results are those of the separate projections.
    """

    layout = SINGLE

    def __init__(self, d_model: int, n_heads: int, dropout: float = 0.0, dtype=torch.float32,
                 use_flash: bool = False, fuse_qkv: bool = False, plain_ops: bool = False,
                 device=None):
        super().__init__()
        self.n_heads = n_heads
        self.dropout = dropout
        self.dtype = dtype
        self.use_flash = use_flash
        self.fuse_qkv = fuse_qkv
        self.plain_ops = plain_ops
        self.q_proj = Linear(d_model, d_model, device=device)
        self.k_proj = Linear(d_model, d_model, device=device)
        self.v_proj = Linear(d_model, d_model, device=device)
        self.out_proj = Linear(d_model, d_model, device=device)

    def reset_parameters(self, generator) -> None:
        for p in (self.q_proj, self.k_proj, self.v_proj):
            xavier_uniform_(p.weight, generator)
            nn.init.zeros_(p.bias)
        torch_linear_(self.out_proj.weight, generator)
        nn.init.zeros_(self.out_proj.bias)

    @property
    def heads(self) -> int:
        """The heads this rank holds."""
        return self.n_heads // self.layout.mesh.n_model

    def project_kv(self, kv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """K/V projections split into heads — used to prebuild decode caches."""
        k = split_heads(self.k_proj(kv, self.dtype), self.heads)
        v = split_heads(self.v_proj(kv, self.dtype), self.heads)
        return k, v

    def _fused_in_proj(self, x: torch.Tensor, projections) -> list[torch.Tensor]:
        """One matmul over the row-concatenated (out, in) weights; the heads
        of each projection come back as strided views of its result."""
        w = torch.cat([p.weight for p in projections]).to(self.dtype)
        b = torch.cat([p.bias for p in projections]).to(self.dtype)
        y = x.to(self.dtype) @ w.t() + b
        return [split_heads(t, self.heads) for t in y.split(projections[0].weight.shape[0], dim=-1)]

    def attend(
        self,
        q_in: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
        return_weights: bool = False,
        key_bias: Optional[torch.Tensor] = None,  # (B, Tk) additive
        causal: bool = False,
        train: bool = False,
        rng: Optional[DropoutRng] = None,
    ):
        """Attention with already-projected K/V (the KV-cache path)."""
        q = split_heads(self.q_proj(q_in, self.dtype), self.heads)
        return self._attend_heads(q, k, v, bias, return_weights, key_bias, causal, train, rng)

    def _attend_heads(self, q, k, v, bias=None, return_weights=False, key_bias=None,
                      causal=False, train=False, rng=None):
        rate = self.dropout if train else 0.0
        if self.use_flash and not return_weights and bias is None:
            if rate > 0.0 and rng is None:
                raise ValueError("train-mode attention dropout needs a DropoutRng")
            out = flash_attention(
                q, k, v, key_bias, causal=causal, dropout=rate,
                seed=rng.kernel_seed(rate) if rate > 0.0 else 0, plain=self.plain_ops,
                mask_bh=self._mask_bh(q),
            )
            return self._out(merge_heads(out)), None

        if key_bias is not None or causal:
            extra = key_bias[:, None, None, :] if key_bias is not None else None
            if causal:
                cb = causal_bias(q.shape[1], device=q.device)
                extra = cb if extra is None else extra + cb
            bias = extra if bias is None else bias + extra
        out, w = dot_product_attention(q, k, v, bias, return_weights, rate, train, rng,
                                       self.layout)
        return self._out(merge_heads(out)), w

    def _mask_bh(self, q):
        """Where this rank's batch rows and heads lie in the flash kernel's
        global dropout mask."""
        b0 = self.layout.span("data", q.shape[0])[1]
        return b0, self.n_heads, self.layout.span("model", q.shape[2])[1]

    def _out(self, o):
        """The out-projection; under tensor parallelism its partial product
        is summed over the model ranks before the bias."""
        y = o.to(self.dtype) @ self.out_proj.weight.to(self.dtype).t()
        return self.layout.exit(y) + self.out_proj.bias.to(self.dtype)

    def forward(
        self,
        q_in: torch.Tensor,
        kv_in: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
        return_weights: bool = False,
        key_bias: Optional[torch.Tensor] = None,
        causal: bool = False,
        train: bool = False,
        rng: Optional[DropoutRng] = None,
    ):
        self_attn = q_in is kv_in
        q_in = self.layout.enter(q_in)
        if self_attn:
            kv_in = q_in
        if self.fuse_qkv:
            if self_attn:  # self-attention: q|k|v in one matmul
                q, k, v = self._fused_in_proj(q_in, (self.q_proj, self.k_proj, self.v_proj))
            else:  # cross-attention: k|v fused, q separate
                q = split_heads(self.q_proj(q_in, self.dtype), self.heads)
                k, v = self._fused_in_proj(kv_in, (self.k_proj, self.v_proj))
            return self._attend_heads(q, k, v, bias, return_weights, key_bias, causal, train, rng)
        k, v = self.project_kv(kv_in)
        return self.attend(q_in, k, v, bias, return_weights, key_bias, causal, train, rng)
