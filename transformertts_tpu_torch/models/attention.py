"""Multi-head attention, torch-MHA semantics (``transformertts_tpu/models/attention.py``).

The plain path of the JAX module: fp32 scores and softmax whatever the
compute dtype, optional per-head weight capture (the alignments), and the
projections exposed on their own so the KV-cached decoder can build its
caches once.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from transformertts_tpu_torch.models.initializers import torch_linear_, xavier_uniform_
from transformertts_tpu_torch.models.masks import causal_bias
from transformertts_tpu_torch.models.modules import Linear


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
):
    """softmax(q k^T / sqrt(dh) + bias) v with the products of the operands
    accumulated in fp32 (``preferred_element_type=float32`` in JAX)."""
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        scores = scores + bias.float()
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum(
        "bhqk,bkhd->bqhd", weights.to(v.dtype).float(), v.float()
    ).to(v.dtype)
    return out, (weights if return_weights else None)


class MultiHeadAttention(nn.Module):
    """torch nn.MultiheadAttention equivalent (batch_first, same-dim QKV):
    xavier-uniform in-projections, torch-Linear out-projection, zero biases."""

    def __init__(self, d_model: int, n_heads: int, dtype=torch.float32, device=None):
        super().__init__()
        self.n_heads = n_heads
        self.dtype = dtype
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

    def project_kv(self, kv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """K/V projections split into heads — used to prebuild decode caches."""
        k = split_heads(self.k_proj(kv, self.dtype), self.n_heads)
        v = split_heads(self.v_proj(kv, self.dtype), self.n_heads)
        return k, v

    def attend(
        self,
        q_in: torch.Tensor,
        k: torch.Tensor,
        v: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
        return_weights: bool = False,
        key_bias: Optional[torch.Tensor] = None,  # (B, Tk) additive
        causal: bool = False,
    ):
        """Attention with already-projected K/V (the KV-cache path)."""
        q = split_heads(self.q_proj(q_in, self.dtype), self.n_heads)
        if key_bias is not None or causal:
            extra = key_bias[:, None, None, :] if key_bias is not None else None
            if causal:
                cb = causal_bias(q.shape[1], device=q.device)
                extra = cb if extra is None else extra + cb
            bias = extra if bias is None else bias + extra
        out, w = dot_product_attention(q, k, v, bias, return_weights)
        return self.out_proj(merge_heads(out), self.dtype), w

    def forward(
        self,
        q_in: torch.Tensor,
        kv_in: torch.Tensor,
        bias: Optional[torch.Tensor] = None,
        return_weights: bool = False,
        key_bias: Optional[torch.Tensor] = None,
        causal: bool = False,
    ):
        k, v = self.project_kv(kv_in)
        return self.attend(q_in, k, v, bias, return_weights, key_bias, causal)
