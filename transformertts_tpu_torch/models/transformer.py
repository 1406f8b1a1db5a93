"""Post-LN Transformer encoder/decoder stacks (``transformertts_tpu/models/transformer.py``).

  encoder layer:  x = LN1(x + SelfAttn(x));  x = LN2(x + FFN(x))
  decoder layer:  x = LN1(x + SelfAttn(x, causal+pad))
                  x = LN2(x + CrossAttn(x, memory, mem-pad))  [weights kept]
                  x = LN3(x + FFN(x))

Inference semantics (dropout off).  LayerNorm eps 1e-5, fp32 statistics.
"""

from __future__ import annotations

import torch
from torch import nn

from transformertts_tpu_torch.models.attention import MultiHeadAttention
from transformertts_tpu_torch.models.initializers import torch_linear_
from transformertts_tpu_torch.models.modules import LayerNorm, Linear


class FeedForward(nn.Module):
    def __init__(self, d_model: int, d_ffn: int, dtype=torch.float32, device=None):
        super().__init__()
        self.Dense_0 = Linear(d_model, d_ffn, device=device)
        self.Dense_1 = Linear(d_ffn, d_model, device=device)
        self.dtype = dtype

    def reset_parameters(self, generator) -> None:
        for dense in (self.Dense_0, self.Dense_1):
            fan_in = dense.weight.shape[1]
            torch_linear_(dense.weight, generator)
            torch_linear_(dense.bias, generator, fan_in=fan_in)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Dense_1(torch.relu(self.Dense_0(x, self.dtype)), self.dtype)


class EncoderLayer(nn.Module):
    def __init__(self, d_model, n_heads, d_ffn, dtype=torch.float32, device=None):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_heads, dtype, device=device)
        self.ffn = FeedForward(d_model, d_ffn, dtype, device=device)
        self.norm1 = LayerNorm(d_model, dtype, device=device)
        self.norm2 = LayerNorm(d_model, dtype, device=device)

    def forward(self, x, key_bias=None):
        sa, _ = self.self_attn(x, x, key_bias=key_bias)
        x = self.norm1(x + sa)
        return self.norm2(x + self.ffn(x))


class Encoder(nn.Module):
    def __init__(self, n_layers, d_model, n_heads, d_ffn, dtype=torch.float32, device=None):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            setattr(self, f"layer_{i}", EncoderLayer(
                d_model, n_heads, d_ffn, dtype, device=device))

    def forward(self, x, key_bias=None):
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, key_bias)
        return x


class DecoderLayer(nn.Module):
    def __init__(self, d_model, n_heads, d_ffn, dtype=torch.float32, device=None):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, n_heads, dtype, device=device)
        self.cross_attn = MultiHeadAttention(d_model, n_heads, dtype, device=device)
        self.ffn = FeedForward(d_model, d_ffn, dtype, device=device)
        self.norm1 = LayerNorm(d_model, dtype, device=device)
        self.norm2 = LayerNorm(d_model, dtype, device=device)
        self.norm3 = LayerNorm(d_model, dtype, device=device)

    def forward(self, x, memory, tgt_key_bias=None, mem_key_bias=None,
                return_alignments: bool = True):
        sa, _ = self.self_attn(x, x, key_bias=tgt_key_bias, causal=True)
        x = self.norm1(x + sa)
        ca, align = self.cross_attn(
            x, memory, return_weights=return_alignments, key_bias=mem_key_bias
        )
        x = self.norm2(x + ca)
        return self.norm3(x + self.ffn(x)), align

    # --- KV-cached single-step path (infer/decode.py) ---

    def cached_step(self, x, self_k, self_v, cross_k, cross_v, self_bias, cross_bias):
        """One decode step with precomputed K/V."""
        return self.cached_step_attn(
            x, self_k, self_v, cross_k, cross_v, self_bias, cross_bias
        )[0]

    def cached_step_attn(self, x, self_k, self_v, cross_k, cross_v, self_bias, cross_bias):
        """``cached_step`` that also returns the cross-attention probs
        (B, H, 1, Tp), for the windowed monotonic decode."""
        sa, _ = self.self_attn.attend(x, self_k, self_v, self_bias)
        x = self.norm1(x + sa)
        ca, w = self.cross_attn.attend(x, cross_k, cross_v, cross_bias, return_weights=True)
        x = self.norm2(x + ca)
        return self.norm3(x + self.ffn(x)), w

    def project_self_kv(self, x):
        return self.self_attn.project_kv(x)

    def project_cross_kv(self, memory):
        return self.cross_attn.project_kv(memory)


class Decoder(nn.Module):
    def __init__(self, n_layers, d_model, n_heads, d_ffn, dtype=torch.float32, device=None):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            setattr(self, f"layer_{i}", DecoderLayer(
                d_model, n_heads, d_ffn, dtype, device=device))

    @property
    def layers(self) -> list[DecoderLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.n_layers)]

    def forward(self, x, memory, tgt_key_bias=None, mem_key_bias=None,
                return_alignments: bool = True):
        alignments = []
        for layer in self.layers:
            x, align = layer(x, memory, tgt_key_bias, mem_key_bias, return_alignments)
            if return_alignments:
                alignments.append(align)
        # (L, B, H, T_mel, T_phon)
        return x, (torch.stack(alignments) if return_alignments else None)
