"""Post-LN Transformer encoder/decoder stacks (``transformertts_tpu/models/transformer.py``).

  encoder layer:  x = LN1(x + Drop(SelfAttn(x)))
                  x = LN2(x + Drop(W2 Drop(relu(W1 x))))
  decoder layer:  x = LN1(x + Drop(SelfAttn(x, causal+pad)))
                  x = LN2(x + Drop(CrossAttn(x, memory, mem-pad)))  [weights kept]
                  x = LN3(x + Drop(FFN(x)))

LayerNorm eps 1e-5, fp32 statistics.  With ``use_fused_ln`` every
``LN(x + Drop(h))`` is one call of the fused kernel
(``ops/fused_ln.py``); without it, plain dropout and the LayerNorm module.
With ``use_fused_ffn`` every feed-forward block is one call of the fused FFN
kernel (``ops/fused_ffn.py``) on the ``Dense_0`` / ``Dense_1`` parameters as
they lie; without it, two linears around relu and plain dropout.
Dropout runs only with ``train=True`` and draws from the ``DropoutRng`` the
caller passes.

Under tensor parallelism (``parallel/mesh.py``) a feed-forward block holds
``d_ffn / n_model`` columns, enters its input once and sums its partial
output over the model ranks before ``Dense_1``'s bias; the fused kernels
and the plain dropout key their masks on the one-process step's rows,
heads and columns, so a sharded step drops what that step drops.
"""

from __future__ import annotations

import torch
from torch import nn

from transformertts_tpu_torch.models.attention import MultiHeadAttention
from transformertts_tpu_torch.models.initializers import torch_linear_
from transformertts_tpu_torch.models.modules import ACT, LayerNorm, Linear, dropout
from transformertts_tpu_torch.ops import fused_ffn as ffn_op
from transformertts_tpu_torch.ops import fused_ln as ln_op
from transformertts_tpu_torch.ops.fused_ffn import fused_ffn
from transformertts_tpu_torch.ops.fused_ln import residual_dropout_layernorm
from transformertts_tpu_torch.parallel.mesh import SINGLE


def _row_geometry(layout, b: int, t: int, time_axis):
    """(global rows, row_map) of a fused kernel's (b, t) rows: the rows of
    the one-process call and where this rank's lie among them."""
    b_total, b0 = layout.span("data", b)
    t_total, t0 = layout.span(time_axis, t)
    return b_total * t_total, (t, t_total, b0 * t_total + t0)


def _residual_norm(layer, norm: LayerNorm, x, h, train: bool, rng):
    """``norm(x + drop(h))``, as one fused kernel call when the layer says so.
    The LayerNorm parameters stay on the ``norm`` module either way."""
    rate = layer.dropout if train else 0.0
    layout = layer.layout
    if layer.use_fused_ln:
        if rate > 0.0 and rng is None:
            raise ValueError("train-mode dropout needs a DropoutRng")
        n_total, row_map = _row_geometry(layout, x.shape[0], x.shape[1], "time")
        return residual_dropout_layernorm(
            x, h, norm.weight, norm.bias, dropout=rate,
            seed=rng.kernel_seed(rate) if rate > 0.0 else 0, plain=layer.plain_ops,
            mask_rows=ln_op.pick_rows(n_total, x.shape[-1]), row_map=row_map,
        )
    return norm(x + dropout(h, rate, train, rng, layout, ACT))


class FeedForward(nn.Module):
    layout = SINGLE

    def __init__(self, d_model: int, d_ffn: int, dropout: float = 0.1, dtype=torch.float32,
                 use_fused: bool = False, plain_ops: bool = False, device=None):
        super().__init__()
        self.Dense_0 = Linear(d_model, d_ffn, device=device)
        self.Dense_1 = Linear(d_ffn, d_model, device=device)
        self.dropout = dropout
        self.dtype = dtype
        self.use_fused = use_fused  # fused FFN kernel (runtime.use_pallas_fused_ffn)
        self.plain_ops = plain_ops

    def reset_parameters(self, generator) -> None:
        for dense in (self.Dense_0, self.Dense_1):
            fan_in = dense.weight.shape[1]
            torch_linear_(dense.weight, generator)
            torch_linear_(dense.bias, generator, fan_in=fan_in)

    def forward(self, x: torch.Tensor, train: bool = False, rng=None) -> torch.Tensor:
        layout = self.layout
        x = layout.enter(x)
        if not layout.tp:
            return self._forward(x, train, rng)
        y = self._forward(x, train, rng, with_bias=False)
        return layout.exit(y) + self.Dense_1.bias.to(self.dtype)

    def _forward(self, x, train, rng, with_bias: bool = True):
        """The block on this rank's columns; ``with_bias=False`` leaves out
        ``Dense_1``'s bias (added once, after the sum over model ranks)."""
        b2 = self.Dense_1.bias if with_bias else torch.zeros_like(self.Dense_1.bias)
        if self.use_fused:
            rate = self.dropout if train else 0.0
            if rate > 0.0 and rng is None:
                raise ValueError("train-mode dropout needs a DropoutRng")
            n_total, row_map = _row_geometry(self.layout, x.shape[0], x.shape[1], None)
            f_total, c0 = self.layout.span("model", self.Dense_0.weight.shape[0])
            itemsize = torch.empty((), dtype=self.dtype).element_size()
            return fused_ffn(
                x.to(self.dtype), self.Dense_0.weight, self.Dense_0.bias, self.Dense_1.weight,
                b2, dropout=rate, seed=rng.kernel_seed(rate) if rate > 0.0 else 0,
                plain=self.plain_ops, row_map=row_map, col_map=(f_total, c0),
                mask_rows=ffn_op.pick_rows(n_total, x.shape[-1], f_total, itemsize))
        h = dropout(torch.relu(self.Dense_0(x, self.dtype)), self.dropout, train, rng,
                    self.layout, ("data", None, "model"))
        y = h.to(self.dtype) @ self.Dense_1.weight.to(self.dtype).t()
        return y + b2.to(self.dtype)


class EncoderLayer(nn.Module):
    layout = SINGLE

    def __init__(self, d_model, n_heads, d_ffn, dropout=0.1, dtype=torch.float32,
                 use_flash=False, use_fused_ln=False, fuse_qkv=False, plain_ops=False,
                 use_fused_ffn=False, device=None):
        super().__init__()
        self.dropout = dropout
        self.use_fused_ln = use_fused_ln
        self.plain_ops = plain_ops
        attn = (d_model, n_heads, dropout, dtype, use_flash, fuse_qkv, plain_ops)
        self.self_attn = MultiHeadAttention(*attn, device=device)
        self.ffn = FeedForward(d_model, d_ffn, dropout, dtype, use_fused_ffn, plain_ops,
                               device=device)
        self.norm1 = LayerNorm(d_model, dtype, device=device)
        self.norm2 = LayerNorm(d_model, dtype, device=device)

    def forward(self, x, key_bias=None, train: bool = False, rng=None):
        sa, _ = self.self_attn(x, x, key_bias=key_bias, train=train, rng=rng)
        x = _residual_norm(self, self.norm1, x, sa, train, rng)
        return _residual_norm(self, self.norm2, x, self.ffn(x, train, rng), train, rng)


class Encoder(nn.Module):
    def __init__(self, n_layers, d_model, n_heads, d_ffn, dropout=0.1, dtype=torch.float32,
                 use_flash=False, use_fused_ln=False, fuse_qkv=False, plain_ops=False,
                 use_fused_ffn=False, device=None):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            setattr(self, f"layer_{i}", EncoderLayer(
                d_model, n_heads, d_ffn, dropout, dtype, use_flash, use_fused_ln, fuse_qkv,
                plain_ops, use_fused_ffn, device=device))

    def forward(self, x, key_bias=None, train: bool = False, rng=None):
        for i in range(self.n_layers):
            x = getattr(self, f"layer_{i}")(x, key_bias, train, rng)
        return x


class DecoderLayer(nn.Module):
    layout = SINGLE

    def __init__(self, d_model, n_heads, d_ffn, dropout=0.1, dtype=torch.float32,
                 use_flash=False, use_fused_ln=False, fuse_qkv=False, plain_ops=False,
                 use_fused_ffn=False, device=None):
        super().__init__()
        self.dropout = dropout
        self.use_fused_ln = use_fused_ln
        self.plain_ops = plain_ops
        attn = (d_model, n_heads, dropout, dtype, use_flash, fuse_qkv, plain_ops)
        self.self_attn = MultiHeadAttention(*attn, device=device)
        self.cross_attn = MultiHeadAttention(*attn, device=device)
        self.ffn = FeedForward(d_model, d_ffn, dropout, dtype, use_fused_ffn, plain_ops,
                               device=device)
        self.norm1 = LayerNorm(d_model, dtype, device=device)
        self.norm2 = LayerNorm(d_model, dtype, device=device)
        self.norm3 = LayerNorm(d_model, dtype, device=device)

    def forward(self, x, memory, tgt_key_bias=None, mem_key_bias=None,
                return_alignments: bool = True, train: bool = False, rng=None):
        sa, _ = self.self_attn(x, x, key_bias=tgt_key_bias, causal=True, train=train, rng=rng)
        x = _residual_norm(self, self.norm1, x, sa, train, rng)
        ca, align = self.cross_attn(
            x, memory, return_weights=return_alignments, key_bias=mem_key_bias,
            train=train, rng=rng,
        )
        x = _residual_norm(self, self.norm2, x, ca, train, rng)
        x = _residual_norm(self, self.norm3, x, self.ffn(x, train, rng), train, rng)
        return x, align

    # --- KV-cached single-step path (infer/decode.py); no dropout: inference ---

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
    layout = SINGLE

    def __init__(self, n_layers, d_model, n_heads, d_ffn, dropout=0.1, dtype=torch.float32,
                 use_flash=False, use_fused_ln=False, fuse_qkv=False, plain_ops=False,
                 use_fused_ffn=False, device=None):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            setattr(self, f"layer_{i}", DecoderLayer(
                d_model, n_heads, d_ffn, dropout, dtype, use_flash, use_fused_ln, fuse_qkv,
                plain_ops, use_fused_ffn, device=device))

    @property
    def layers(self) -> list[DecoderLayer]:
        return [getattr(self, f"layer_{i}") for i in range(self.n_layers)]

    def forward(self, x, memory, tgt_key_bias=None, mem_key_bias=None,
                return_alignments: bool = True, train: bool = False, rng=None):
        alignments = []
        memory = self.layout.enter(memory)  # once for every layer's cross-attention
        for layer in self.layers:
            x, align = layer(x, memory, tgt_key_bias, mem_key_bias, return_alignments, train, rng)
            if return_alignments:
                alignments.append(align)
        # (L, B, H, T_mel, T_phon)
        return x, (torch.stack(alignments) if return_alignments else None)
