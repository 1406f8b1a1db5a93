"""Plain TransformerTTS in float32 (Li et al., arXiv:1809.08895, as the
original PyTorch recipe builds it): no kernel, no cache, no batching of
its own, TF32 off.

- Encoder: embedding, a prenet of conv + BatchNorm (no activation) and a
  linear, one learnable scalar times the sinusoidal table, post-LN layers
  of self-attention and a ReLU feed-forward.
- Decoder: a two-layer ReLU prenet, the same scaled table, post-LN layers
  of causal self-attention, cross-attention and feed-forward, then the mel
  and stop heads; a postnet of conv + BatchNorm with tanh adds its residual.
- Inference runs the encoder without a padding mask (the recipe's
  quirk) and masks padded phonemes in the cross-attention.

``Plain(m, w, q)`` holds the model settings ``m`` (a configuration
file's ``model`` object), the weights ``w`` (name -> tensor) and ``q``,
the rounding applied to every operand of a product: the identity for the
reference, ``fp8`` for the control that computes in the precision below
bf16.  A train-mode forward takes a ``Drops``: the dropout streams of
one forward, drawn as the recipe's fused kernels and plain dropout draw
them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import masks

NEG_INF = -1e9


def ident(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 (saturating at its largest value, 448)."""
    return x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(x.dtype)


def sinusoid_table(n: int, d: int) -> np.ndarray:
    pos = np.arange(n, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * (-math.log(10000.0) / d))
    pe = np.zeros((n, d), dtype=np.float64)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe.astype(np.float32)


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Drops:
    """The dropout streams of one train-mode forward made from ``seed``:
    a CPU generator that gives each fused call (attention, residual
    LayerNorm) its int32 hash seed, and a generator on the device for the
    elementwise masks of the plain dropouts, drawn in the forward's order."""

    def __init__(self, seed: int, device):
        self.seeds = torch.Generator().manual_seed(int(seed))
        self.masks = torch.Generator(device=device).manual_seed(int(seed))

    def plain(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        keep = torch.rand(x.shape, generator=self.masks, device=x.device) >= rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))

    def kernel_seed(self) -> int:
        return int(torch.randint(0, 2**31 - 1, (1,), generator=self.seeds))


def key_bias(lens: torch.Tensor, t: int) -> torch.Tensor:
    """(B, t) additive bias: 0 before each row's length, NEG_INF after."""
    pos = torch.arange(t, device=lens.device)[None, :]
    return torch.where(pos < lens[:, None], 0.0, NEG_INF)


def shift_right(frames: torch.Tensor, r: int = 1) -> torch.Tensor:
    """Decoder inputs: a zero go frame, then the last frame of each earlier
    group of r frames."""
    return torch.cat([torch.zeros_like(frames[:, :1]), frames[:, r - 1::r][:, :-1]], dim=1)


class Plain:
    def __init__(self, m: dict, w: dict, q=ident, use_flash: bool = True,
                 fused_ln: bool = True):
        self.m, self.w, self.q = m, w, q
        self.use_flash, self.fused_ln = use_flash, fused_ln
        dev = w["emb.weight"].device
        self.pe = torch.from_numpy(sinusoid_table(m["max_len"], m["d_model"])).to(dev)

    # ---------------------------------------------------------------- pieces

    def lin(self, x, name):
        q = self.q
        return q(x) @ q(self.w[f"{name}.weight"]).t() + self.w[f"{name}.bias"]

    def conv_bn(self, x, name, train):
        q, w = self.q, self.w
        wt = w[f"{name}.Conv_0.weight"]
        y = F.conv1d(q(x).transpose(1, 2), q(wt), padding=(wt.shape[2] - 1) // 2)
        y = y.transpose(1, 2) + w[f"{name}.Conv_0.bias"]
        bn = f"{name}.BatchNorm_0"
        if train:
            flat = y.reshape(-1, y.shape[-1])
            mean = flat.mean(dim=0)
            var = torch.clamp((flat * flat).mean(dim=0) - mean * mean, min=0.0)
        else:
            mean, var = w[f"{bn}.running_mean"], w[f"{bn}.running_var"]
        return (y - mean) * torch.rsqrt(var + 1e-5) * w[f"{bn}.weight"] + w[f"{bn}.bias"]

    def drop(self, x, rate, drops):
        return x if drops is None or rate <= 0.0 else drops.plain(x, rate)

    def add_pe(self, x, drops):
        x = x + self.w["pe.alpha"] * self.pe[: x.shape[1]][None]
        return self.drop(x, self.m["pe_dropout"], drops)

    def mha(self, xq, xkv, name, bias, causal, rate, drops, weights=False):
        """Multi-head attention; ``bias`` (B, Tk) or None.  Returns the
        output and, with ``weights``, the (B, H, Tq, Tk) probabilities."""
        q, h = self.q, self.m[f"{name.split('.')[0]}_n_head"]
        b, tq, d = xq.shape
        tk = xkv.shape[1]
        split = lambda t, n: t.reshape(b, n, h, d // h).transpose(1, 2)  # noqa: E731
        qh = split(self.lin(xq, f"{name}.q_proj"), tq)
        kh = split(self.lin(xkv, f"{name}.k_proj"), tk)
        vh = split(self.lin(xkv, f"{name}.v_proj"), tk)
        s = (q(qh) @ q(kh).transpose(-1, -2)) * (d // h) ** -0.5
        if bias is not None:
            s = s + bias[:, None, None, :]
        if causal:
            row = torch.arange(tq, device=s.device)[:, None]
            col = torch.arange(tk, device=s.device)[None, :]
            s = torch.where(col <= row, s, torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        pd = p
        if drops is not None and rate > 0.0:
            if self.use_flash and not weights:
                keep = masks.attention_keep(b, h, tq, tk, drops.kernel_seed(), rate, s.device)
                pd = torch.where(keep, p / (1.0 - rate), torch.zeros_like(p))
            else:
                pd = drops.plain(p, rate)
        o = (q(pd) @ q(vh)).transpose(1, 2).reshape(b, tq, d)
        return self.lin(o, f"{name}.out_proj"), (p if weights else None)

    def res_ln(self, x, hdd, name, rate, drops):
        """LayerNorm(x + Dropout(h))."""
        if drops is not None and rate > 0.0:
            if not self.fused_ln:
                hdd = drops.plain(hdd, rate)
            else:
                n, d = x.shape[0] * x.shape[1], x.shape[-1]
                keep = masks.rows_keep(n, d, drops.kernel_seed(), rate, x.device)
                hdd = torch.where(keep.reshape(x.shape), hdd / (1.0 - rate),
                                  torch.zeros_like(hdd))
        z = x + hdd
        return F.layer_norm(z, (z.shape[-1],), self.w[f"{name}.weight"], self.w[f"{name}.bias"],
                            1e-5)

    def ffn(self, x, name, rate, drops):
        hid = torch.relu(self.lin(x, f"{name}.Dense_0"))
        return self.lin(self.drop(hid, rate, drops), f"{name}.Dense_1")

    # ---------------------------------------------------------------- model

    def encode(self, ids, lens, drops=None):
        """Encoder over (B, Tp) ids; ``lens`` None runs it unmasked."""
        m, train = self.m, drops is not None
        x = self.w["emb.weight"][ids]
        for i in range(m["encoder_prenet_n_layers"]):
            x = self.drop(self.conv_bn(x, f"enc_prenet.ConvBN_{i}", train),
                          m["encoder_prenet_dropout"], drops)
        x = self.add_pe(self.lin(x, "enc_prenet.LinearNorm_0.Dense_0"), drops)
        bias = key_bias(lens, ids.shape[1]) if lens is not None else None
        rate = m["encoder_dropout"]
        for i in range(m["encoder_n_layers"]):
            p = f"encoder.layer_{i}"
            sa, _ = self.mha(x, x, f"{p}.self_attn", bias, False, rate, drops)
            x = self.res_ln(x, sa, f"{p}.norm1", rate, drops)
            x = self.res_ln(x, self.ffn(x, f"{p}.ffn", rate, drops), f"{p}.norm2", rate, drops)
        return x

    def decode(self, memory, tgt_in, p_lens, m_lens, drops=None, align=False):
        """Teacher-forced decoder: (B, T, d_model) outputs and, with
        ``align``, the (L, B, H, T, Tp) cross-attention probabilities."""
        m = self.m
        rate_pre = m["decoder_prenet_dropout"]
        x = self.drop(torch.relu(self.lin(tgt_in, "dec_prenet.LinearNorm_0.Dense_0")),
                      rate_pre, drops)
        x = self.drop(torch.relu(self.lin(x, "dec_prenet.LinearNorm_1.Dense_0")),
                      rate_pre, drops)
        x = self.add_pe(x, drops)
        tgt_bias = key_bias(m_lens, x.shape[1]) if m_lens is not None else None
        mem_bias = key_bias(p_lens, memory.shape[1])
        rate, aligns = m["decoder_dropout"], []
        for i in range(m["decoder_n_layers"]):
            p = f"decoder.layer_{i}"
            sa, _ = self.mha(x, x, f"{p}.self_attn", tgt_bias, True, rate, drops)
            x = self.res_ln(x, sa, f"{p}.norm1", rate, drops)
            ca, al = self.mha(x, memory, f"{p}.cross_attn", mem_bias, False, rate, drops,
                              weights=align)
            aligns.append(al)
            x = self.res_ln(x, ca, f"{p}.norm2", rate, drops)
            x = self.res_ln(x, self.ffn(x, f"{p}.ffn", rate, drops), f"{p}.norm3", rate, drops)
        return x, (torch.stack(aligns) if align else None)

    def heads(self, x):
        b = x.shape[0]
        mel = self.lin(x, "mel_linear.Dense_0").reshape(b, -1, self.m["n_mels"])
        return mel, self.lin(x, "stop_linear.Dense_0").reshape(b, -1)

    def postnet(self, mel, drops=None):
        m, train, x = self.m, drops is not None, mel
        n = m["postnet_n_layers"]
        for i in range(n):
            x = self.conv_bn(x, f"postnet.ConvBN_{i}", train)
            if i < n - 1:
                x = torch.tanh(x)
            x = self.drop(x, m["postnet_dropout"], drops)
        return x + mel

    def served(self, ids, lens, frames):
        """What a greedy decode should have produced, read against the
        frames it served: for (B, Tp) padded ids, (B,) lengths and the
        (B, T, n_mels) frames before the postnet, the reference's frames
        and stop logits at every position given the served prefix, and the
        postnet output over the served frames."""
        memory = self.encode(ids, None)
        x, _ = self.decode(memory, shift_right(frames, self.m.get("reduction_factor", 1)),
                           lens, None)
        mel, stop = self.heads(x)
        return mel, stop, self.postnet(frames)
