"""The yardstick's arithmetic: H100 peaks, and the bytes and operations
each kernel family and each step needs for its shapes.

A bound is the least time the chip could take: the larger of the bytes
over the bandwidth and the operations over the peak, with each input read
once and each output written once, and attention counting only the
(query, key) pairs that no mask removes.  The decode step, flash attention
and the fused residual LayerNorm follow the program's own kernel table
(its chip smoke test), taken from the shapes alone.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_BF16_FLOPS = 989e12  # dense bf16 / fp16, NVIDIA data sheet
PEAK_FP32_FLOPS = 67e12  # fp32 outside the tensor cores, NVIDIA data sheet


def bound_s(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops)


def bound_by(nbytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS) -> str:
    return "bytes" if nbytes / HBM_BYTES_PER_S >= flops / peak_flops else "operations"


# ------------------------------------------------------------------ decode step


def decode_weights(m: dict) -> tuple[int, int]:
    """(elements, bytes) of the decoder weights one step reads: matrices and
    biases in bf16, LayerNorm scales and shifts in fp32."""
    d, f, n_mels, r = m["d_model"], m["decoder_d_ffn"], m["n_mels"], m.get("reduction_factor", 1)
    d_out = n_mels * r + r
    half = (d * n_mels + d) + (d * d + d) + d_out * d + d_out  # prenet, heads
    half += m["decoder_n_layers"] * (3 * d * d + 3 * d + 3 * (d * d + d) + 2 * f * d + f + d)
    ln = m["decoder_n_layers"] * 6 * d
    return half + ln, 2 * half + 4 * ln


def decode_step_bytes_flops(m: dict, b: int, t: int, tp: int) -> tuple[float, float]:
    """One step at position t of b rows over tp encoder positions: the
    weights, the self-attention prefix and the cross K/V read once, the
    step's inputs and outputs once."""
    n_l, h = m["decoder_n_layers"], m["decoder_n_head"]
    dh = m["d_model"] // h
    n_w, w_bytes = decode_weights(m)
    d_out = m["n_mels"] * m.get("reduction_factor", 1) + m.get("reduction_factor", 1)
    cache = 2 * n_l * h * b * (t + tp) * dh * 2
    io = 4 * b * (m["n_mels"] + tp + d_out + 1) + 4 * m["d_model"] + 2 * n_l * h * b * dh * 2
    flops = 2 * b * n_w + 4 * b * n_l * h * dh * (t + 1 + tp)
    return float(w_bytes + cache + io), float(flops)


def decode_bound_s(m: dict, b: int, tp: int, t0: int, t1: int) -> float:
    """Summed bound of the steps at positions t0 .. t1 - 1."""
    return sum(bound_s(*decode_step_bytes_flops(m, b, t, tp)) for t in range(t0, t1))


# ------------------------------------------------------------------ training kernels


def _pairs(q_lens, k_lens, causal: bool, tq: int) -> int:
    """Unmasked (query, key) pairs of one head over the rows: every query
    position of the padded length against its row's valid keys (and, with
    causal, keys at or before it)."""
    n = 0
    for k_len in k_lens:
        if causal:
            n += sum(min(i + 1, int(k_len)) for i in range(tq))
        else:
            n += tq * int(k_len)
    return n


def flash_bytes_flops(b, h, dh, tq, tk, pairs_per_head, backward=False):
    qo, kv, stats = b * tq * h * dh * 2, b * tk * h * dh * 2, b * h * tq * 4
    pairs = pairs_per_head * h
    if backward:
        return float(4 * qo + 4 * kv + 4 * b * tk + 2 * stats), float(10 * pairs * dh)
    return float(2 * qo + 2 * kv + 4 * b * tk + 2 * stats), float(4 * pairs * dh)


def ln_bytes_flops(n, d, backward=False):
    if backward:
        return float(5 * n * d * 2 + 3 * d * 4), float(20 * n * d)
    return float(3 * n * d * 2 + 2 * d * 4), float(10 * n * d)


def train_kernel_bounds(m: dict, micro: list, cross_flash: bool) -> dict:
    """Summed bounds (seconds) of the flash-attention and fused-LayerNorm
    launches of optimizer steps over the micro-batches ``micro``: each a
    (b, tp, tm, p_lens, m_lens) of padded sizes and lengths.  A micro-batch
    runs two forwards and the second's backward; ``cross_flash`` False
    when the cross-attention returns its weights (guided attention) and
    so runs outside the flash kernels."""
    d = m["d_model"]
    out = {"flash": 0.0, "ln": 0.0}
    for b, tp, tm, p_lens, m_lens in micro:
        calls = []  # (h, tq, tk, pairs per head, causal)
        he, hd = m["encoder_n_head"], m["decoder_n_head"]
        enc = (he, tp, tp, _pairs(p_lens, p_lens, False, tp))
        dec_self = (hd, tm, tm, _pairs(m_lens, m_lens, True, tm))
        cross = (hd, tm, tp, _pairs(m_lens, p_lens, False, tm))
        calls += [enc] * m["encoder_n_layers"] + [dec_self] * m["decoder_n_layers"]
        if cross_flash:
            calls += [cross] * m["decoder_n_layers"]
        for h, tq, tk, pairs in calls:
            fwd = bound_s(*flash_bytes_flops(b, h, d // h, tq, tk, pairs))
            bwd = bound_s(*flash_bytes_flops(b, h, d // h, tq, tk, pairs, backward=True))
            out["flash"] += 2 * fwd + bwd
        lns = [b * tp] * (2 * m["encoder_n_layers"]) + [b * tm] * (3 * m["decoder_n_layers"])
        for n in lns:
            out["ln"] += (2 * bound_s(*ln_bytes_flops(n, d), PEAK_FP32_FLOPS)
                          + bound_s(*ln_bytes_flops(n, d, backward=True), PEAK_FP32_FLOPS))
    return out


# ------------------------------------------------------------------ model FLOPs


def forward_flops(m: dict, p_len: int, m_len: int, postnet: bool) -> float:
    """Operations of one teacher-forced forward of one utterance of
    ``p_len`` phonemes and ``m_len`` frames (products only, real lengths)."""
    d, n_mels = m["d_model"], m["n_mels"]
    fe, fd = m["encoder_d_ffn"], m["decoder_d_ffn"]
    p, t = p_len, m_len
    k_pre = m["encoder_prenet_kernel_size"]
    fl = m["encoder_prenet_n_layers"] * 2 * p * d * d * k_pre + 2 * p * d * d
    fl += m["encoder_n_layers"] * (8 * p * d * d + 4 * p * p * d + 4 * p * d * fe)
    fl += 2 * t * n_mels * d + 2 * t * d * d
    causal_pairs = t * (t + 1) / 2
    fl += m["decoder_n_layers"] * (8 * t * d * d + 4 * causal_pairs * d
                                   + 4 * t * d * d + 4 * p * d * d + 4 * t * p * d
                                   + 4 * t * d * fd)
    fl += 2 * t * d * (n_mels + 1) * m.get("reduction_factor", 1)
    if postnet:
        k = m["postnet_kernel_size"]
        widths = [n_mels] + [d] * (m["postnet_n_layers"] - 1) + [n_mels]
        fl += sum(2 * t * k * widths[i] * widths[i + 1] for i in range(m["postnet_n_layers"]))
    return float(fl)


def train_micro_flops(m: dict, p_lens, m_lens) -> float:
    """Operations of one micro-batch of the scheduled-sampling step: a
    forward without the postnet, a forward with it, and that forward's
    backward at twice its operations."""
    return sum(forward_flops(m, int(p), int(t), False) + 3 * forward_flops(m, int(p), int(t), True)
               for p, t in zip(p_lens, m_lens) if int(t) > 0)
