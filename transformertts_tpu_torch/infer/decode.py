"""KV-cached autoregressive greedy mel decoding (``transformertts_tpu/infer/decode.py``).

Two loops with one result:

- the plain loop mirrors the JAX XLA loop (``decode.py:191-302``): the
  encoder runs unmasked (the reference's quirk, model/model.py:345-348),
  cross-attention K/V are built once, the self-attention caches grow by one
  row per step, a row stops voting when ``sigmoid(stop) >= threshold`` and
  the loop ends when every row has voted or at ``max_len``;
- the kernel loop mirrors ``_megakernel_decode(_batched)``
  (``decode.py:522-685``): each step is ONE launch of the decode-step
  kernel on the GPU, through an ``ops.decode_step.DecodeStep`` prepared
  once per chunk of rows (checks, plan, buffers), so a step costs the host
  one C call.  A batch larger than the kernel takes is decoded as
  consecutive chunks of rows, each chunk to its own stop.

On the GPU the kernel loop is the decode path; the plain loop runs there
only when the caller asks for it by name (``use_kernel=False``), as a
reference to hold the kernel loop against.

Both keep the windowed monotone cross-attention (``decode_attn_window``
W > 0): every layer's cross-attention sees only encoder positions within
``[center - W, center + W]``, and the center follows the last layer's
head-averaged expected position, only ever forward.  With reduction factor
r > 1 each step emits r frames and feeds back the last one.

The loop runs in Python and reads the stop votes back once per step.
"""

from __future__ import annotations

from typing import Optional

import torch

from transformertts_tpu_torch.config import Config
from transformertts_tpu_torch.device import resolve_device
from transformertts_tpu_torch.models.masks import NEG_INF, padding_bias
from transformertts_tpu_torch.models.modules import sinusoid_table
from transformertts_tpu_torch.ops.decode_step import (
    MAX_BATCH,
    DecodeStep,
    decode_step,
    pack_decode_weights,
)


def per_row_lengths(stops: torch.Tensor, n_frames: int, stop_threshold: float) -> torch.Tensor:
    """Frames up to and including each row's own first stop vote, bounded by
    the global stop step (the reference's only cut, model/model.py:382)."""
    voted = torch.sigmoid(stops) >= stop_threshold
    first = voted.int().argmax(dim=1)  # 0 if no vote
    has_vote = voted.any(dim=1)
    return torch.where(has_vote, first + 1, torch.full_like(first, n_frames)).int()


def _window_bias(center: torch.Tensor, tp: int, w: int) -> torch.Tensor:
    """(B, Tp) bias: NEG_INF outside [center - w, center + w]."""
    pos = torch.arange(tp, dtype=torch.float32, device=center.device)[None, :]
    c = center[:, None]
    inside = (pos >= c - w) & (pos <= c + w)
    return torch.where(inside, 0.0, NEG_INF)


def make_decode_fn(
    model,
    cfg: Config,
    max_len: Optional[int] = None,
    stop_threshold: Optional[float] = None,
    mask_encoder_source: bool = False,
    use_kernel: Optional[bool] = None,
    device: str | torch.device | None = None,
):
    """Returns ``decode(phoneme (B, Tp) int, phoneme_lens (B,) int) -> dict``
    with ``pred_melspec`` / ``post_melspec`` (B, max_len, n_mels),
    ``pred_stop`` (B, max_len), ``n_frames`` (int) and ``n_frames_per_row``
    (B,), as the JAX function, plus ``n_steps``: the decoder steps run,
    summed over the chunks of rows (the kernel's launches on the GPU).
    Frames at positions >= n_frames are zeros before the postnet; so are a
    chunk's frames past its own stop, which lie past its rows' lengths.

    ``use_kernel``: None picks the kernel loop on CUDA — it raises there
    when ``cfg.runtime.use_pallas_decode_step`` is off, and the kernel
    raises for shapes it cannot take — and the plain loop on the CPU.
    True forces the kernel loop (on the CPU the step wrapper then runs its
    plain version); False forces the plain loop.  The kernel loop decodes
    at most ``min(decode_megakernel_max_batch, 8)`` rows per kernel call.
    """
    device = resolve_device(device)
    if model.device != device:
        raise ValueError(f"model is on {model.device}, decode asked for {device}")
    max_len = max_len or cfg.runtime.infer_max_len
    stop_threshold = (
        stop_threshold if stop_threshold is not None else cfg.runtime.stop_threshold
    )
    r = cfg.model.reduction_factor
    if max_len % r:
        raise ValueError(f"max_len ({max_len}) must be a multiple of reduction_factor ({r})")
    if int(cfg.runtime.decode_speculative_k) > 1:
        raise NotImplementedError(
            "decode_speculative_k > 1 is not ported yet (ROADMAP Queue 1: speculative decode)"
        )
    if float(cfg.runtime.infer_prenet_dropout) > 0.0:
        raise NotImplementedError(
            "infer_prenet_dropout > 0 is not ported yet (ROADMAP Queue 1: prenet dropout)"
        )
    if use_kernel is None and device.type == "cuda" and not cfg.runtime.use_pallas_decode_step:
        raise ValueError(
            "on CUDA the decode runs the decode-step kernel; use_pallas_decode_step=False "
            "has no GPU path (pass use_kernel=False to run the plain reference loop)"
        )
    kernel = use_kernel if use_kernel is not None else device.type == "cuda"
    chunk = min(int(cfg.runtime.decode_megakernel_max_batch), MAX_BATCH)
    if kernel and chunk < 1:
        raise ValueError(f"decode_megakernel_max_batch must be >= 1, got {chunk}")
    n_pos = max_len // r
    packed_cache: dict = {}

    @torch.inference_mode()
    def decode(phoneme, phoneme_lens) -> dict:
        phoneme = torch.as_tensor(phoneme, dtype=torch.long, device=device)
        lens = torch.as_tensor(phoneme_lens, dtype=torch.long, device=device)
        b, tp = phoneme.shape
        memory = model.encode(phoneme, lens if mask_encoder_source else None)
        cross_kv = model.build_cross_cache(memory)  # L x ((B, Tp, H, dh) x 2)
        cross_bias = padding_bias(lens, tp)  # (B, 1, 1, Tp)
        if kernel:
            if "packed" not in packed_cache:
                packed_cache["packed"] = pack_decode_weights(model, model.dtype)
            parts = [
                _kernel_loop(
                    model, cfg, packed_cache["packed"],
                    [(k[i:i + chunk], v[i:i + chunk]) for k, v in cross_kv],
                    cross_bias[i:i + chunk], n_pos, max_len, stop_threshold,
                )
                for i in range(0, b, chunk)
            ]
            frames = torch.cat([p[0] for p in parts])
            stops = torch.cat([p[1] for p in parts])
            t = max(p[2] for p in parts)
            n_steps = sum(p[2] for p in parts)
        else:
            frames, stops, t = _plain_loop(
                model, cfg, cross_kv, cross_bias, n_pos, max_len, stop_threshold)
            n_steps = t
        n_frames = t * r
        pred = frames[:, 1:, :]
        post = model.apply_postnet(pred).float()
        return {
            "pred_melspec": pred,
            "post_melspec": post,
            "pred_stop": stops,
            "n_frames": n_frames,
            "n_frames_per_row": per_row_lengths(stops, n_frames, stop_threshold),
            "n_steps": n_steps,
        }

    return decode


def _state(cfg, b, max_len, dev):
    n_mels = cfg.model.n_mels
    frames = torch.zeros((b, max_len + 1, n_mels), dtype=torch.float32, device=dev)  # [0]=go
    stops = torch.full((b, max_len), NEG_INF, dtype=torch.float32, device=dev)
    stopped = torch.zeros((b,), dtype=torch.bool, device=dev)
    return frames, stops, stopped


def _plain_loop(model, cfg, cross_kv, cross_bias, n_pos, max_len, stop_threshold):
    """The XLA loop of the JAX package, step by step in PyTorch ops."""
    m = cfg.model
    r, n_heads = m.reduction_factor, m.decoder_n_head
    b, tp = cross_bias.shape[0], cross_bias.shape[-1]
    dev, dtype = cross_bias.device, model.dtype
    attn_win = int(cfg.runtime.decode_attn_window)
    frames, stops, stopped = _state(cfg, b, max_len, dev)
    shape = (m.decoder_n_layers, b, n_pos, n_heads, m.d_model // n_heads)
    self_k = torch.zeros(shape, dtype=dtype, device=dev)
    self_v = torch.zeros(shape, dtype=dtype, device=dev)
    center = torch.zeros((b,), dtype=torch.float32, device=dev)
    pos_f = torch.arange(tp, dtype=torch.float32, device=dev)[None, :]
    layers = model.decoder.layers
    t = 0
    while t < n_pos and not bool(stopped.all()):
        x = model.prenet_step(frames[:, t * r: t * r + 1], t)  # (B, 1, D)
        cb = cross_bias
        if attn_win > 0:
            cb = cross_bias + _window_bias(center, tp, attn_win)[:, None, None, :]
        self_bias = torch.where(
            torch.arange(n_pos, device=dev) <= t, 0.0, NEG_INF
        )[None, None, None, :]
        attn_w = None
        for li, layer in enumerate(layers):
            k_new, v_new = layer.project_self_kv(x)  # (B, 1, H, dh)
            self_k[li, :, t] = k_new[:, 0]
            self_v[li, :, t] = v_new[:, 0]
            ck, cv = cross_kv[li]
            if attn_win > 0 and li == len(layers) - 1:
                x, attn_w = layer.cached_step_attn(
                    x, self_k[li], self_v[li], ck, cv, self_bias, cb)
            else:
                x = layer.cached_step(x, self_k[li], self_v[li], ck, cv, self_bias, cb)
        mel_t, stop_t = model.decode_frame_heads(x)  # (B, r, C), (B, r)
        frames[:, t * r + 1: t * r + 1 + r] = mel_t.float()
        stops[:, t * r: t * r + r] = stop_t.float()
        stopped |= (torch.sigmoid(stop_t.float()) >= stop_threshold).any(dim=1)
        if attn_win > 0:
            w = attn_w.float().mean(dim=1)[:, 0, :]  # (B, Tp), head mean
            exp_pos = (w * pos_f).sum(1) / torch.clamp(w.sum(1), min=1e-6)
            center = torch.maximum(center, exp_pos)
        t += 1
    return frames, stops, t


def _kernel_loop(model, cfg, packed, cross_kv, cross_bias, n_pos, max_len, stop_threshold):
    """One decode-step launch per step (the megakernel loops of the JAX
    package); caches in the kernel's (L, H, B, T, dh) layout.  On the CPU
    the step is ``decode_step``'s plain version."""
    m = cfg.model
    r, n_mels, n_heads = m.reduction_factor, m.n_mels, m.decoder_n_head
    b, tp = cross_bias.shape[0], cross_bias.shape[-1]
    dev, dtype = cross_bias.device, model.dtype
    attn_win = int(cfg.runtime.decode_attn_window)
    frames, stops, stopped = _state(cfg, b, max_len, dev)
    alpha = model.pe.alpha.float()
    pe_table = (alpha * torch.from_numpy(sinusoid_table(m.max_len, m.d_model)).to(dev)).float()
    # L x (B, Tp, H, dh) -> (L, H, B, Tp, dh)
    ck = torch.stack([kv[0] for kv in cross_kv]).permute(0, 3, 1, 2, 4).contiguous()
    cv = torch.stack([kv[1] for kv in cross_kv]).permute(0, 3, 1, 2, 4).contiguous()
    cbias = cross_bias[:, 0, 0, :].float().contiguous()  # (B, Tp)
    shape = (m.decoder_n_layers, n_heads, b, n_pos, m.d_model // n_heads)
    self_k = torch.zeros(shape, dtype=dtype, device=dev)
    self_v = torch.zeros(shape, dtype=dtype, device=dev)
    center = torch.zeros((b,), dtype=torch.float32, device=dev)
    if dev.type == "cuda":
        step = DecodeStep(self_k, self_v, ck, cv, packed, with_attn_pos=attn_win > 0)
    else:
        def step(t, frame, pe_row, cb):
            return decode_step(t, frame, pe_row, cb, self_k, self_v, ck, cv, packed,
                               with_attn_pos=attn_win > 0)
    t = 0
    while t < n_pos and not bool(stopped.all()):
        frame = frames[:, t * r]  # (B, n_mels), rows apart in the frame buffer
        pe_row = pe_table[t: t + 1]
        if attn_win > 0:
            cb_t = (cbias + _window_bias(center, tp, attn_win)).contiguous()
            y, _, _, exp_pos = step(t, frame, pe_row, cb_t)
            center = torch.maximum(center, exp_pos[:, 0])
        else:
            y, _, _ = step(t, frame, pe_row, cbias)
        stop_t = y[:, n_mels * r:]
        frames[:, t * r + 1: t * r + 1 + r] = y[:, : n_mels * r].reshape(b, r, n_mels)
        stops[:, t * r: t * r + r] = stop_t
        stopped |= (torch.sigmoid(stop_t) >= stop_threshold).any(dim=1)
        t += 1
    return frames, stops, t
