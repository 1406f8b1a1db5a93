"""Length-masked TTS losses (``transformertts_tpu/train/loss.py``; ref:
loss.py:9-55) plus the guided-attention loss.

- mel losses: MSE averaged over valid frames x channels only; total mel =
  pred + ``post_mel_weight`` * post.
- stop loss: BCE-with-logits over valid frames with ``pos_weight`` on the
  positive class; the gate target is 1 over the last ``stop_gate_k`` valid
  frames (k = 1: only the exact last valid frame).
- guided attention: the diagonal prior ``W[t, n] = 1 - exp(-(n/N - t/T)^2 /
  2 s^2)`` applied to the decoder cross-attention weights.

Everything in fp32.

On a sharded model (``parallel/mesh.py``) the losses take a ``layout``:
each rank holds some rows (and, under sequence parallelism, a time slice)
of the outputs, and a masked mean becomes this rank's masked sum over the
global count, so that the ranks' values sum to the one-process loss.  The
guided-attention loss holds this rank's heads over all query rows; under
tensor parallelism without sequence parallelism its partial sum is summed
over the model ranks in the forward (every model rank then holds the whole
loss, as it does the others).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from transformertts_tpu_torch.models.masks import lengths_to_valid_mask
from transformertts_tpu_torch.parallel import collectives
from transformertts_tpu_torch.parallel.mesh import SINGLE


def _masked_mean(x: torch.Tensor, mask: torch.Tensor, count=None) -> torch.Tensor:
    """Mean of x over positions where mask (broadcastable) is True; given a
    ``count`` (of every rank's positions), this rank's sum over it."""
    mask = mask.expand_as(x)
    total = torch.where(mask, x, torch.zeros_like(x)).sum()
    if count is None:
        count = mask.sum()
    return total / count.clamp(min=1)


def _bce_with_logits(logits, targets, pos_weight):
    # w * y * softplus(-x) + (1 - y) * softplus(x)
    return pos_weight * targets * F.softplus(-logits) + (1.0 - targets) * F.softplus(logits)


def tts_loss(
    outputs: dict,
    mel: torch.Tensor,  # (B, T, C) ground truth
    lengths: torch.Tensor,  # (B,)
    stop_weight: float = 8.0,
    post_mel_weight: float = 0.5,
    stop_gate_k: int = 1,
    layout=SINGLE,
) -> dict:
    pred = outputs["pred_melspec"].float()
    post = outputs["post_melspec"].float()
    stop = outputs["pred_stop"].float()
    mel = mel.float()

    t = pred.shape[1]
    t0 = layout.time_offset(t)
    valid = lengths_to_valid_mask(lengths, t, t0)  # (B, T)
    frame_mask = valid[:, :, None]
    frames = layout.total(valid.sum())  # every rank's valid frames (one collective)
    mels = frames * pred.shape[-1]

    pred_mel_loss = _masked_mean((pred - mel) ** 2, frame_mask, mels)
    post_mel_loss = _masked_mean((post - mel) ** 2, frame_mask, mels)
    mel_loss = pred_mel_loss + post_mel_weight * post_mel_loss

    pos = torch.arange(t0, t0 + t, device=lengths.device)[None, :]
    gate = (pos >= (lengths[:, None] - stop_gate_k)).float()
    stop_loss = _masked_mean(_bce_with_logits(stop, gate, stop_weight), valid, frames)

    return {
        "total": mel_loss + stop_loss,
        "pred_mel": pred_mel_loss,
        "post_mel": post_mel_loss,
        "stop": stop_loss,
    }


def _normalized_positions(alignments, mel_lens, phoneme_lens):
    """t / T (B, T_mel, 1) and n / N (B, 1, T_phon) of every alignment cell."""
    t_mel, t_phon = alignments.shape[-2:]
    dev = alignments.device
    t_idx = torch.arange(t_mel, dtype=torch.float32, device=dev)[None, :, None]
    n_idx = torch.arange(t_phon, dtype=torch.float32, device=dev)[None, None, :]
    t_norm = t_idx / mel_lens[:, None, None].float().clamp(min=1.0)
    n_norm = n_idx / phoneme_lens[:, None, None].float().clamp(min=1.0)
    return t_norm, n_norm


def guided_attention_loss(
    alignments: torch.Tensor,  # (L, B, H, T_mel, T_phon)
    mel_lens: torch.Tensor,  # (B,)
    phoneme_lens: torch.Tensor,  # (B,)
    sigma: float = 0.4,
    layout=SINGLE,
) -> torch.Tensor:
    t_mel, t_phon = alignments.shape[-2:]
    t_norm, n_norm = _normalized_positions(alignments, mel_lens, phoneme_lens)
    w = 1.0 - torch.exp(-((n_norm - t_norm) ** 2) / (2.0 * sigma**2))  # (B, T_mel, T_phon)
    valid = (
        lengths_to_valid_mask(mel_lens, t_mel)[:, :, None]
        & lengths_to_valid_mask(phoneme_lens, t_phon)[:, None, :]
    )
    penalty = alignments.float() * w[None, :, None]  # broadcast over L, H
    mask = valid[None, :, None]
    # this rank's heads over every query row: count every rank's cells
    count = layout.total(mask.expand_as(penalty).sum(), over_time=False) * layout.mesh.n_model
    loss = _masked_mean(penalty, mask, count)
    if layout.tp and not layout.seq:
        loss = collectives.reduce_from(loss, layout.mesh.model_group)
    return loss


def alignment_diagonality(
    alignments: torch.Tensor,  # (L, B, H, T_mel, T_phon)
    mel_lens: torch.Tensor,
    phoneme_lens: torch.Tensor,
    band: float = 0.2,
) -> torch.Tensor:
    """Fraction of attention mass within a +-band diagonal corridor: 1.0
    means all cross-attention mass lies on the ideal monotonic diagonal."""
    t_mel = alignments.shape[-2]
    t_norm, n_norm = _normalized_positions(alignments, mel_lens, phoneme_lens)
    near = (n_norm - t_norm).abs() <= band  # (B, T_mel, T_phon)
    mass = torch.where(near[None, :, None], alignments, torch.zeros_like(alignments)).sum(-1)
    valid_q = lengths_to_valid_mask(mel_lens, t_mel)  # (B, T_mel)
    return _masked_mean(mass, valid_q[None, :, None, :])
