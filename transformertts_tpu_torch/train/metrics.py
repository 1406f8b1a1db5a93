"""The evaluation metrics ``make_eval_step`` reports
(``transformertts_tpu/train/metrics.py``; MCD-DTW is not ported yet).

- Mel-cepstral distortion (MCD): DCT-II of log-mel -> frame-wise L2 over
  cepstra 1..K.
- Stop-token accuracy / recall at threshold 0.5 over valid frames.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from transformertts_tpu_torch.models.masks import lengths_to_valid_mask


@functools.lru_cache(maxsize=4)
def _dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis, (n, n): C @ x computes the DCT."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    mat = np.cos(np.pi * k * (2 * i + 1) / (2 * n)) * math.sqrt(2.0 / n)
    mat[0] *= math.sqrt(0.5)
    return mat.astype(np.float32)


def mel_cepstral_distortion(
    pred_mel: torch.Tensor,  # (B, T, n_mels) log-mel
    true_mel: torch.Tensor,
    lengths: torch.Tensor,  # (B,)
    n_coeffs: int = 13,
) -> torch.Tensor:
    """Mean MCD in dB over valid frames (coefficients 1..n_coeffs)."""
    n_mels = pred_mel.shape[-1]
    dct = torch.from_numpy(_dct_matrix(n_mels)[1: n_coeffs + 1]).to(pred_mel.device)
    cp = pred_mel.float() @ dct.t()
    ct = true_mel.float() @ dct.t()
    dist = torch.sqrt(((cp - ct) ** 2).sum(-1) + 1e-12)  # (B, T)
    scale = 10.0 * math.sqrt(2.0) / math.log(10.0)
    valid = lengths_to_valid_mask(lengths, dist.shape[1])
    return scale * torch.where(valid, dist, torch.zeros_like(dist)).sum() / valid.sum().clamp(min=1)


def stop_token_metrics(
    stop_logits: torch.Tensor,  # (B, T)
    lengths: torch.Tensor,  # (B,)
    threshold: float = 0.5,
) -> dict:
    """Accuracy over valid frames, recall of the exact stop frame, and a
    +-2-frame tolerant recall over rows of length > 0."""
    t = stop_logits.shape[1]
    valid = lengths_to_valid_mask(lengths, t)
    idx = torch.arange(t, device=lengths.device)[None, :]
    last = lengths[:, None] - 1
    gate = idx == last
    near = (idx - last).abs() <= 2
    predicted = stop_logits >= math.log(threshold / (1.0 - threshold))
    accuracy = (valid & (predicted == gate)).sum() / valid.sum().clamp(min=1)
    stop_hit = (gate & predicted).sum() / gate.sum().clamp(min=1)
    row_real = lengths > 0
    near_hit = (near & predicted).any(dim=1) & row_real
    return {
        "stop_accuracy": accuracy,
        "stop_recall": stop_hit,
        "stop_recall_2": near_hit.sum() / row_real.sum().clamp(min=1),
    }
