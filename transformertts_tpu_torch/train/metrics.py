"""The metrics of ``make_eval_step`` and of the trainer's free-running
validation (``transformertts_tpu/train/metrics.py``).

- Mel-cepstral distortion (MCD): DCT-II of log-mel -> frame-wise L2 over
  cepstra 1..K.
- MCD under a DTW alignment (``mcd_dtw``), on the host in numpy.
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


def mcd_dtw(pred_mel: np.ndarray, true_mel: np.ndarray, n_coeffs: int = 13) -> float:
    """MCD in dB under a DTW alignment (the standard TTS eval protocol).

    Free-running decode has no ground-truth timing anchor, so the two
    cepstral sequences are warped onto a monotone common path first (steps
    (1,1), (1,0), (0,1)); the result measures spectral error net of pacing.
    Host-side numpy on single utterances (Tp, n_mels) / (Tt, n_mels) log-mel.
    """
    n_mels = pred_mel.shape[-1]
    dct = _dct_matrix(n_mels)[1: n_coeffs + 1].T.astype(np.float64)  # drop c0 (energy)
    # float64: the ||a||^2+||b||^2-2ab expansion cancels catastrophically
    # in float32 when a ~ b
    cp = np.asarray(pred_mel, np.float64) @ dct  # (Tp, K)
    ct = np.asarray(true_mel, np.float64) @ dct  # (Tt, K)
    d = np.sqrt(np.maximum(
        np.sum(cp**2, 1)[:, None] + np.sum(ct**2, 1)[None, :] - 2.0 * (cp @ ct.T), 0.0
    ) + 1e-12)  # (Tp, Tt)
    tp, tt = d.shape
    inf = float("inf")
    # accumulated cost and path length; ties prefer diagonal, then up, then left
    prev_a = [0.0] + [inf] * tt
    prev_p = [0] * (tt + 1)
    for i in range(1, tp + 1):
        di = d[i - 1].tolist()
        cur_a = [inf] * (tt + 1)
        cur_p = [0] * (tt + 1)
        for j in range(1, tt + 1):
            a_diag, a_up, a_left = prev_a[j - 1], prev_a[j], cur_a[j - 1]
            if a_diag <= a_up and a_diag <= a_left:
                best, blen = a_diag, prev_p[j - 1]
            elif a_up <= a_left:
                best, blen = a_up, prev_p[j]
            else:
                best, blen = a_left, cur_p[j - 1]
            cur_a[j] = di[j - 1] + best
            cur_p[j] = blen + 1
        prev_a, prev_p = cur_a, cur_p
    scale = 10.0 * math.sqrt(2.0) / math.log(10.0)
    return float(scale * prev_a[tt] / max(prev_p[tt], 1))


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
