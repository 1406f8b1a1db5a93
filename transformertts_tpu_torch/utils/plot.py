"""Matplotlib visualization suite (``transformertts_tpu/utils/plot.py``;
ref: utils/plot.py:11-152).

Five PNG dumps (dpi 300) written into the experiment plot subdirs:
- ``plot_mels_batch``: grid of predicted-vs-GT mels for up to 8 samples
- ``plot_mels_single``: one predicted-vs-GT pair (free-running inference)
- ``plot_mels_scheduled``: scheduled-sampling mixed input vs target grid
- ``plot_alignments_batch``: per-layer head-averaged alignments, top-k samples
- ``plot_alignment_single``: per-layer x per-head alignment for one sample

matplotlib is imported when a plot is drawn, not with this module: a machine
without it still trains, and ``available()`` tells the caller whether plots
can be written.  Inputs are numpy arrays.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np

DPI = 300


def available() -> bool:
    """Whether matplotlib can be imported here."""
    return importlib.util.find_spec("matplotlib") is not None


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, path):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=DPI, bbox_inches="tight")
    _plt().close(fig)


def _imshow_mel(ax, mel, title):
    ax.imshow(np.asarray(mel).T, origin="lower", aspect="auto", interpolation="none")
    ax.set_title(title, fontsize=7)
    ax.set_xlabel("frame", fontsize=6)
    ax.set_ylabel("mel", fontsize=6)
    ax.tick_params(labelsize=5)


def _pairs_grid(left, target, lengths, path, n_samples: int, left_name: str):
    left, target = np.asarray(left), np.asarray(target)
    n = min(n_samples, left.shape[0])
    fig, axes = _plt().subplots(n, 2, figsize=(8, 2 * n), squeeze=False)
    for i in range(n):
        t = int(lengths[i])
        _imshow_mel(axes[i][0], left[i, :t], f"{left_name} [{i}]")
        _imshow_mel(axes[i][1], target[i, :t], f"target [{i}]")
    fig.tight_layout()
    _save(fig, path)


def plot_mels_batch(pred, target, lengths, path, n_samples: int = 8):
    """(B, T, n_mels) predicted vs ground-truth grid."""
    _pairs_grid(pred, target, lengths, path, n_samples, "pred")


def plot_mels_single(pred, target, path):
    """One free-running prediction vs ground truth (different lengths ok)."""
    pred, target = np.asarray(pred), np.asarray(target)
    fig, axes = _plt().subplots(2, 1, figsize=(8, 5))
    _imshow_mel(axes[0], pred, f"pred ({pred.shape[0]} frames)")
    _imshow_mel(axes[1], target, f"target ({target.shape[0]} frames)")
    fig.tight_layout()
    _save(fig, path)


def plot_mels_scheduled(mixed_input, target, lengths, path, n_samples: int = 4):
    """Scheduled-sampling decoder input vs target grid."""
    _pairs_grid(mixed_input, target, lengths, path, n_samples, "mixed input")


def plot_alignments_batch(alignments, mel_lens, phon_lens, path, top_k: int = 4):
    """(L, B, H, T_mel, T_phon) -> per-layer, head-averaged, top_k samples."""
    a = np.asarray(alignments)
    n_layers, b = a.shape[0], min(top_k, a.shape[1])
    fig, axes = _plt().subplots(b, n_layers, figsize=(3 * n_layers, 2.5 * b), squeeze=False)
    for i in range(b):
        tm, tp = int(mel_lens[i]), int(phon_lens[i])
        for li in range(n_layers):
            ax = axes[i][li]
            ax.imshow(a[li, i].mean(0)[:tm, :tp], origin="lower", aspect="auto",
                      interpolation="none")
            ax.set_title(f"sample {i} layer {li}", fontsize=7)
            ax.set_xlabel("phoneme", fontsize=6)
            ax.set_ylabel("mel frame", fontsize=6)
            ax.tick_params(labelsize=5)
    fig.tight_layout()
    _save(fig, path)


def plot_alignment_single(alignments, mel_len, phon_len, path, sample: int = 0):
    """(L, B, H, T_mel, T_phon) -> layer x head grid for one sample."""
    a = np.asarray(alignments)
    n_layers, n_heads = a.shape[0], a.shape[2]
    tm, tp = int(mel_len), int(phon_len)
    fig, axes = _plt().subplots(
        n_layers, n_heads, figsize=(2.2 * n_heads, 2.2 * n_layers), squeeze=False
    )
    for li in range(n_layers):
        for h in range(n_heads):
            ax = axes[li][h]
            ax.imshow(a[li, sample, h][:tm, :tp], origin="lower", aspect="auto",
                      interpolation="none")
            ax.set_title(f"L{li} H{h}", fontsize=7)
            ax.tick_params(labelsize=5)
    fig.tight_layout()
    _save(fig, path)
