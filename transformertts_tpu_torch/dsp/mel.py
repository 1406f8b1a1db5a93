"""STFT / log-mel feature extraction (``transformertts_tpu/dsp/mel.py``).

``librosa.stft(n_fft=1024, hop=256, win=1024, hann, center=True, reflect)``
-> magnitude -> slaney-normalized mel filterbank (htk=False mel scale) ->
``log(clip(S, 1e-5))``, with global scalar mean/std normalization; the
filterbank and the STFT are derived here, librosa is not a dependency.

Three compute paths:
- numpy (``*_np``): host-side offline preprocessing;
- PyTorch (``mel_spectrogram_torch``): batched extraction with
  ``torch.fft.rfft`` on the tensor's device;
- the CUDA kernel (``ops/stft.py``): frames x DFT matrices x mel basis in one
  pass, built from ``dft_matrices`` and ``mel_filterbank``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hann_window(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window (scipy ``get_window('hann', N, fftbins=True)``)."""
    n = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)
    return w.astype(dtype)


def padded_window(win_length: int, n_fft: int) -> np.ndarray:
    """The Hann window centred in ``n_fft`` samples (zeros around it when
    ``win_length < n_fft``)."""
    window = hann_window(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        window = np.pad(window, (lpad, n_fft - win_length - lpad))
    return window


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    """Slaney (librosa htk=False) Hz->mel: linear below 1 kHz, log above."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3.0
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = f >= min_log_hz
    mels = np.where(log_region, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3.0
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = m >= min_log_mel
    freqs = np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)
    return freqs


@functools.lru_cache(maxsize=8)
def _mel_filterbank_cached(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_min = _hz_to_mel_slaney(np.array(fmin))
    mel_max = _hz_to_mel_slaney(np.array(fmax))
    mel_pts = _mel_to_hz_slaney(np.linspace(mel_min, mel_max, n_mels + 2))

    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fftfreqs[None, :]

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))

    # slaney area normalization (ref: audio.py:22 norm='slaney')
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """(n_mels, 1 + n_fft//2) slaney-normalized triangular filterbank."""
    return _mel_filterbank_cached(int(sr), int(n_fft), int(n_mels), float(fmin), float(fmax))


def dynamic_range_compression(S, clip_val: float = 1e-5, C: float = 1.0):
    """log(clip(S) * C) on numpy arrays and tensors (ref: audio.py:27-29)."""
    if isinstance(S, torch.Tensor):
        return torch.log(torch.clamp(S, min=clip_val) * C)
    return np.log(np.clip(S, a_min=clip_val, a_max=None) * C)


def _frame_count(n_samples: int, hop_length: int) -> int:
    # center=True framing: 1 + floor(n / hop)
    return 1 + n_samples // hop_length


def stft_magnitude_np(
    y: np.ndarray, n_fft: int, hop_length: int, win_length: int
) -> np.ndarray:
    """|STFT| with centered reflect padding. Returns (1 + n_fft//2, frames)."""
    if y.ndim != 1:
        raise ValueError("stft_magnitude_np expects mono 1-D audio")
    pad = n_fft // 2
    y_pad = np.pad(y, pad, mode="reflect")
    window = padded_window(win_length, n_fft)
    n_frames = _frame_count(len(y), hop_length)
    # as_strided framing (no copy), then windowed rFFT
    frames = np.lib.stride_tricks.sliding_window_view(y_pad, n_fft)[::hop_length][:n_frames]
    spec = np.fft.rfft(frames * window[None, :], n=n_fft, axis=-1)
    return np.abs(spec).T.astype(np.float32)


def mel_spectrogram_np(
    y: np.ndarray,
    sample_rate: int,
    n_fft: int,
    hop_length: int,
    win_length: int,
    fmin: float,
    fmax: float,
    n_mels: int,
) -> np.ndarray:
    """Host-side log-mel, (n_mels, frames) — layout matches ref audio.py:32-51."""
    S = stft_magnitude_np(y, n_fft, hop_length, win_length)
    basis = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)
    return dynamic_range_compression(basis @ S)


def pad_and_count(y: torch.Tensor, n_fft: int, hop_length: int, center: bool):
    """(B, n) signals -> (padded signals, frame count): ``center=True``
    reflect-pads n_fft // 2 samples on both sides and counts 1 + n // hop
    frames; ``center=False`` takes y as already padded and counts the whole
    frames it holds."""
    n = y.shape[-1]
    if center:
        pad = n_fft // 2
        y = torch.nn.functional.pad(y[:, None, :], (pad, pad), mode="reflect")[:, 0, :]
        return y, _frame_count(n, hop_length)
    return y, 1 + (n - n_fft) // hop_length


def windowed_frames(y_pad: torch.Tensor, n_frames: int, window: torch.Tensor,
                    hop_length: int) -> torch.Tensor:
    """(B, n_pad) -> (B, n_frames, n_fft): the overlapping frames as a gather,
    times the (n_fft,) window."""
    n_fft = window.shape[0]
    idx = (torch.arange(n_frames, device=y_pad.device)[:, None] * hop_length
           + torch.arange(n_fft, device=y_pad.device)[None, :])
    return y_pad[:, idx] * window


def mel_spectrogram_torch(
    y: torch.Tensor,
    sample_rate: int = 22050,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    fmin: float = 0.0,
    fmax: float = 8000.0,
    n_mels: int = 80,
    center: bool = True,
) -> torch.Tensor:
    """Batched log-mel on y's device.  y: (..., n_samples) -> (..., n_mels, frames).

    Framing is a gather, the spectrum ``torch.fft.rfft``, the mel projection
    one matrix product.  ``center=False`` treats y as already padded (frames
    read y directly): the batched variable-length preprocessing reflect-pads
    each clip on the host before the zero extension to the bucket length,
    because a shared reflect pad would reflect the zeros instead of the
    signal into the final frames.
    """
    batch_shape = y.shape[:-1]
    y_pad, n_frames = pad_and_count(y.reshape(-1, y.shape[-1]).float(), n_fft, hop_length, center)
    window = torch.from_numpy(padded_window(win_length, n_fft)).to(y.device)
    frames = windowed_frames(y_pad, n_frames, window, hop_length)
    mag = torch.fft.rfft(frames, n=n_fft, dim=-1).abs()  # (B, frames, bins)
    basis = torch.from_numpy(mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)).to(y.device)
    out = dynamic_range_compression(torch.einsum("bfk,mk->bmf", mag, basis))
    return out.reshape(batch_shape + out.shape[1:])


def normalize_mel(mel, mean: float, std: float):
    """(mel - mean) / (std + 1e-8) — ref: audio.py:70-71."""
    return (mel - mean) / (std + 1e-8)


def denormalize_mel(mel, mean: float, std: float):
    """mel * (std + 1e-8) + mean — ref: audio.py:74-75."""
    return mel * (std + 1e-8) + mean


def dft_matrices(n_fft: int, dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT basis for the matrix-product STFT (the kernel's path).

    Returns (cos, sin) each of shape (n_fft, 1 + n_fft//2) such that for a
    windowed frame x: Re = x @ cos, Im = -(x @ sin).
    """
    n_bins = 1 + n_fft // 2
    t = np.arange(n_fft)[:, None].astype(np.float64)
    k = np.arange(n_bins)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * t * k / n_fft
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)
