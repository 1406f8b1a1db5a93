"""Griffin-Lim mel -> waveform inversion (``transformertts_tpu/dsp/griffin_lim.py``).

The reference produces mel spectrograms only (no vocoder).  For an audible
end-to-end path the port inverts its own features: log-mel -> linear
magnitude through a non-negative pseudo-inverse of the slaney filterbank,
then Griffin-Lim phase recovery with an STFT / inverse STFT in torch on the
caller's device.

The framing is the JAX package's: the signal is reflect-padded by
``n_fft // 2`` on both sides, frame ``f`` starts at ``f * hop`` of the
padded signal, the Hann window (centred in ``n_fft`` when ``win_length <
n_fft``) weighs each frame on the way in and out, the overlap-add is divided
by the summed squared window (floored at 1e-8), and a mel of T frames
inverts to ``(T - 1) * hop`` samples.
"""

from __future__ import annotations

import functools
import wave

import numpy as np
import torch

from transformertts_tpu_torch.device import resolve_device
from transformertts_tpu_torch.dsp.mel import mel_filterbank, padded_window


@functools.lru_cache(maxsize=4)
def _inv_mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    basis = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)  # (n_mels, bins)
    inv = np.linalg.pinv(basis)
    return np.maximum(inv, 0.0).astype(np.float32)  # (bins, n_mels)


def mel_to_linear(log_mel: torch.Tensor, sr=22050, n_fft=1024, fmin=0.0,
                  fmax=8000.0) -> torch.Tensor:
    """(n_mels, T) log-mel -> (bins, T) linear magnitude estimate."""
    inv = torch.from_numpy(
        _inv_mel_basis(sr, n_fft, log_mel.shape[0], float(fmin), float(fmax))
    ).to(log_mel.device)
    return torch.clamp(inv @ torch.exp(log_mel.float()), min=1e-10)


class _Frames:
    """Index plan of the STFT and overlap-add for ``n_frames`` frames."""

    def __init__(self, n_frames: int, n_fft: int, hop: int, n_samples: int, window, device):
        pad = n_fft // 2
        starts = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
        # reflect padding as numpy (and jnp.pad) define it, as a gather
        reflect = np.pad(np.arange(n_samples), (pad, pad), mode="reflect")
        self.src = torch.from_numpy(reflect[starts]).to(device)  # (frames, n_fft) into y
        self.dst = torch.from_numpy(starts.reshape(-1)).to(device)  # into the padded output
        self.total = n_fft + hop * (n_frames - 1)
        self.window = window
        wsq = torch.zeros(self.total, device=device).index_add_(
            0, self.dst, (window ** 2).repeat(n_frames))
        self.norm = torch.clamp(wsq, min=1e-8)
        self.n_fft, self.pad, self.n_samples = n_fft, pad, n_samples

    def stft(self, y: torch.Tensor) -> torch.Tensor:
        return torch.fft.rfft(y[self.src] * self.window, dim=-1)  # (frames, bins)

    def istft(self, spec: torch.Tensor) -> torch.Tensor:
        frames = torch.fft.irfft(spec, n=self.n_fft, dim=-1) * self.window
        y = torch.zeros(self.total, device=frames.device).index_add_(
            0, self.dst, frames.reshape(-1))
        return (y / self.norm)[self.pad: self.pad + self.n_samples]


def griffin_lim(
    log_mel,  # (n_mels, T) numpy array or tensor
    sample_rate: int = 22050,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    fmin: float = 0.0,
    fmax: float = 8000.0,
    n_iter: int = 32,
    device: str | torch.device | None = None,
) -> np.ndarray:
    """Invert a log-mel spectrogram to a waveform (float32 numpy, peak 0.95).

    A tensor is inverted on its own device; a numpy array on ``device``
    (None means the GPU)."""
    if not torch.is_tensor(log_mel):
        log_mel = torch.from_numpy(np.asarray(log_mel, np.float32)).to(resolve_device(device))
    dev = log_mel.device
    mag = mel_to_linear(log_mel, sample_rate, n_fft, fmin, fmax).t().contiguous()  # (T, bins)
    window = torch.from_numpy(padded_window(win_length, n_fft)).to(dev)
    n_frames = mag.shape[0]
    if n_frames < 2:  # (T - 1) * hop samples: nothing to invert
        return np.zeros(0, np.float32)
    plan = _Frames(n_frames, n_fft, hop_length, (n_frames - 1) * hop_length, window, dev)
    y = plan.istft(mag.to(torch.complex64))
    for _ in range(int(n_iter)):
        spec = plan.stft(y)
        phase = spec / torch.clamp(spec.abs(), min=1e-10)
        y = plan.istft(mag * phase)
    y = y.cpu().numpy()
    peak = np.abs(y).max() if y.size else 0.0
    return (y / peak * 0.95).astype(np.float32) if peak > 0 else y.astype(np.float32)


def wav_bytes(y: np.ndarray, sample_rate: int = 22050) -> bytes:
    """Mono 16-bit PCM RIFF bytes of ``y`` (clipped to [-1, 1])."""
    import io

    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes((np.clip(y, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def write_wav(path, y: np.ndarray, sample_rate: int = 22050) -> None:
    with open(path, "wb") as f:
        f.write(wav_bytes(y, sample_rate))
