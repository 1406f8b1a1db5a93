"""WAV loading without librosa/soundfile (neither is a dependency).

Reads PCM WAV via the stdlib ``wave`` module; resamples with
``scipy.signal.resample_poly`` when the file rate differs from the target
(LJSpeech is natively 22,050 Hz, so the resample path is rarely taken).
Matches ``librosa.load(path, sr=...)``'s contract: float32 mono in [-1, 1].
(ref: audio.py:6-12)
"""

from __future__ import annotations

import wave
from math import gcd
from pathlib import Path

import numpy as np


def load_wav(path: str | Path, target_sr: int | None = None) -> tuple[np.ndarray, int]:
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        n_channels = w.getnchannels()
        sampwidth = w.getsampwidth()
        raw = w.readframes(w.getnframes())

    if sampwidth == 2:
        y = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        y = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 1:
        y = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {sampwidth} in {path}")

    if n_channels > 1:
        y = y.reshape(-1, n_channels).mean(axis=1)

    if target_sr is not None and sr != target_sr:
        from scipy.signal import resample_poly

        g = gcd(target_sr, sr)
        y = resample_poly(y, target_sr // g, sr // g).astype(np.float32)
        sr = target_sr
    return y, sr
