"""PyTorch port vs JAX package: log-mel extraction.

The same numpy-seeded signals go through the JAX ``log_mel_pallas``
(Pallas, ``interpret=True``), ``mel_spectrogram_jax`` and
``mel_spectrogram_np``, and through the port's ``log_mel`` on the CPU (the
kernel's plain version: two DFT matrix products), ``mel_spectrogram_torch``
(rFFT) and its own ``mel_spectrogram_np``.

Tolerances, absolute on the log-mel:
- matrix-product DFT in fp32 against the float64 numpy FFT: 2e-2 at most and
  2e-3 in the mean, as ``tests/test_pallas_stft.py`` holds the Pallas kernel;
- the port's plain version against the Pallas kernel in interpret mode (the
  same products in another summation order) and rFFT against rFFT: 1e-3;
- ``center=False`` over a host reflect-padded, zero-extended signal against
  ``center=True`` (the batched-preprocess contract): 1e-4;
- the numpy functions and the constants: equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformertts_tpu.dsp import mel as jax_mel
from transformertts_tpu.ops.pallas.stft import log_mel_pallas
from transformertts_tpu_torch.dsp import mel as port_mel
from transformertts_tpu_torch.dsp import (
    dft_matrices,
    dynamic_range_compression,
    hann_window,
    mel_filterbank,
    mel_spectrogram_np,
    mel_spectrogram_torch,
    normalize_mel,
    stft_magnitude_np,
)
from transformertts_tpu_torch.ops.stft import log_mel

KW = dict(sample_rate=22050, n_fft=1024, hop_length=256, win_length=1024,
          fmin=0.0, fmax=8000.0, n_mels=80)
SMALL = dict(sample_rate=16000, n_fft=256, hop_length=64, win_length=200,
             fmin=50.0, fmax=7000.0, n_mels=40)


def _signal(shape, seed, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("kw", [KW, SMALL], ids=["default", "short_window"])
def test_constants_equal_the_jax_modules(kw):
    np.testing.assert_array_equal(hann_window(kw["win_length"]),
                                  jax_mel.hann_window(kw["win_length"]))
    args = (kw["sample_rate"], kw["n_fft"], kw["n_mels"], kw["fmin"], kw["fmax"])
    np.testing.assert_array_equal(mel_filterbank(*args), jax_mel.mel_filterbank(*args))
    for ours, theirs in zip(dft_matrices(kw["n_fft"]), jax_mel.dft_matrices(kw["n_fft"])):
        np.testing.assert_array_equal(ours, theirs)
    f = np.linspace(0.0, 9000.0, 50)
    np.testing.assert_array_equal(port_mel._hz_to_mel_slaney(f), jax_mel._hz_to_mel_slaney(f))
    np.testing.assert_array_equal(port_mel._mel_to_hz_slaney(f / 100.0),
                                  jax_mel._mel_to_hz_slaney(f / 100.0))


def test_numpy_path_equals_the_jax_modules():
    y = _signal(22050 + 100, 0)
    args = (y, KW["n_fft"], KW["hop_length"], KW["win_length"])
    np.testing.assert_array_equal(stft_magnitude_np(*args), jax_mel.stft_magnitude_np(*args))
    ours, theirs = mel_spectrogram_np(y, **KW), jax_mel.mel_spectrogram_np(y, **KW)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(normalize_mel(ours, -4.0, 2.0),
                                  jax_mel.normalize_mel(theirs, -4.0, 2.0))
    s = np.abs(_signal((5, 7), 1))
    np.testing.assert_array_equal(dynamic_range_compression(s),
                                  jax_mel.dynamic_range_compression(s))
    np.testing.assert_allclose(dynamic_range_compression(torch.from_numpy(s)).numpy(),
                               dynamic_range_compression(s), rtol=1e-6)


def test_log_mel_matches_pallas_and_numpy():
    y = _signal(22050, 0)
    ref_np = jax_mel.mel_spectrogram_np(y, **KW)
    ref_pallas = np.asarray(log_mel_pallas(jnp.asarray(y), interpret=True, **KW))
    out = log_mel(torch.from_numpy(y), **KW).numpy()
    assert out.shape == ref_np.shape == (80, 1 + 22050 // 256)
    np.testing.assert_allclose(out, ref_pallas, atol=1e-3)
    np.testing.assert_allclose(out, ref_np, atol=2e-2)
    assert np.mean(np.abs(out - ref_np)) < 2e-3
    assert log_mel.launches == 0  # the CPU never launches


def test_log_mel_batched_and_short_window():
    y = _signal((2, 4000), 1, 0.2)
    out = log_mel(torch.from_numpy(y), **SMALL).numpy()
    ref = np.asarray(log_mel_pallas(jnp.asarray(y), interpret=True, **SMALL))
    assert out.shape == ref.shape == (2, 40, 1 + 4000 // 64)
    np.testing.assert_allclose(out, ref, atol=1e-3)
    np.testing.assert_allclose(out[1], mel_spectrogram_np(y[1], **SMALL), atol=2e-2)


@pytest.mark.parametrize("fn", [log_mel, mel_spectrogram_torch], ids=["log_mel", "rfft"])
def test_center_false_matches_host_prepad(fn):
    """center=False over a host reflect-padded, zero-extended signal gives
    the center=True result for the true frame count, and what the JAX
    functions give for the same padded signal."""
    n = 8192 + 777
    y = _signal(n, 3)
    ref = fn(torch.from_numpy(y), **KW).numpy()
    pad = KW["n_fft"] // 2
    padded = np.zeros(16384, np.float32)
    padded[: n + 2 * pad] = np.pad(y, pad, mode="reflect")
    out = fn(torch.from_numpy(padded), center=False, **KW).numpy()
    n_frames = 1 + n // KW["hop_length"]
    assert out.shape == (80, 1 + (16384 - 1024) // 256)
    np.testing.assert_allclose(out[:, :n_frames], ref, atol=1e-4)
    if fn is log_mel:
        theirs = log_mel_pallas(jnp.asarray(padded), interpret=True, center=False, **KW)
    else:
        theirs = jax_mel.mel_spectrogram_jax(jnp.asarray(padded), center=False, **KW)
    np.testing.assert_allclose(out, np.asarray(theirs), atol=1e-3)


def test_mel_spectrogram_torch_matches_jax_and_numpy():
    y = _signal((2, 3, 5000), 4)
    out = mel_spectrogram_torch(torch.from_numpy(y), **KW).numpy()
    ref = np.asarray(jax_mel.mel_spectrogram_jax(jnp.asarray(y), **KW))
    assert out.shape == ref.shape == (2, 3, 80, 1 + 5000 // 256)
    np.testing.assert_allclose(out, ref, atol=1e-3)
    np.testing.assert_allclose(out[1, 2], mel_spectrogram_np(y[1, 2], **KW), atol=1e-3)


def test_sine_tone_peaks_in_the_same_band():
    t = np.arange(11025) / 22050
    y = (0.5 * np.sin(2 * np.pi * 1000 * t)).astype(np.float32)
    out = log_mel(torch.from_numpy(y), **KW).numpy()
    assert out.mean(1).argmax() == mel_spectrogram_np(y, **KW).mean(1).argmax()


def test_plain_flag_and_dtype():
    y = torch.from_numpy(_signal(3000, 5)).double()
    a, b = log_mel(y, **SMALL), log_mel(y, plain=True, **SMALL)
    assert a.dtype == torch.float32 and torch.equal(a, b)
