"""The log-mel FFT kernel's plan, band lists and FFT schedule, on the CPU.

The CUDA kernel itself runs only on the card (``chip_smoke.py``); what it is
handed and how it computes is modelled here in plain PyTorch and numpy:

- ``mel_kernel_plan``: a power-of-two n_fft from 256 to 2,048 selects the FFT
  kernel, any other the dense one (a pure function, no launch);
- ``mel_bands``: summed in increasing bin order over a band's bins only, the
  lists give the bits of the same sum over every bin of the dense
  filterbank (a zero weight adds an exact zero), in fp32;
- ``rfft_schedule`` (the kernel's Stockham stages, radices and twiddle
  table, in fp32) against ``np.fft.rfft`` in float64: within 1e-6 of the
  largest magnitude (measured about 1.3e-7: fp32 rounding over log2 n_fft
  stages);
- ``log_mel_fft_model`` against ``log_mel_pallas(..., interpret=True)`` of
  the JAX package: 1e-3 absolute on the log-mel, as the port's plain
  version is held (the Pallas kernel's dense fp32 DFT sums 1,024 terms),
  and against ``mel_spectrogram_np`` (float64 FFT): 2e-4 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transformertts_tpu.ops.pallas.stft import log_mel_pallas
from transformertts_tpu_torch.dsp import mel_filterbank, mel_spectrogram_np
from transformertts_tpu_torch.dsp.mel import pad_and_count, padded_window
from transformertts_tpu_torch.ops import stft

KW = dict(sample_rate=22050, n_fft=1024, hop_length=256, win_length=1024,
          fmin=0.0, fmax=8000.0, n_mels=80)


@pytest.mark.parametrize("n_fft,hop,kernel", [
    (256, 64, "fft"), (512, 128, "fft"), (1024, 256, "fft"), (2048, 512, "fft"),
    (800, 200, "dense"), (1000, 250, "dense"), (128, 32, "dense"), (4096, 1024, "dense"),
    (1536, 384, "dense"),
])
def test_dispatch_by_n_fft(n_fft, hop, kernel):
    plan = stft.mel_kernel_plan(n_fft, hop, 80)
    assert plan["kernel"] == kernel
    if kernel == "fft":
        assert int(np.prod(plan["radices"])) == n_fft // 2
        assert all(r == 8 for r in plan["radices"][:-1]) and plan["radices"][-1] in (2, 4, 8)
        assert plan["fpb"] == 32 and plan["smem"] <= 232448


def test_plan_takes_fewer_frames_where_32_do_not_fit():
    plan = stft.mel_kernel_plan(2048, 2048, 80)  # 32 frames would hold 66,000 samples
    assert plan["fpb"] < 32 and plan["smem"] <= 232448 < stft._fft_smem(2048, 2048, 80, 2 * plan["fpb"])


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax", [
    (22050, 1024, 80, 0.0, 8000.0), (16000, 512, 40, 50.0, 7000.0), (24000, 2048, 128, 30.0, 11000.0),
], ids=["config", "narrow", "wide"])
def test_band_lists_reproduce_the_dense_product_exactly(sr, n_fft, n_mels, fmin, fmax):
    basis = mel_filterbank(sr, n_fft, n_mels, fmin, fmax)
    bands, weights = stft.mel_bands(basis)
    assert bands.dtype == np.int32 and weights.dtype == np.float32
    assert int(bands[:, 1].sum()) == weights.size >= int(np.count_nonzero(basis))
    mag = np.abs(np.random.default_rng(n_fft).standard_normal((64, basis.shape[1]))).astype(np.float32)
    dense = np.zeros((64, n_mels), np.float32)
    for k in range(basis.shape[1]):  # every bin, in increasing order
        dense += basis[:, k][None, :] * mag[:, k][:, None]
    sparse = np.zeros((64, n_mels), np.float32)
    for c, (first, bins, at) in enumerate(bands):
        for t in range(bins):
            sparse[:, c] += weights[at + t] * mag[:, first + t]
    np.testing.assert_array_equal(sparse, dense)
    np.testing.assert_allclose(sparse, mag @ basis.T, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n_fft", [256, 1024, 2048])
def test_fft_schedule_matches_numpy(n_fft):
    frames = np.random.default_rng(n_fft).standard_normal((6, n_fft)).astype(np.float32)
    re, im = stft.rfft_schedule(torch.from_numpy(frames), torch.from_numpy(stft.fft_twiddles(n_fft)))
    ref = np.fft.rfft(frames.astype(np.float64), axis=-1)
    assert re.dtype == im.dtype == torch.float32 and re.shape == (6, n_fft // 2 + 1)
    err = max(np.abs(re.numpy() - ref.real).max(), np.abs(im.numpy() - ref.imag).max())
    assert err <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("n_fft,hop,win", [(256, 64, 200), (1024, 256, 1024), (2048, 512, 2048)])
def test_fft_model_log_mel_matches_pallas_and_numpy(n_fft, hop, win):
    kw = dict(KW, n_fft=n_fft, hop_length=hop, win_length=win)
    y = (np.random.default_rng(n_fft).standard_normal(6000) * 0.3).astype(np.float32)
    y_pad, n_frames = pad_and_count(torch.from_numpy(y)[None], n_fft, hop, True)
    bands, weights = stft.mel_bands(mel_filterbank(22050, n_fft, 80, 0.0, 8000.0))
    out = stft.log_mel_fft_model(
        y_pad, n_frames, torch.from_numpy(padded_window(win, n_fft)),
        torch.from_numpy(stft.fft_twiddles(n_fft)), torch.from_numpy(bands),
        torch.from_numpy(weights), hop)[0].numpy()
    ref_pallas = np.asarray(log_mel_pallas(jnp.asarray(y), interpret=True, **kw))
    ref_np = mel_spectrogram_np(y, **kw)
    assert out.shape == ref_np.shape == (80, 1 + 6000 // hop)
    np.testing.assert_allclose(out, ref_pallas, atol=1e-3)
    np.testing.assert_allclose(out, ref_np, atol=2e-4)


def test_operation_count_is_the_ffts_not_the_dense_products():
    """0.59 GFLOP for the batch preprocess sends (20,384 frames) against the
    dense products' 4 n_fft bins a frame (42.8 GFLOP)."""
    nz = int(np.count_nonzero(mel_filterbank(22050, 1024, 80, 0.0, 8000.0)))
    per_frame = stft.fft_kernel_operations(1024, nz, 80)
    assert 25_000 < per_frame < 35_000 and per_frame * 70 < 4 * 1024 * 513
