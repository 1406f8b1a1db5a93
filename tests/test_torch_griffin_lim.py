"""The port's Griffin-Lim (``dsp/griffin_lim.py``) vs the JAX package's, on
the log-mel of a seeded chirp in noise, for every (n_fft, win_length) of
``configs/*.yaml`` and one with a window shorter than n_fft.

Tolerances, fp32, as fractions of the output's peak (0.95), measured on
this CPU in brackets:
- the framing, the inverse-mel estimate and the overlap-add normalisation
  (``n_iter=0``): 1e-4 (<= 1.2e-6);
- one STFT and one inverse STFT of the same signal against the JAX
  package's ``_stft`` / ``_istft``: 1e-5 relative (<= 1e-6);
- the default 32 iterations: 3e-2 (<= 1.5e-2), and the log-mel of the two
  waveforms within 2e-2 on average (<= 6.8e-3).  Each iteration divides the
  STFT by its own magnitude, which amplifies rounding where that magnitude is
  small: both packages' fp32 results drift from a float64 run of the same
  algorithm by 2e-3 to 1e-2 of the peak after 32 iterations, so 1e-4 holds
  only before the iterations.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tests.test_torch_models import configs
from tests.test_torch_serving import STATS, TEXTS
from transformertts_tpu.dsp.griffin_lim import _istft as jax_istft
from transformertts_tpu.dsp.griffin_lim import _stft as jax_stft
from transformertts_tpu.dsp.griffin_lim import griffin_lim as jax_griffin_lim
from transformertts_tpu_torch.dsp import mel_spectrogram_np
from transformertts_tpu_torch.dsp.griffin_lim import _Frames, griffin_lim, write_wav
from transformertts_tpu_torch.dsp.mel import padded_window
from transformertts_tpu_torch.infer import Synthesizer
from transformertts_tpu_torch.models import TransformerTTS

SR, HOP = 22050, 256


def _pairs():
    pairs = set()
    for path in sorted((Path(__file__).resolve().parents[1] / "configs").glob("*.yaml")):
        audio = (yaml.safe_load(path.read_text()) or {}).get("audio", {})
        pairs.add((int(audio.get("n_fft", 1024)), int(audio.get("win_length", 1024))))
    return sorted(pairs | {(1024, 800)})


PAIRS = _pairs()


def _signal(seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(SR // 2) / SR
    return (0.5 * np.sin(2 * np.pi * (200 + 400 * t) * t)
            + 0.05 * rng.standard_normal(len(t))).astype(np.float32)


def _mel(y, n_fft, win):
    return mel_spectrogram_np(y, SR, n_fft, HOP, win, 0.0, 8000.0, 80).astype(np.float32)


@pytest.mark.parametrize("n_fft,win", PAIRS)
def test_framing_matches_jax(n_fft, win):
    y = _signal(1)[: 40 * HOP]
    window = padded_window(win, n_fft)
    plan = _Frames(41, n_fft, HOP, len(y), torch.from_numpy(window), "cpu")
    spec = plan.stft(torch.from_numpy(y))
    ref = np.asarray(jax_stft(jnp.asarray(y), n_fft, HOP, jnp.asarray(window)))
    assert np.abs(spec.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    back = plan.istft(spec).numpy()
    ref_back = np.asarray(jax_istft(jnp.asarray(ref), n_fft, HOP, jnp.asarray(window), len(y)))
    assert np.abs(back - ref_back).max() <= 1e-5 * np.abs(ref_back).max()
    np.testing.assert_allclose(back[n_fft:-n_fft], y[n_fft:-n_fft], atol=1e-5)


@pytest.mark.parametrize("n_fft,win", PAIRS)
def test_griffin_lim_matches_jax(n_fft, win):
    mel = _mel(_signal(0), n_fft, win)
    kw = dict(n_fft=n_fft, win_length=win)
    start, ref_start = griffin_lim(mel, n_iter=0, device="cpu", **kw), jax_griffin_lim(
        mel, n_iter=0, **kw)
    assert start.shape == ref_start.shape == ((mel.shape[1] - 1) * HOP,)
    assert np.abs(start - ref_start).max() <= 1e-4 * 0.95
    y, ref = griffin_lim(mel, device="cpu", **kw), jax_griffin_lim(mel, **kw)
    assert y.dtype == np.float32 and abs(np.abs(y).max() - 0.95) < 1e-6
    assert np.abs(y - ref).max() <= 3e-2 * 0.95
    assert np.abs(_mel(y, n_fft, win) - _mel(ref, n_fft, win)).mean() <= 2e-2
    # a tensor is inverted on its own device, to the same result
    assert np.array_equal(griffin_lim(torch.from_numpy(mel), **kw), y)


def test_synthesize_wav_and_write(tmp_path):
    cfg = configs(stop_threshold=2.0)[1]
    synth = Synthesizer(cfg, state_dict=TransformerTTS(cfg.model, device="cpu").state_dict(),
                        stats=STATS, device="cpu")
    y = synth.synthesize_wav(TEXTS[0], max_len=12)
    mel = synth.synthesize(TEXTS[0], max_len=12)[0]
    assert synth.stats == STATS and np.array_equal(y, synth.mel_to_wav(mel))
    assert y.shape == (11 * HOP,) and np.isfinite(y).all()
    write_wav(tmp_path / "a.wav", y)
    assert (tmp_path / "a.wav").stat().st_size == 44 + 2 * len(y)
    assert griffin_lim(mel[:, :1], device="cpu").shape == (0,)
