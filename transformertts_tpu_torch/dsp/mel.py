"""Mel helpers of ``transformertts_tpu/dsp/mel.py``.

Only ``denormalize_mel`` is on the serving path; the STFT and filterbank
come with the preprocessing slice.
"""

from __future__ import annotations


def denormalize_mel(mel, mean: float, std: float):
    """mel * (std + 1e-8) + mean — ref: audio.py:74-75."""
    return mel * (std + 1e-8) + mean
