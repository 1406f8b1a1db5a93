from transformertts_tpu_torch.dsp.mel import (  # noqa: F401
    denormalize_mel,
    dft_matrices,
    dynamic_range_compression,
    hann_window,
    mel_filterbank,
    mel_spectrogram_np,
    mel_spectrogram_torch,
    normalize_mel,
    stft_magnitude_np,
)
