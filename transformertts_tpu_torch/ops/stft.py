"""STFT magnitude -> mel -> log in one pass, as a hand-written CUDA kernel for
Hopper.

Replaces the TPU kernel of ``transformertts_tpu/ops/pallas/stft.py``:
``log_mel_pallas`` (``_kernel``).  The CUDA source is ``csrc/log_mel.cu``.
For the windowed frames X (frames, n_fft) of a batch of signals,

    Re = X C,  Im = X S          the DFT as two matrix products
    mag = sqrt(Re^2 + Im^2)
    out = log(clip(mag M^T, 1e-5))

all in fp32, with the (frames, bins) magnitudes never in device memory.  C,
S (``dft_matrices``), the window and M (``mel_filterbank``) are built on the
host in float64, cast, and cached per device.

What differs from the TPU version: its wrapper gathered the overlapping
frames and multiplied the window before the kernel, writing every sample
``n_fft / hop`` times; the CUDA kernel reads the padded signal itself at
``frame * hop`` and multiplies the window as it loads (the plain version
does the gather).  The TPU's pad of the bins to 640, of the frame count to a
multiple of 128 and its index clamp are lane rules that the CUDA kernel
replaces by bounds checks.

What bounds the function on an H100: about as much its bytes (the signal in,
the log-mels out) as its operations, if the DFT is counted as an FFT (2.5
n_fft log2 n_fft per frame): some 10 us for 32 signals of 163,840 samples.
This kernel computes the DFT as two dense products instead, 4 n_fft bins
operations per frame, 80 times the FFT's, so its own floor is those
products at the fp32 rate (about 0.64 ms for that batch), far above the
function's bound.

On a CUDA tensor ``log_mel`` launches the kernel or raises; the plain
version runs for CPU tensors, or on any device when the caller passes
``plain=True``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from transformertts_tpu_torch.dsp.mel import (
    dft_matrices,
    mel_filterbank,
    pad_and_count,
    padded_window,
    windowed_frames,
)

CLIP = 1e-5
MAX_MELS = 128  # mel columns the kernel's register layout holds


@functools.lru_cache(maxsize=8)
def _constants(sample_rate, n_fft, win_length, n_mels, fmin, fmax, device):
    """(window (n_fft), C, S (n_fft, bins), M^T (bins, n_mels)) fp32 on ``device``."""
    cos, sin = dft_matrices(n_fft)
    basis = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)
    arrays = (padded_window(win_length, n_fft), cos, sin, basis.T)
    return tuple(torch.from_numpy(a.copy()).contiguous().to(device) for a in arrays)


def log_mel_reference(y_pad, n_frames, window, cos, sin, melt, hop_length):
    """Plain version of the kernel on padded (B, n_pad) fp32 signals: the
    frames as a gather, the same two DFT products, magnitude, mel product
    and log-clip in fp32 PyTorch.  Returns (B, n_mels, n_frames)."""
    frames = windowed_frames(y_pad, n_frames, window, hop_length)  # (B, frames, n_fft)
    re, im = frames @ cos, frames @ sin
    mel = torch.sqrt(re * re + im * im) @ melt
    return torch.log(torch.clamp(mel, min=CLIP)).transpose(1, 2).contiguous()


def _lib():
    from transformertts_tpu_torch import _build

    lib = _build.load("log_mel")
    if not getattr(lib, "_argtypes_set", False):
        i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
        lib.tts_log_mel.argtypes = [i] * 7 + [p] * 6 + [f, p]
        lib.tts_log_mel.restype = i
        lib._argtypes_set = True
    return lib


def log_mel_forward(y_pad, n_frames, window, cos, sin, melt, hop_length):
    """The kernel on padded (B, n_pad) fp32 CUDA signals: (B, n_mels,
    n_frames), or raises."""
    b, n = y_pad.shape
    n_fft, n_bins = cos.shape
    n_mels = melt.shape[1]
    if n_mels > MAX_MELS or b > 65535:
        raise ValueError(f"log-mel kernel takes up to {MAX_MELS} mel bands and 65535 signals, "
                         f"got {n_mels} and {b}")
    if n_frames < 1 or (n_frames - 1) * hop_length + n_fft > n:
        raise ValueError(f"log-mel kernel: {n_frames} frames of {n_fft} samples at hop "
                         f"{hop_length} do not fit {n} samples")
    for name, t, shape in (("y", y_pad, (b, n)), ("window", window, (n_fft,)),
                           ("cos", cos, (n_fft, n_bins)), ("sin", sin, (n_fft, n_bins)),
                           ("mel basis", melt, (n_bins, n_mels))):
        if (t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != y_pad.device
                or not t.is_contiguous()):
            raise ValueError(f"log-mel kernel: {name} must be a contiguous float32 of shape "
                             f"{shape} on {y_pad.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    out = torch.empty((b, n_mels, n_frames), dtype=torch.float32, device=y_pad.device)
    rc = _lib().tts_log_mel(
        b, n, n_fft, hop_length, n_bins, n_mels, n_frames, y_pad.data_ptr(), window.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), melt.data_ptr(), out.data_ptr(), CLIP,
        torch.cuda.current_stream(y_pad.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"log-mel kernel failed to launch (CUDA error {rc}) for "
                           f"{b} signals of {n} samples, {n_frames} frames")
    log_mel.launches += 1
    return out


def log_mel(
    y: torch.Tensor,  # (n_samples,) or (B, n_samples)
    sample_rate: int = 22050,
    n_fft: int = 1024,
    hop_length: int = 256,
    win_length: int = 1024,
    fmin: float = 0.0,
    fmax: float = 8000.0,
    n_mels: int = 80,
    center: bool = True,
    plain: bool = False,
) -> torch.Tensor:
    """Log-mel of y on y's device: (..., n_mels, n_frames), fp32.

    ``center=True`` reflect-pads n_fft // 2 samples and gives 1 + n // hop
    frames; ``center=False`` takes y as already padded (see
    ``mel_spectrogram_torch``) and gives 1 + (n - n_fft) // hop.
    ``plain=True`` asks for the plain version whatever the device."""
    squeeze = y.ndim == 1
    y2 = (y[None] if squeeze else y).float()
    y_pad, n_frames = pad_and_count(y2, n_fft, hop_length, center)
    consts = _constants(int(sample_rate), int(n_fft), int(win_length), int(n_mels), float(fmin),
                        float(fmax), y.device)
    run = log_mel_reference if plain or y.device.type == "cpu" else log_mel_forward
    out = run(y_pad.contiguous(), n_frames, *consts, int(hop_length))
    return out[0] if squeeze else out


log_mel.launches = 0  # kernel launches
