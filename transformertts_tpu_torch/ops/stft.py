"""STFT magnitude -> mel -> log in one pass, as hand-written CUDA kernels for
Hopper.

Replaces the TPU kernel of ``transformertts_tpu/ops/pallas/stft.py``:
``log_mel_pallas`` (``_kernel``).  The CUDA source is ``csrc/log_mel.cu``.
For the windowed frames X (frames, n_fft) of a batch of signals,

    out = log(clip(|DFT(X)| M^T, 1e-5))

all in fp32, with the (frames, bins) magnitudes never in device memory.
Two kernels compute it, chosen by ``mel_kernel_plan`` from n_fft alone:

- n_fft a power of two from 256 to 2,048 (every configuration of the repo):
  ``log_mel_fft_forward``, a real FFT a frame (an n_fft / 2-point complex
  FFT of Stockham stages, radix 8 then 4 or 2, and the split step; the
  twiddles ``fft_twiddles``) and each mel band summed over the filterbank's
  non-zero weights only (``mel_bands``), in increasing bin order;
- any other n_fft: ``log_mel_forward``, the DFT as two dense products with
  the matrices C, S (``dft_matrices``), as the TPU kernel does.

Both tables and matrices are built on the host in float64, cast, and cached
per device.  ``rfft_schedule`` is a plain PyTorch model of the FFT kernel's
stages (their order, radices and twiddle table), for the tests.

The plain version of both, ``log_mel_reference``, does what the TPU kernel
does op for op: the frames as a gather, Re = X C and Im = X S, magnitude,
mel product, log-clip.  What differs from the TPU version: its wrapper
gathered the overlapping frames and multiplied the window before the
kernel, writing every sample ``n_fft / hop`` times; the CUDA kernels read
the padded signal itself at ``frame * hop`` and multiply the window as they
load.  The TPU's pad of the bins to 640, of the frame count to a multiple of
128 and its index clamp are lane rules that the CUDA kernels replace by
bounds checks.

What bounds the function on an H100: about as much its bytes (the signal in,
the log-mels out) as its operations, if the DFT is counted as an FFT (2.5
n_fft log2 n_fft per frame): some 9 us for 32 signals of 163,840 samples.
The dense kernel does 4 n_fft bins operations per frame instead, 80 times
the FFT's (about 0.64 ms at the fp32 peak for that batch).

On a CUDA tensor ``log_mel`` launches a kernel or raises; the plain version
runs for CPU tensors, or on any device when the caller passes
``plain=True``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from transformertts_tpu_torch.dsp.mel import (
    dft_matrices,
    mel_filterbank,
    pad_and_count,
    padded_window,
    windowed_frames,
)

CLIP = 1e-5
MAX_MELS = 128  # mel columns the dense kernel's register layout holds
FFT_SIZES = (256, 512, 1024, 2048)  # the n_fft the FFT kernel is built for
_FFT_WARPS = 8  # warps of an FFT block, one frame each at a time
_SMEM_MAX = 232448  # dynamic shared memory a block may take on an H100


def fft_radices(m: int) -> list[int]:
    """Radices of the Stockham stages of an m-point complex FFT (m a power
    of two): 8 while it divides what is left, then 4 or 2."""
    out, ns = [], 1
    while ns < m:
        out.append(8 if ns * 8 <= m else m // ns)
        ns *= out[-1]
    return out


def _fft_smem(n_fft: int, hop: int, n_mels: int, fpb: int) -> int:
    """Bytes of shared memory of an FFT block (as ``csrc/log_mel.cu``):
    the samples, window and twiddles, each warp's buffer, the output tile."""
    m = n_fft // 2
    padded = m + m // 32
    span = -(-((fpb - 1) * hop + n_fft) // 4) * 4
    warp = -(-(2 * padded + m + 1) // 4) * 4
    return 4 * (span + 3 * n_fft + _FFT_WARPS * warp + n_mels * fpb)


def mel_kernel_plan(n_fft: int, hop_length: int, n_mels: int) -> dict:
    """Which kernel ``log_mel`` launches for these sizes: ``"fft"`` for a
    power-of-two n_fft from 256 to 2,048 (with its stages' radices and the
    frames a block takes: 32, or fewer where the samples of 32 do not fit),
    ``"dense"`` for any other."""
    if n_fft not in FFT_SIZES:
        return {"kernel": "dense"}
    fpb = next((f for f in (32, 16, 8, 4, 2, 1)
                if _fft_smem(n_fft, hop_length, n_mels, f) <= _SMEM_MAX), None)
    if fpb is None:
        raise ValueError(f"log-mel FFT kernel: n_fft {n_fft} at hop {hop_length} with {n_mels} "
                         f"bands does not fit a block's shared memory")
    return {"kernel": "fft", "radices": fft_radices(n_fft // 2), "fpb": fpb,
            "smem": _fft_smem(n_fft, hop_length, n_mels, fpb)}


_DFT_OPS = {2: 4, 4: 16, 8: 56}  # real operations of the kernel's radix-R transforms


def fft_kernel_operations(n_fft: int, nonzero: int, n_mels: int) -> int:
    """Real operations the FFT kernel does for one frame: the window, its
    stages (the transforms, and 6 for each twiddle product after the first
    stage), the split step and magnitude (20 a bin), the mel sums over the
    ``nonzero`` weights and the log of each band."""
    m, ns, ops = n_fft // 2, 1, n_fft
    for r in fft_radices(m):
        ops += (m // r) * (_DFT_OPS[r] + (6 * (r - 1) if ns > 1 else 0))
        ns *= r
    return ops + 20 * (m + 1) + 2 * nonzero + n_mels


def fft_twiddles(n_fft: int) -> np.ndarray:
    """(n_fft, 2) fp32: exp(-2 pi i t / n_fft) for t < n_fft, in float64 and cast."""
    t = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return np.stack([np.cos(t), -np.sin(t)], axis=1).astype(np.float32)


def mel_bands(basis: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The filterbank (n_mels, bins) as compact bands: (n_mels, 3) int32 of
    (first bin, bins, offset into weights), from a band's first to its last
    non-zero weight, and the weights fp32 (as they lie in ``basis``).  A band
    with no weight has 0 bins."""
    bands, weights = np.zeros((basis.shape[0], 3), np.int32), []
    at = 0
    for c, row in enumerate(basis):
        nz = np.flatnonzero(row)
        first, bins = (int(nz[0]), int(nz[-1]) - int(nz[0]) + 1) if nz.size else (0, 0)
        bands[c] = (first, bins, at)
        weights.append(row[first:first + bins])
        at += bins
    return bands, np.concatenate(weights).astype(np.float32)


def _dft(v: list) -> list:
    """The kernel's radix-2, 4 or 8 transform of v (a list of R (re, im)
    pairs of tensors), in its order of operations."""
    add = lambda a, b: (a[0] + b[0], a[1] + b[1])  # noqa: E731
    sub = lambda a, b: (a[0] - b[0], a[1] - b[1])  # noqa: E731
    mul_mi = lambda a: (a[1], -a[0])  # noqa: E731

    def dft4(a0, a1, a2, a3):
        t0, t1, t2, t3 = add(a0, a2), sub(a0, a2), add(a1, a3), mul_mi(sub(a1, a3))
        return [add(t0, t2), add(t1, t3), sub(t0, t2), sub(t1, t3)]

    if len(v) == 2:
        return [add(v[0], v[1]), sub(v[0], v[1])]
    if len(v) == 4:
        return dft4(*v)
    h = np.float32(0.70710678118654752)
    e, o = dft4(v[0], v[2], v[4], v[6]), dft4(v[1], v[3], v[5], v[7])
    o[1] = (h * (o[1][0] + o[1][1]), h * (o[1][1] - o[1][0]))
    o[2] = mul_mi(o[2])
    o[3] = (h * (o[3][1] - o[3][0]), -h * (o[3][0] + o[3][1]))
    return [add(e[q], o[q]) for q in range(4)] + [sub(e[q], o[q]) for q in range(4)]


def rfft_schedule(frames: torch.Tensor, tw: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain model of the FFT kernel's real DFT on windowed fp32 frames
    (..., n_fft): the n_fft / 2-point complex FFT of z[m] = x[2m] + i x[2m+1]
    in the kernel's Stockham stages (``fft_radices``; butterfly j of stage
    (Ns, R) reads points j + r M / R, multiplies point r by table entry r (j %
    Ns) n_fft / (Ns R), transforms, writes point q at (j / Ns) Ns R + j % Ns +
    q Ns), then the split step.  ``tw`` is ``fft_twiddles``.  Returns (re, im)
    of the 1 + n_fft / 2 bins, fp32."""
    n_fft = frames.shape[-1]
    m = n_fft // 2
    re, im = frames[..., 0::2].float(), frames[..., 1::2].float()
    twr, twi = tw[:, 0].float(), tw[:, 1].float()
    ns = 1
    for r_ in fft_radices(m):
        b = m // r_
        j = torch.arange(b)
        k = j % ns
        v = []
        for r in range(r_):
            a = (re[..., j + r * b], im[..., j + r * b])
            if ns > 1 and r > 0:
                t = r * k * (n_fft // (ns * r_))
                wr, wi = twr[t], twi[t]
                a = (a[0] * wr - a[1] * wi, a[0] * wi + a[1] * wr)
            v.append(a)
        out = _dft(v)
        dst = (j // ns) * ns * r_ + k
        re, im = torch.empty_like(re), torch.empty_like(im)
        for q in range(r_):
            re[..., dst + q * ns], im[..., dst + q * ns] = out[q]
        ns *= r_
    k = torch.arange(m + 1)
    k1, k2 = k % m, (m - k) % m
    ar, ai, br, bi = re[..., k1], im[..., k1], re[..., k2], -im[..., k2]
    er, ei = 0.5 * (ar + br), 0.5 * (ai + bi)
    orr, oi = 0.5 * (ai - bi), -(0.5 * (ar - br))  # (a - b) / 2 times -i
    wr, wi = twr[k], twi[k]
    return er + (orr * wr - oi * wi), ei + (orr * wi + oi * wr)


def log_mel_fft_model(y_pad, n_frames, window, tw, bands, weights, hop_length):
    """Plain model of the FFT kernel on padded (B, n_pad) fp32 signals: the
    frames as a gather, ``rfft_schedule``, magnitudes, each band summed over
    its bins in increasing order, log-clip.  Returns (B, n_mels, n_frames)."""
    frames = windowed_frames(y_pad, n_frames, window, hop_length)
    xr, xi = rfft_schedule(frames, tw)
    mag = torch.sqrt(xr * xr + xi * xi)
    mels = []
    for first, bins, at in bands.tolist():
        s = torch.zeros(mag.shape[:-1], dtype=torch.float32)
        for t in range(bins):
            s = s + weights[at + t] * mag[..., first + t]
        mels.append(s)
    mel = torch.stack(mels, dim=1)  # (B, n_mels, frames)
    return torch.log(torch.clamp(mel, min=CLIP))


@functools.lru_cache(maxsize=8)
def _constants(sample_rate, n_fft, win_length, n_mels, fmin, fmax, device):
    """(window (n_fft), C, S (n_fft, bins), M^T (bins, n_mels)) fp32 on ``device``:
    the dense kernel's and the plain version's."""
    cos, sin = dft_matrices(n_fft)
    basis = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax)
    arrays = (padded_window(win_length, n_fft), cos, sin, basis.T)
    return tuple(torch.from_numpy(a.copy()).contiguous().to(device) for a in arrays)


@functools.lru_cache(maxsize=8)
def _fft_constants(sample_rate, n_fft, win_length, n_mels, fmin, fmax, device):
    """(window (n_fft), twiddles (n_fft, 2), bands (n_mels, 3) int32,
    weights) on ``device``: the FFT kernel's."""
    bands, weights = mel_bands(mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax))
    arrays = (padded_window(win_length, n_fft), fft_twiddles(n_fft), bands, weights)
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
        lib.tts_log_mel_fft.argtypes = [i] * 7 + [p] * 6 + [f, p]
        lib.tts_log_mel_fft.restype = i
        lib.tts_log_mel_fft_smem.argtypes = [i] * 4
        lib.tts_log_mel_fft_smem.restype = ctypes.c_longlong
        lib._argtypes_set = True
    return lib


def _check_signal(y_pad, n_frames, n_fft, hop_length, named):
    """Raise unless the kernels can read these: the frames fit the signals,
    and each (name, tensor, dtype, shape) is as named, on y's device."""
    b, n = y_pad.shape
    if b > 65535:
        raise ValueError(f"log-mel kernel takes up to 65535 signals, got {b}")
    if n_frames < 1 or (n_frames - 1) * hop_length + n_fft > n:
        raise ValueError(f"log-mel kernel: {n_frames} frames of {n_fft} samples at hop "
                         f"{hop_length} do not fit {n} samples")
    for name, t, dtype, shape in named:  # the tables are copied 16 bytes at a time
        if (t.dtype != dtype or tuple(t.shape) != shape or t.device != y_pad.device
                or not t.is_contiguous() or (name != "y" and t.data_ptr() % 16)):
            raise ValueError(f"log-mel kernel: {name} must be a contiguous (16-byte aligned) "
                             f"{dtype} of shape {shape} on {y_pad.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def log_mel_fft_forward(y_pad, n_frames, window, tw, bands, weights, hop_length):
    """The FFT kernel on padded (B, n_pad) fp32 CUDA signals: (B, n_mels,
    n_frames), or raises."""
    b, n = y_pad.shape
    n_fft, n_mels = window.shape[0], bands.shape[0]
    plan = mel_kernel_plan(n_fft, hop_length, n_mels)
    if plan["kernel"] != "fft":
        raise ValueError(f"log-mel FFT kernel takes n_fft in {FFT_SIZES}, got {n_fft}")
    _check_signal(y_pad, n_frames, n_fft, hop_length, (
        ("y", y_pad, torch.float32, (b, n)), ("window", window, torch.float32, (n_fft,)),
        ("twiddles", tw, torch.float32, (n_fft, 2)), ("bands", bands, torch.int32, (n_mels, 3)),
        ("weights", weights, torch.float32, (weights.shape[0],))))
    out = torch.empty((b, n_mels, n_frames), dtype=torch.float32, device=y_pad.device)
    rc = _lib().tts_log_mel_fft(
        b, n, n_fft, hop_length, n_mels, n_frames, plan["fpb"], y_pad.data_ptr(),
        window.data_ptr(), tw.data_ptr(), bands.data_ptr(), weights.data_ptr(), out.data_ptr(),
        CLIP, torch.cuda.current_stream(y_pad.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"log-mel FFT kernel failed to launch (CUDA error {rc}) for "
                           f"{b} signals of {n} samples, {n_frames} frames")
    log_mel.launches += 1
    log_mel.launches_fft += 1
    return out


def log_mel_forward(y_pad, n_frames, window, cos, sin, melt, hop_length):
    """The dense kernel on padded (B, n_pad) fp32 CUDA signals: (B, n_mels,
    n_frames), or raises."""
    b, n = y_pad.shape
    n_fft, n_bins = cos.shape
    n_mels = melt.shape[1]
    if n_mels > MAX_MELS:
        raise ValueError(f"dense log-mel kernel takes up to {MAX_MELS} mel bands, got {n_mels}")
    f32 = torch.float32
    _check_signal(y_pad, n_frames, n_fft, hop_length, (
        ("y", y_pad, f32, (b, n)), ("window", window, f32, (n_fft,)),
        ("cos", cos, f32, (n_fft, n_bins)), ("sin", sin, f32, (n_fft, n_bins)),
        ("mel basis", melt, f32, (n_bins, n_mels))))
    out = torch.empty((b, n_mels, n_frames), dtype=torch.float32, device=y_pad.device)
    rc = _lib().tts_log_mel(
        b, n, n_fft, hop_length, n_bins, n_mels, n_frames, y_pad.data_ptr(), window.data_ptr(),
        cos.data_ptr(), sin.data_ptr(), melt.data_ptr(), out.data_ptr(), CLIP,
        torch.cuda.current_stream(y_pad.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"log-mel kernel failed to launch (CUDA error {rc}) for "
                           f"{b} signals of {n} samples, {n_frames} frames")
    log_mel.launches += 1
    log_mel.launches_dense += 1
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
    key = (int(sample_rate), int(n_fft), int(win_length), int(n_mels), float(fmin), float(fmax),
           y.device)
    if plain or y.device.type == "cpu":
        run, consts = log_mel_reference, _constants(*key)
    elif mel_kernel_plan(int(n_fft), int(hop_length), int(n_mels))["kernel"] == "fft":
        run, consts = log_mel_fft_forward, _fft_constants(*key)
    else:
        run, consts = log_mel_forward, _constants(*key)
    out = run(y_pad.contiguous(), n_frames, *consts, int(hop_length))
    return out[0] if squeeze else out


log_mel.launches = 0  # kernel launches, FFT and dense
log_mel.launches_fft = 0  # FFT kernel launches
log_mel.launches_dense = 0  # dense kernel launches
