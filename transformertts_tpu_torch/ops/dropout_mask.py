"""Dropout keep bits as a pure function of the element's logical index.

Replaces ``transformertts_tpu/ops/pallas/dropout_mask.py`` (``keep_mask``,
``seed_from_rng``; no kernel of its own: it is called inside the flash
attention and fused LayerNorm kernels).  The keep bit of one element is

    base = fmix(seed * 0x9E3779B9 ^ fmix(salt * 0xBF58476D))
    keep = fmix(counter * 0x9E3779B9 ^ base) >= uint32(p * 2^32)

in wrapping uint32 arithmetic, with ``fmix`` the murmur3 32-bit finalizer
(one round), ``counter = row * cols + col`` inside the mask block that
``salt`` names.  Because the bit depends on nothing but these integers, a
kernel's backward regenerates the forward's mask instead of storing it, and
the plain versions of the kernels drop exactly the elements the kernels drop.

The device twin is ``csrc/dropout_mask.cuh``.  ``keep_mask`` on a CUDA
device runs it (through a small entry point of the fused LayerNorm
library); ``keep_mask_reference`` is the plain version, bit-equal to the JAX
function.  PyTorch has almost no uint32 arithmetic, so the plain version
works in int64 and masks to 32 bits after every multiply, which also makes
the right shifts logical.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for 0 <= x, c < 2^32 held in int64, without ever
    exceeding 63 bits: the high half of x only matters through its low 16
    product bits."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _fmix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def threshold_of(dropout: float) -> int:
    """uint32 threshold: an element is kept when its hash is >= this."""
    return int(dropout * 4294967296.0)


def keep_from_index(counter, salt, seed, dropout: float) -> torch.Tensor:
    """Keep bits of elements given by their integer ``counter`` and ``salt``
    tensors (broadcast against each other); ``seed`` an int or an int tensor.
    Signed values wrap to uint32 as ``astype(uint32)`` does."""
    counter = torch.as_tensor(counter, dtype=torch.int64)
    dev = counter.device
    salt = torch.as_tensor(salt, dtype=torch.int64, device=dev) & _M32
    seed = torch.as_tensor(seed, dtype=torch.int64, device=dev).reshape(-1)[0] & _M32
    base = _fmix(_mul32(seed, 0x9E3779B9) ^ _fmix(_mul32(salt, 0xBF58476D)))
    x = _fmix(_mul32(counter & _M32, 0x9E3779B9) ^ base)
    return x >= threshold_of(dropout)


def keep_mask_reference(shape, dropout: float, seed, salt, device=None) -> torch.Tensor:
    """Plain version of ``keep_mask``: (rows, cols) bool, True = keep, with
    probability ``1 - dropout``; bit-equal to the JAX ``keep_mask``.  A
    ``salt`` tensor gives one mask block per salt: ``salt.shape + shape``."""
    rows, cols = shape
    r = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    salt = torch.as_tensor(salt, dtype=torch.int64, device=device)
    return keep_from_index(r * cols + c, salt[..., None, None], seed, dropout)


def keep_mask(shape, dropout: float, seed: int, salt: int, device=None) -> torch.Tensor:
    """One mask block for scalar ``seed`` and ``salt``.  On a CUDA device it
    runs the device function the kernels use (or raises); on the CPU the
    plain version."""
    device = torch.device(device or "cpu")
    if device.type == "cpu":
        return keep_mask_reference(shape, dropout, seed, salt)
    from transformertts_tpu_torch.ops.fused_ln import _lib

    rows, cols = shape
    out = torch.empty((rows, cols), dtype=torch.uint8, device=device)
    rc = _lib().tts_keep_mask(
        rows, cols, threshold_of(dropout), int(seed) & _M32, int(salt) & _M32,
        out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"keep_mask kernel failed to launch (CUDA error {rc}) for {shape}")
    keep_mask.launches += 1
    return out.bool()


keep_mask.launches = 0


def seed_from_generator(dropout: float, generator: torch.Generator | None) -> int:
    """The int32 seed of one kernel call: drawn from ``generator`` in
    [0, 2^31 - 1) when dropout is on, else 0.  ``generator`` should live on
    the CPU, so that drawing a seed costs no device readback."""
    if dropout > 0.0:
        if generator is None:
            raise ValueError("dropout > 0 requires a generator")
        return int(torch.randint(0, 2**31 - 1, (1,), generator=generator,
                                 device=generator.device))
    return 0

