"""Frozen copy of the plain arithmetic of the program's dropout-mask hash
and of the mask geometry its attention and LayerNorm kernels key on.

The keep bit of one element is

    base = fmix(seed * 0x9E3779B9 ^ fmix(salt * 0xBF58476D))
    keep = fmix(counter * 0x9E3779B9 ^ base) >= uint32(p * 2^32)

in wrapping uint32 arithmetic (held in int64), ``fmix`` the murmur3
32-bit finalizer.  Attention masks are keyed on (batch * heads + head,
q-block of ``pick_block`` rows, local row, key); residual LayerNorm masks
on (row block of ``pick_rows`` rows, local row, column).
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _fmix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keep_from_index(counter: torch.Tensor, salt: torch.Tensor, seed: int, rate: float
                    ) -> torch.Tensor:
    seed_t = torch.tensor(int(seed) & _M32, dtype=torch.int64, device=counter.device)
    base = _fmix(_mul32(seed_t, 0x9E3779B9) ^ _fmix(_mul32(salt & _M32, 0xBF58476D)))
    return _fmix(_mul32(counter & _M32, 0x9E3779B9) ^ base) >= int(rate * 4294967296.0)


def pick_block(t: int, tk: int) -> int:
    for cand in (1024, 768, 512, 384, 256, 128, 64, 32, 16, 8):
        if t % cand == 0 and cand * tk <= 620_000:
            return cand
    for cand in range(min(t, max(620_000 // max(tk, 1), 1)), 0, -1):
        if t % cand == 0:
            return cand
    return t


def pick_rows(n: int, d: int) -> int:
    budget_rows = (14 * 1024 * 1024) // (40 * d)
    for cand in (512, 256, 128, 64, 32, 16, 8):
        if cand <= budget_rows and n % cand == 0:
            return cand
    return n


def attention_keep(b: int, h: int, tq: int, tk: int, seed: int, rate: float, device
                   ) -> torch.Tensor:
    """(B, H, Tq, Tk) keep bits of one attention call."""
    block = pick_block(tq, tk)
    bh = (torch.arange(b, device=device)[:, None] * h
          + torch.arange(h, device=device)[None, :]).reshape(b, h, 1, 1)
    row = torch.arange(tq, dtype=torch.int64, device=device)[:, None]
    col = torch.arange(tk, dtype=torch.int64, device=device)[None, :]
    return keep_from_index((row % block) * tk + col, bh * 8192 + row // block, seed, rate)


def rows_keep(n: int, d: int, seed: int, rate: float, device) -> torch.Tensor:
    """(N, D) keep bits of one residual LayerNorm call over N rows."""
    block = pick_rows(n, d)
    rows = torch.arange(n, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(d, dtype=torch.int64, device=device)[None, :]
    return keep_from_index((rows % block) * d + cols, rows // block, seed, rate)
