"""Additive attention biases (0 = attend, NEG_INF = blocked).

The one ``NEG_INF`` of the package: every other module imports it from
here.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9  # large-but-finite: representable in bfloat16, avoids NaN rows


def lengths_to_valid_mask(lengths: torch.Tensor, max_len: int, start: int = 0) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) bool, True where position < length; the
    positions are ``start .. start + max_len - 1`` (a time slice)."""
    pos = torch.arange(start, start + max_len, device=lengths.device)[None, :]
    return pos < lengths[:, None]


def key_padding_bias(
    lengths: torch.Tensor, max_len: int, dtype=torch.float32
) -> torch.Tensor:
    """(B, max_len) additive key bias: 0 valid, NEG_INF padded."""
    valid = lengths_to_valid_mask(lengths, max_len)
    zero = torch.zeros((), dtype=dtype, device=lengths.device)
    return torch.where(valid, zero, torch.full_like(zero, NEG_INF))


def padding_bias(lengths: torch.Tensor, max_len: int, dtype=torch.float32) -> torch.Tensor:
    """(B, 1, 1, max_len) additive bias masking padded KEY positions."""
    return key_padding_bias(lengths, max_len, dtype)[:, None, None, :]


def causal_bias(t: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(1, 1, t, t) additive bias blocking attention to future positions."""
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=device))
    zero = torch.zeros((), dtype=dtype, device=device)
    return torch.where(mask, zero, torch.full_like(zero, NEG_INF))[None, None]
